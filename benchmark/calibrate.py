#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1-12 --control-seeds 101-103

For each seed of ``--seeds`` the program runs every session of the cell's
pool once, as the window's jobs do, and prints the numbers the check
compares, s on lanes drawn from the seed as in a run: sound readings,
whose largest is a limit's lower reading. For each seed of
``--control-seeds`` the control, the reference put in the program's place
and computed in TF32, takes the pool's first session, every keypoint's s
replayed: its smallest reading is a limit's upper reading. One JSON line a
seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def seed_list(text: str) -> list[int]:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def program_outputs(cell, seed: int, device: str) -> tuple[list, list]:
    from generators.sessions import session_pool

    import eks_tpu_torch as eks
    from families import load

    fam = load(cell.cfg["family"])
    pool = session_pool(seed, cell.cfg, cell.traffic["pool"])
    return pool, [fam.outputs(fam.call(eks, a, cell.cfg, cell.traffic["smooth_param"], device, None), cell.cfg)
                  for a in pool]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    from check import control_outputs, judge, sample_lanes
    from generators.sessions import session_pool
    from harness import load_cell
    from reference.precision import TF32

    cell = load_cell(args.workload)
    tuned = cell.traffic["smooth_param"] is None
    for seed in seed_list(args.seeds):
        t0 = time.perf_counter()
        arrs, outs = program_outputs(cell, seed, args.device)
        t1 = time.perf_counter()
        sample = sample_lanes(seed, len(arrs) * cell.cfg["keypoints"]) if tuned else None
        nums = judge(cell.cfg, arrs, outs, tuned, args.device, sample)
        _print(cell, "program", seed, nums, outs, t1 - t0, time.perf_counter() - t1)
    for seed in seed_list(args.control_seeds):
        # the control on the pool's first session, every keypoint's s replayed
        t0 = time.perf_counter()
        arrs = session_pool(seed, cell.cfg, 1)
        outs = control_outputs(cell.cfg, arrs, cell.traffic["smooth_param"], TF32, args.device)
        t1 = time.perf_counter()
        nums = judge(cell.cfg, arrs, outs, tuned, args.device)
        _print(cell, "control_tf32", seed, nums, outs, t1 - t0, time.perf_counter() - t1)


def _print(cell, side, seed, nums, outs, run_s, judge_s) -> None:
    print(json.dumps({"cell": cell.name, "side": side, "seed": seed, "numbers": nums,
                      "s_range": [min(float(o["s"].min()) for o in outs), max(float(o["s"].max()) for o in outs)],
                      "run_s": run_s, "judge_s": judge_s}), flush=True)


if __name__ == "__main__":
    main()
