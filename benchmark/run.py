#!/usr/bin/env python3
"""The benchmark of ``eks_tpu_torch``, the PyTorch and CUDA port: one run
of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. A cell of
``BENCHMARK.json`` names a configuration (``configs/``) and a traffic mix
(``traffic/``); its limits are in ``checks/<cell>.json``. The run loads
the program, makes its sessions from the seed, warms up, measures jobs in
a closed loop for ``--seconds``, judges the outputs against the plain
reference (``check.py``), and prints one JSON line last on standard
output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``metrics/``) and the device trace.
Facts about the host go to standard error first, and the numbers judged,
each beside its limit, last.

It exits non-zero with no result line when there is no card, or fewer than
the cell asks for, and when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, started: float, torch):
    """Everything after the look for a card: set-up, window, trace, check
    and the result line. Returns the result line's fields."""
    from check import judge, sample_lanes
    from harness import correlation, forbidden_modules, judged, p90, per_layer_metrics, spread
    from kinds import Context, load as load_kind

    ctx = Context(cell, seed, seconds, trace, device, started, torch)
    res = load_kind(cell.traffic["kind"]).run(ctx)
    win = res.window
    done = [j for j in win.jobs if not j.get("failed")]
    walls = [j["wall"] for j in done]
    print(f"window: {len(win.jobs)} jobs ({win.failed} failed) in {win.seconds!r} s; "
          f"set-up {res.setup_s!r} s; job walls (s) min, quartiles, max "
          f"{[round(x, 4) for x in spread(walls)]}", file=sys.stderr)
    if done:
        print(f"window: job process cpu over wall min, quartiles, max "
              f"{[round(x, 4) for x in spread([j['cpu'] / j['wall'] for j in done])]}; "
              f"largest collector pause in a job {max(j['gc_s'] for j in done):.4f} s", file=sys.stderr)
    iters = [(j["wall"], j["timings"]["adam_iters"]) for j in done if "adam_iters" in (j.get("timings") or {})]
    if len(iters) > 1:
        per = [w / n * 1e3 for w, n in iters if n]
        print(f"window: Adam iterations a job min, quartiles, max {spread([n for _, n in iters])}; "
              f"job wall per iteration (ms) {[round(x, 3) for x in spread(per)]}; "
              f"correlation of wall with iterations {correlation(*zip(*iters)):.3f}", file=sys.stderr)

    if device == "cuda":
        torch.cuda.empty_cache()
    tuned = cell.traffic["smooth_param"] is None
    numbers = {}
    if res.outputs:
        sample = sample_lanes(seed, len(res.outputs) * cell.cfg["keypoints"]) if tuned else None
        numbers = judge(cell.cfg, res.arrs, res.outputs, tuned, device, sample)
    missing = {k: float("inf") for k in cell.limits if k not in numbers}
    correct, checks = judged({**numbers, **missing}, cell.limits)
    correct = correct and win.failed == 0

    if trace:
        rec = {"jobs": done, "trace": res.segment, "cell": cell.sizes}
        metrics = per_layer_metrics(cell, rec)
    else:
        values = {"setup_s": (res.setup_s, "s")}
        if walls:
            values["kp_frames_per_s"] = (sum(j["kp_frames"] for j in done) / win.seconds, "kpframes/s")
            values["job_p90_s"] = (p90(walls), "s")
        metrics = {m["name"]: {"value": values[m["name"]][0], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(res.memory_peak_bytes)}
    breakdown = None
    if trace and res.segment:
        from devtrace import busy_s, idle_gaps, top_ops

        dev.update(busy_s=busy_s(res.segment["events"]), window_s=res.segment["window_s"])
        breakdown = {"device_ops": top_ops(res.segment["events"]), "idle_gaps": idle_gaps(res.segment)}

    found = forbidden_modules()
    if found:
        raise SystemExit(f"refused: the run loaded {found}")
    return correct, len(win.jobs), win.failed, metrics, dev, checks, breakdown


def main(argv=None) -> int:
    args = _args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from harness import load_cell, report
    from hostinfo import facts

    cell = load_cell(args.workload, ROOT)
    print(f"host: {json.dumps(facts())}", file=sys.stderr)
    t0 = time.perf_counter()
    import torch

    print(f"host: torch {torch.__version__} (CUDA {torch.version.cuda}) imported in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"refused: the cell needs {cell.chips} CUDA card(s), {n} visible", file=sys.stderr)
        return 2
    if not (ROOT / "eks_tpu_torch").is_dir():
        print(f"refused: no eks_tpu_torch package beside {BENCH}", file=sys.stderr)
        return 2
    report(*run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", _STARTED, torch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
