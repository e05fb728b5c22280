#!/usr/bin/env python3
"""Multi-card walls of the port's sharded paths, and how the shards are driven.

    python3 scripts/torch_multicard.py

From the root of a checkout, on a host with at least two CUDA cards. Runs
``devices=min(4, count)`` on ``chip_smoke.py``'s phase 22 workloads, each
shard on a card of its own: the headline (10,000 frames x 20 keypoints x 5
seeds, auto-s) on the keypoint axis and on the time axis, the pupil solo
session on the time axis with its optimizer capped at 200 Adam iterations,
and the two-camera session and the calibrated rig on the keypoint axis
capped at 3 iterations with the stop rule off. Each run goes through two
ways of driving the shards, alternated as A B B A:

- ``in_turn``: ``ops.shards.map_shards``, every shard in turn on the
  calling thread, the cards overlapping through asynchronous launches;
- ``thread_per_card``: one host thread per card (defined here), the design
  ``map_shards`` replaced.

Prints one JSON line per run with its walls beside the one-device wall, its
gap to the one-device result, and whether the two ways gave the same bits;
then the card's name and power limit. Writes the lines to
``chiprun_out/multicard.json`` too. Exits non-zero on a host with fewer than
two cards or when the two ways disagree. About five minutes of command.
"""

import concurrent.futures
import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CAP_PUPIL = 200


def thread_per_card(torch):
    """A ``map_shards`` that runs each card's shards in a host thread of its
    own (shards of one card in turn in that thread)."""
    executors = {}

    def map_shards(fn, devices, *per_shard):
        devices = [torch.device(d) for d in devices]
        groups = {}
        for i, d in enumerate(devices):
            groups.setdefault(d, []).append(i)

        def run(idxs):
            dev = devices[idxs[0]]
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                return [fn(i, *(x[i] for x in per_shard)) for i in idxs]

        if len(groups) < 2:
            return run(list(range(len(devices))))
        futures = {}
        for d, idxs in groups.items():
            if d not in executors:
                executors[d] = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            futures[d] = executors[d].submit(run, idxs)
        out = [None] * len(devices)
        for d, idxs in groups.items():
            for i, r in zip(idxs, futures[d].result()):
                out[i] = r
        return out

    return map_shards, executors


def main() -> int:
    import numpy as np
    import torch

    import eks_tpu_torch
    from eks_tpu_torch.core import run_kalman_smoother
    from eks_tpu_torch.geometry import make_projection_from_camgroup, stack_camera_params
    from eks_tpu_torch.marker_array import MarkerArray
    from eks_tpu_torch.models import ibl_pupil, multicam
    from eks_tpu_torch.ops import shards

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print(f"torch_multicard: needs at least two CUDA cards, found {n_cards}", file=sys.stderr)
        return 2
    n = min(4, n_cards)
    dev = torch.device("cuda:0")
    card = chip_smoke.gpu_name_power()
    fields = ["x", "y", "likelihood"]

    head_ma = MarkerArray(chip_smoke.make_session(np, np.random.default_rng(0)), data_fields=fields)
    head_kps = [f"kp{i}" for i in range(chip_smoke.K_HEAD)]
    pupil_ma = MarkerArray(chip_smoke.make_pupil_session(np, np.random.default_rng(0)), data_fields=fields)
    mc_t = torch.as_tensor(chip_smoke.make_multicam_session(np, np.random.default_rng(0), chip_smoke.CAMS_MC),
                           device=dev)
    _, ys2, ev2, m02, S02, A2, Q2, C2, _ = multicam._prep_multicam_linear(
        mc_t[..., 0], mc_t[..., 1], mc_t[..., 2], chip_smoke.SEEDS_MC, "median", "confidence_weighted_var", 3, 50.0)
    cal_group, cal_arr = chip_smoke.calibrated_rig(np, np.random.default_rng(0))
    cal_t = torch.as_tensor(cal_arr, device=dev)
    cal_params = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in stack_camera_params(cal_group)]
    _, ys3, ev3, m03, S03, A3, Q3, x3 = multicam._prep_multicam_nonlinear(
        cal_t[..., 0], cal_t[..., 1], cal_t[..., 2], chip_smoke.SEEDS_CAL, "median", "confidence_weighted_var",
        *cal_params)
    h_card = make_projection_from_camgroup(cal_group, device=dev)[0]
    cap = chip_smoke.CAP_CAL

    def np_of(out):
        """The run's result as host arrays: s and the table, or s and the
        smoothed moments."""
        if isinstance(out[0], np.ndarray):  # run_kalman_smoother: (s, ms, Vs)
            return [np.asarray(out[0])] + [x.cpu().numpy() for x in out[1:]]
        return [np.asarray(out[1], dtype=np.float64), out[0].to_numpy()]

    runs = {
        "headline_keypoint": lambda d: eks_tpu_torch.ensemble_kalman_smoother_singlecam(
            head_ma, head_kps, device="cuda", devices=d),
        "headline_time": lambda d: eks_tpu_torch.ensemble_kalman_smoother_singlecam(
            head_ma, head_kps, device="cuda", devices=d, partition="time"),
        "pupil_time": lambda d: eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
            pupil_ma, ibl_pupil.BODYPART_LIST, safety_cap=CAP_PUPIL, device="cuda", devices=d),
        "two_cameras_keypoint": lambda d: run_kalman_smoother(
            ys2, m02, S02, A2, C2, Q2, ev2.transpose(0, 1), safety_cap=cap, tol=-1.0, devices=d),
        "calibrated_keypoint": lambda d: run_kalman_smoother(
            ys3, m03, S03, A3, A3, Q3, ev3.transpose(0, 1), safety_cap=cap, tol=-1.0, devices=d, h_fn=h_card,
            x_init=x3),
    }

    def timed(fn, d):
        for i in range(n_cards):
            torch.cuda.synchronize(i)
        t0 = time.perf_counter()
        out = fn(d)
        for i in range(n_cards):
            torch.cuda.synchronize(i)
        return np_of(out), time.perf_counter() - t0

    one = {name: timed(fn, None) for name, fn in runs.items()}
    in_turn = shards.map_shards
    threaded, executors = thread_per_card(torch)
    ways = {"in_turn": in_turn, "thread_per_card": threaded}
    walls = {name: {w: [] for w in ways} for name in runs}
    results = {name: {} for name in runs}
    try:
        for way in ("in_turn", "thread_per_card", "thread_per_card", "in_turn"):
            shards.map_shards = ways[way]
            for name, fn in runs.items():
                got, wall = timed(fn, n)
                walls[name][way].append(wall)
                results[name].setdefault(way, got)
    finally:
        shards.map_shards = in_turn
        for ex in executors.values():
            ex.shutdown()

    lines, ok = [], True
    for name in runs:
        a, b = results[name]["in_turn"], results[name]["thread_per_card"]
        same = all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))
        s1 = one[name][0][0]
        line = {
            "run": name, "devices": n, "meshes": [f"cuda:{i}" for i in range(n)],
            "one_device_wall_s": one[name][1],
            "wall_s": walls[name], "same_bits_both_ways": same,
            "s_rel_gap_vs_one_device": float(np.max(np.abs(a[0] / s1 - 1.0))),
            "result_max_abs_gap_vs_one_device": max(float(np.max(np.abs(x - y))) for x, y in
                                                    zip(a[1:], one[name][0][1:])),
            "finite": all(bool(np.isfinite(x).all()) for x in a), "card": card,
        }
        ok = ok and same and line["finite"]
        lines.append(line)
        print(json.dumps(line), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "multicard.json"), "w") as f:
        json.dump(lines, f, indent=1)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
