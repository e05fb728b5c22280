"""Kernel A of the PyTorch port on the card: one commit against another on
the same host.

    python3 scripts/torch_kernel_a_ab.py --roots OLD NEW NEW OLD [--out FILE]

For each checkout named (its own ``eks_tpu_torch``, built from its own
sources) one child process drives two sessions with s auto-tuned, made in
memory from seed 0 with the recipes of chip_smoke.py: the headline singlecam
session (10,000 frames x 20 keypoints x 5 seeds, through
``ensemble_kalman_smoother_singlecam``; kernel A at (D, O) = (2, 2), 20
lanes) and the two-camera session (10,000 frames x 10 keypoints x 5 seeds,
through ``ensemble_kalman_smoother_multicam``; kernel A at (3, 4), 10
lanes), each after a warm-up run. Then it times kernel A paired at those two
shapes on random-walk lanes (chip_smoke.py's ``lane_problem``, seed 0): host
milliseconds to dispatch one call, CUDA events per call over back-to-back
calls, and device milliseconds per call under the profiler. Naming the roots
in the order old, new, new, old (repeated for more pairs) puts both on the
same host and cancels a drift of its speed. It prints one JSON line per
child, then per root and metric the quartiles [lower, median, upper] over
its children.

Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from torch_kernel_c_ab import card, device_ms, timed  # noqa: E402

T, K_HEAD, K_MC, SEEDS = 10_000, 20, 10, 5


def make_session(np, rng):
    """chip_smoke.py's headline session: random-walk keypoints + per-seed
    jitter."""
    truth = rng.normal(size=(1, 1, T, K_HEAD, 2)).cumsum(axis=2).astype(np.float32)
    arr = np.zeros((SEEDS, 1, T, K_HEAD, 3), dtype=np.float32)
    arr[..., :2] = truth + rng.normal(size=(SEEDS, 1, T, K_HEAD, 2)).astype(np.float32) * 0.5
    arr[..., 2] = rng.uniform(0.7, 1.0, size=(SEEDS, 1, T, K_HEAD)).astype(np.float32)
    return arr


def make_multicam_session(np, rng, cams=2):
    """chip_smoke.py's multi-camera session: a random walk per camera and
    coordinate, plus per-seed jitter."""
    base = rng.normal(size=(1, cams, T, K_MC, 2)).cumsum(axis=2) * 0.3 + 50
    arr = np.zeros((SEEDS, cams, T, K_MC, 3), dtype=np.float32)
    arr[..., :2] = base + rng.normal(size=(SEEDS, cams, T, K_MC, 2)) * 0.3
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(SEEDS, cams, T, K_MC))
    return arr


def lane_operands(np, torch, N, O, D, dev):
    """Kernel A's (table, its tangent in log s, y planes) on chip_smoke.py's
    random-walk lanes, at s = 0.8."""
    rng = np.random.default_rng(0)
    ys = (rng.normal(size=(N, T, O)).cumsum(axis=1) * 0.1).astype(np.float32)
    m0 = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    eye = np.tile(np.eye(D, dtype=np.float32), (N, 1, 1))
    C = (np.tile(np.eye(O, D), (N, 1, 1)) + 0.05 * rng.normal(size=(N, O, D))).astype(np.float32)
    r = (np.abs(rng.normal(size=(N, O))) * 0.5 + 0.2).astype(np.float32)
    ys, m0, S0, A, Q, C, r = (torch.as_tensor(x, device=dev) for x in (ys, m0, 1.3 * eye, eye, 0.7 * eye, C, r))
    from eks_tpu_torch.ops import pkalman

    def pack(sl):
        return pkalman._pack_scalars(ys[:, 0], m0, S0, A, torch.exp(sl)[:, None, None] * Q, C, r)

    sl = torch.full((N,), math.log(0.8), device=dev)
    table, dtable = torch.func.jvp(pack, (sl,), (torch.ones_like(sl),))
    return table.contiguous(), dtable.contiguous(), ys.transpose(1, 2).contiguous()


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import eks_tpu_torch
    from eks_tpu_torch.marker_array import MarkerArray
    from eks_tpu_torch.ops import cuda_build, fused_nll

    assert eks_tpu_torch.__file__.startswith(os.path.abspath(root)), eks_tpu_torch.__file__
    cuda_build.build()
    dev = torch.device("cuda:0")
    fields = ["x", "y", "likelihood"]
    out = {"root": root}

    def session(name, run):
        run({})  # warm-up at the same shapes
        tm = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = run(tm)
        iters = tm.get("adam_iters", 0)
        out[name] = {"wall_s": time.perf_counter() - t0, "optimizer_s": tm.get("optimizer"), "adam_iters": iters,
                     "us_per_adam_iter": tm["optimizer"] / iters * 1e6 if iters else None,
                     "s_median": float(np.median(s))}

    ma = MarkerArray(make_session(np, np.random.default_rng(0)), data_fields=fields)
    kps = [f"kp{i}" for i in range(K_HEAD)]
    session("headline", lambda tm: eks_tpu_torch.ensemble_kalman_smoother_singlecam(
        ma, kps, device="cuda", timings=tm)[1])
    mc = MarkerArray(make_multicam_session(np, np.random.default_rng(0)), data_fields=fields)
    mc_kps = [f"kp{i}" for i in range(K_MC)]
    session("two_cameras", lambda tm: eks_tpu_torch.ensemble_kalman_smoother_multicam(
        mc, mc_kps, ["cam0", "cam1"], n_latent=3, device="cuda", timings=tm)[1])

    for name, (N, O, D) in (("a_paired_d2_o2", (K_HEAD, 2, 2)), ("a_paired_d3_o4", (K_MC, 4, 3))):
        table, dtable, y = lane_operands(np, torch, N, O, D, dev)

        def call():
            return fused_nll.fused_nll_paired(table, dtable, y)

        host_ms, events_ms = timed(torch, call, 300)
        out[name] = {"enqueue_ms": host_ms, "ms": events_ms, "device_ms": device_ms(torch, call, 30)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=False, help="checkouts to run, in this order, one child each")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    out = open(args.out, "w") if args.out else None

    def put(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    put({"card": card()})
    runs = []
    for root in args.roots or []:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", os.path.abspath(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        put(runs[-1])
    fields = [("headline", "wall_s"), ("headline", "us_per_adam_iter"), ("two_cameras", "wall_s"),
              ("two_cameras", "us_per_adam_iter")] + [
        (k, m) for k in ("a_paired_d2_o2", "a_paired_d3_o4") for m in ("enqueue_ms", "ms", "device_ms")]

    def quartiles(xs):
        return statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else xs * 3

    summary = {root: {f"{a}.{b}": quartiles([r[a][b] for r in runs if r["root"] == os.path.abspath(root)])
                      for a, b in fields} for root in dict.fromkeys(args.roots or [])}
    put({"quartiles": summary})
    put({"card": card()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
