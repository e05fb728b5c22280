"""Kernel C of the PyTorch port on the card: one commit against another on
the same host, and the kernel's float32 error on long lanes.

    python3 scripts/torch_kernel_c_ab.py --roots OLD NEW NEW OLD [--out FILE]
    python3 scripts/torch_kernel_c_ab.py --precision [--out FILE]

``--roots`` runs, for each checkout named (its own ``eks_tpu_torch``, built
from its own sources), one child process that drives one synthetic IBL pupil
session of 10,000 frames (the recipe of chip_smoke.py's phase 8, seed 0)
through ``ensemble_kalman_smoother_ibl_pupil`` with s auto-tuned, and then
times kernel C paired on that session's two lanes at the optimizer's
starting parameters: host milliseconds to dispatch one call, CUDA events per
call over back-to-back calls, and device milliseconds per call under the
profiler. Naming the roots in the order old, new, new, old puts both on the
same host and cancels a drift of its speed. It prints one JSON line per
child, then the medians per root.

``--precision`` holds kernel C paired (this checkout's) and its plain
float32 version against the plain version in float64 on one lane of 100,000
steps and sixteen of 10,000, at the operands of the card tests'
``_nll_tv_operands``: random-walk observations and stationary AR(1) ones.
It prints each one's largest gap relative to 1 + |float64 value|, for ll and
for d ll/d log s.

Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
T_PUPIL, SEEDS_PUPIL = 10_000, 5


def make_pupil_session(np, rng):
    """chip_smoke.py's synthetic pupil session: a random-walk centre and
    diameter seen through the four pupil edge keypoints, plus per-seed
    jitter."""
    T, M = T_PUPIL, SEEDS_PUPIL
    com = rng.normal(size=(T, 2)).cumsum(axis=0) * 0.05 + 60
    diam = 20 + rng.normal(size=T).cumsum() * 0.01
    offs = {"pupil_top_r": (0, -0.5), "pupil_bottom_r": (0, 0.5),
            "pupil_right_r": (0.5, 0), "pupil_left_r": (-0.5, 0)}
    arr = np.zeros((M, 1, T, 4, 3), dtype=np.float32)
    for k, kp in enumerate(["pupil_top_r", "pupil_bottom_r", "pupil_right_r", "pupil_left_r"]):
        dx, dy = offs[kp]
        arr[:, 0, :, k, 0] = com[:, 0] + dx * diam + rng.normal(size=(M, T)) * 0.2
        arr[:, 0, :, k, 1] = com[:, 1] + dy * diam + rng.normal(size=(M, T)) * 0.2
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(M, 1, T, 4))
    return arr


def timed(torch, fn, reps):
    """(host ms to dispatch a call, CUDA-events ms per call) over ``reps``
    back-to-back calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    end.record()
    end.synchronize()
    return host, start.elapsed_time(end) / reps


def device_ms(torch, fn, reps):
    """Device ms per call of the port's own kernels under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "(anonymous namespace)::" in e.key)
    return total / 1e3 / reps


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import eks_tpu_torch
    from eks_tpu_torch.marker_array import MarkerArray
    from eks_tpu_torch.models import ibl_pupil
    from eks_tpu_torch.ops import cuda_build, fused_nll

    assert eks_tpu_torch.__file__.startswith(os.path.abspath(root)), eks_tpu_torch.__file__
    cuda_build.build()
    dev = torch.device("cuda:0")
    ma = MarkerArray(make_pupil_session(np, np.random.default_rng(0)), data_fields=["x", "y", "likelihood"])
    names = ibl_pupil.BODYPART_LIST
    # warm-up at the same shapes, then the session
    eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(ma, names, safety_cap=3, device="cuda")
    tm = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, s = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(ma, names, device="cuda", timings=tm)
    wall = time.perf_counter() - t0

    prep = ibl_pupil._pupil_prep(ma, names, "median", "confidence_weighted_var")
    y_p, r_p, m0_p, S0_p, C_p, dv, xv, yv = ibl_pupil._tensors(
        dev, prep[3][None], np.clip(prep[1], 1e-12, None)[None], prep[4][None], prep[5][None],
        ibl_pupil.PUPIL_C, [prep[8]], [prep[9]], [prep[10]])
    yr, tables, tangents = ibl_pupil._pupil_lanes(y_p, r_p, m0_p, S0_p, C_p, dv, xv, yv)
    U = ibl_pupil._rep2(ibl_pupil._initial_u(1, dev))
    tab, dtab = (x.contiguous() for x in torch.func.jvp(tables, (U,), (tangents,)))

    def call():
        return fused_nll.fused_nll_tv_paired(tab, dtab, yr)

    host_ms, events_ms = timed(torch, call, 300)
    iters = tm.get("adam_iters", 0)
    return {
        "root": root, "wall_s": wall, "optimizer_s": tm.get("optimizer"), "adam_iters": iters,
        "us_per_adam_iter": tm["optimizer"] / iters * 1e6 if iters else None, "s": [float(x) for x in s],
        "kernel_c_paired_enqueue_ms": host_ms, "kernel_c_paired_ms": events_ms,
        "kernel_c_paired_device_ms": device_ms(torch, call, 30),
    }


def precision() -> dict:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch

    import test_torch_cuda_kernels as ck
    from eks_tpu_torch.ops import fused_nll

    dev = torch.device("cuda:0")
    rows = []
    for N, T in ((1, 100_000), (16, 10_000)):
        for walk in (True, False):
            table, dtable, yr = ck._nll_tv_operands(dev, N, T, walk)
            ll_k, dll_k = fused_nll.fused_nll_tv_paired(table, dtable, yr)
            ll_p, dll_p = fused_nll._fused_nll_tv_paired_plain(table, dtable, yr)
            ll_64, dll_64 = fused_nll._fused_nll_tv_paired_plain(table.double(), dtable.double(), yr.double())

            def gap(a, ref):
                return float(((a.double() - ref).abs() / (1.0 + ref.abs())).max())

            rows.append({
                "N": N, "T": T, "observations": "random walk" if walk else "AR(1)",
                "ll_kernel_vs_f64": gap(ll_k, ll_64), "ll_plain_f32_vs_f64": gap(ll_p, ll_64),
                "dll_kernel_vs_f64": gap(dll_k, dll_64), "dll_plain_f32_vs_f64": gap(dll_p, dll_64),
                "dll_kernel_vs_plain_f32": gap(dll_k, dll_p.double()),
                "max_abs_ll_f64": float(ll_64.abs().max()), "max_abs_dll_f64": float(dll_64.abs().max()),
            })
    return {"precision": rows}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", help="checkouts to run, in this order, one child each")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--precision", action="store_true")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    lines = [json.dumps({"card": card()})]
    if args.precision:
        lines.append(json.dumps(precision()))
    if args.roots:
        runs = []
        for root in args.roots:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", os.path.abspath(root)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                return proc.returncode
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            lines.append(json.dumps(runs[-1]))
        keys = ("wall_s", "us_per_adam_iter", "kernel_c_paired_enqueue_ms", "kernel_c_paired_ms",
                "kernel_c_paired_device_ms")
        medians = {root: {k: statistics.median(r[k] for r in runs if r["root"] == os.path.abspath(root))
                          for k in keys} for root in dict.fromkeys(args.roots)}
        lines.append(json.dumps({"medians": medians}))
    lines.append(json.dumps({"card": card()}))
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
