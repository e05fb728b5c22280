#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (eks_tpu_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and ``nvcc``:

  1. prints the card's name and power limit and builds the CUDA kernels
     from ``eks_tpu_torch/csrc`` (one nvcc per source, in parallel);
  2. holds kernel A (the fused NLL, plain and paired) against its plain
     PyTorch version at the headline shapes, and times both;
  3. holds kernel B (the filter prefix scan) against its plain version on
     the final pass's time-varying-R elements, and times both;
  4. runs ``fit_eks_singlecam`` on the bundled ``data/singlecam`` session
     with s = 2.0 and compares it with the committed golden at atol 1e-4;
  5. runs ``ensemble_kalman_smoother_singlecam`` with auto-tuned s on the
     headline session (10,000 frames x 20 keypoints x 5 seeds, seed 0),
     counting the kernels' launches, and checks its final pass against the
     float64 sequential smoother.

Each phase prints one JSON line; any failure raises, so the exit code is not
0. The last lines are the main path's launch counts, the card's name and
power limit, the per-kernel JSON line, and ``{"ok": true, "device": {...}}``. Without a CUDA card, or outside
a checkout of the repository, it exits with a nonzero code before printing
any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# headline workload (the JAX package's bench.py: T, K, SEEDS and make_session)
T_HEAD, K_HEAD, SEEDS_HEAD = 10_000, 20, 5

# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel A and B tolerances, per lane (A) and per entry (B), relative to
# 1 + the plain value's magnitude: the kernels and their plain versions
# combine the same elements in another association order (256 sequential
# chunks and a Hillis-Steele sweep against a log-depth tree), and the kernels
# contract multiply-adds, so float32 results differ by rounding. On an H100
# the largest gaps at the headline shapes were 2.4e-7 (A's d ll/d log s) and
# 3.4e-7 (B); the limits sit four and nine times above them, and well under
# one step's share: a lane's ll is a sum of 10,000 innovation log-densities
# of about -2 each, so dropping or doubling one step moves it by ~1e-4
# relative, and one wrong element moves the filtered means after it by ~1e-2
RTOL_NLL = 1e-6
RTOL_SCAN = 3e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# operations the kernels' functions need (for their bound), counted from the
# math, not from the kernels, which do more (the chunked scans' extra folds
# and block sweeps). A Dual (value, tangent) multiply is 4 float operations,
# an add 2, a divide 4, a sqrt 3 and a log 2.
# --------------------------------------------------------------------------- #
def _ops(mul, add, div, sqrt=0, log=0, dual=False):
    if dual:
        return 4 * mul + 2 * add + 4 * div + 3 * sqrt + 2 * log
    return mul + add + div + sqrt + log


def kf_step_ops(D, O, dual):
    """One step of a Kalman filter's log-likelihood with diagonal R: predict,
    the innovation and its O x O Cholesky and log-density, the update."""
    tri = O * (O - 1) // 2
    chol = sum(i * (i + 1) // 2 for i in range(O))  # multiply-adds of the factor
    mul = (D * D + 2 * D ** 3              # A m, A P Aᵀ
           + O * D * D + O * O * D + O * D  # C P, (C P) Cᵀ, C m
           + chol + tri + O + 1             # Cholesky, z, z·z, -0.5 quad
           + D * 2 * tri                    # gain K = (C P)ᵀ S⁻¹, D solves
           + D * O + D * D * O)             # m + K d, P - K (C P)
    add = (D * (D - 1) + 2 * D * D * (D - 1) + D * D
           + O * D * (D - 1) + O * O * (D - 1) + O + O * D
           + chol + tri + (O - 1) + (O - 1) + 3
           + D * 2 * tri
           + D * O + D * D * (O - 1) + D * D)
    div = tri + O + D * 2 * O
    return _ops(mul, add, div, sqrt=O, log=O, dual=dual)


def combine_ops():
    """One filtering-element combine at D = 2: eight 2x2 products, four
    matvecs, the 2x2 inverse and the sums."""
    return _ops(mul=8 * 8 + 4 * 4 + 6, add=8 * 4 + 4 * 2 + 2 + 1 + 8 + 8, div=1)


def nll_ops(N, T, D, O, dual):
    return N * T * kf_step_ops(D, O, dual)


def scan_ops(N, T):
    return N * (T - 1) * combine_ops()


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_cuda(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_summary(report: str) -> list:
    """The kernels' register and spill lines from nvcc's -Xptxas -v output."""
    keep = []
    for line in report.splitlines():
        if "Used" in line and "registers" in line or "spill" in line:
            keep.append(line.strip().replace("ptxas info    : ", ""))
    return keep


# --------------------------------------------------------------------------- #
# operands
# --------------------------------------------------------------------------- #
def lane_problem(np, rng, N, T, O, D):
    """Random-walk observations and per-lane state-space parameters."""
    ys = (rng.normal(size=(N, T, O)).cumsum(axis=1) * 0.1).astype(np.float32)
    m0 = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    S0 = np.tile(np.eye(D, dtype=np.float32) * 1.3, (N, 1, 1))
    A = np.tile(np.eye(D, dtype=np.float32), (N, 1, 1))
    Q = np.tile(np.eye(D, dtype=np.float32) * 0.7, (N, 1, 1))
    C = (np.tile(np.eye(O, D), (N, 1, 1)) + 0.05 * rng.normal(size=(N, O, D))).astype(np.float32)
    r = (np.abs(rng.normal(size=(N, O))) * 0.5 + 0.2).astype(np.float32)
    r_tv = (np.abs(rng.normal(size=(N, T, O))) * 0.5 + 0.2).astype(np.float32)
    return ys, m0, S0, A, Q, C, r, r_tv


def make_session(np, rng):
    """Synthetic ensemble session: random-walk keypoints + per-seed jitter."""
    T, K, SEEDS = T_HEAD, K_HEAD, SEEDS_HEAD
    truth = rng.normal(size=(1, 1, T, K, 2)).cumsum(axis=2).astype(np.float32)
    arr = np.zeros((SEEDS, 1, T, K, 3), dtype=np.float32)
    arr[..., :2] = truth + rng.normal(size=(SEEDS, 1, T, K, 2)).astype(np.float32) * 0.5
    arr[..., 2] = rng.uniform(0.7, 1.0, size=(SEEDS, 1, T, K)).astype(np.float32)
    return arr


def rel_err(a, b) -> tuple:
    """(max |a - b|, max |a - b| / (1 + |b|)), both entry by entry: per lane
    for kernel A's (N,) outputs, per plane and step for kernel B's."""
    diff = (a - b).abs()
    return float(diff.max()), float((diff / (1.0 + b.abs())).max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import numpy as np
        import pandas as pd

        import eks_tpu_torch
        from eks_tpu_torch.marker_array import MarkerArray
        from eks_tpu_torch.ops import cuda_build, fused_filter, fused_nll, pkalman
        from eks_tpu_torch.ops.kalman import kalman_smoother
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = gpu_name_power()

    # ---------------------------------------------------------------- 1 ---
    print(card, flush=True)
    t0 = time.perf_counter()
    report = cuda_build.build()
    for name in cuda_build.KERNEL_SOURCES:
        cuda_build.load(name)
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "per_source_s": {k: v[0] for k, v in report.items()},
        "ptxas": {k: ptxas_summary(v[1]) for k, v in report.items()},
    })

    rng = np.random.default_rng(0)

    # ---------------------------------------------------------------- 2 ---
    N, T, O, D = K_HEAD, T_HEAD, 2, 2
    ys, m0, S0, A, Q, C, r, r_tv = lane_problem(np, rng, N, T, O, D)
    ys_t, m0_t, S0_t, A_t, Q_t, C_t, r_t, rtv_t = (
        torch.as_tensor(x, device=dev) for x in (ys, m0, S0, A, Q, C, r, r_tv)
    )
    s_log = torch.full((N,), math.log(0.8), device=dev)

    def pack(sl):
        sQ = torch.exp(sl)[:, None, None] * Q_t
        return pkalman._pack_scalars(ys_t[:, 0], m0_t, S0_t, A_t, sQ, C_t, r_t)

    table, dtable = torch.func.jvp(pack, (s_log,), (torch.ones_like(s_log),))
    table, dtable = table.contiguous(), dtable.contiguous()
    y_pl = ys_t.transpose(1, 2).contiguous()

    ll_k = fused_nll.fused_nll(table, y_pl)
    ll_p = fused_nll._fused_nll_plain(table, y_pl)
    (pll_k, dll_k) = fused_nll.fused_nll_paired(table, dtable, y_pl)
    (pll_p, dll_p) = fused_nll._fused_nll_paired_plain(table, dtable, y_pl)
    torch.cuda.synchronize()
    e_ll, r_ll = rel_err(ll_k, ll_p)
    e_pll, r_pll = rel_err(pll_k, pll_p)
    e_dll, r_dll = rel_err(dll_k, dll_p)
    ok_a = max(r_ll, r_pll, r_dll) <= RTOL_NLL and bool(torch.isfinite(dll_k).all())
    # the optimizer's per-iteration plain PyTorch work beside the kernel:
    # the scalar table and its tangent d(table)/d(log s)
    ms_pack = time_cuda(torch, lambda: torch.func.jvp(pack, (s_log,), (torch.ones_like(s_log),)), 20)
    ms_a = time_cuda(torch, lambda: fused_nll.fused_nll(table, y_pl), 50)
    ms_ap = time_cuda(torch, lambda: fused_nll.fused_nll_paired(table, dtable, y_pl), 50)
    ms_a_plain = time_cuda(torch, lambda: fused_nll._fused_nll_plain(table, y_pl), 3)
    ms_ap_plain = time_cuda(torch, lambda: fused_nll._fused_nll_paired_plain(table, dtable, y_pl), 3)
    in_bytes = (N * O * T + N * table.shape[1]) * 4
    b_a = bound_ms(in_bytes + N * 4, nll_ops(N, T, D, O, False))
    b_ap = bound_ms(in_bytes + N * table.shape[1] * 4 + 2 * N * 4, nll_ops(N, T, D, O, True))
    emit({
        "phase": "kernel_A", "N": N, "T": T, "D": D, "O": O, "rtol": RTOL_NLL,
        "ll_max_abs_err": e_ll, "ll_rel_err": r_ll,
        "paired_ll_max_abs_err": e_pll, "paired_ll_rel_err": r_pll, "paired_dll_max_abs_err": e_dll,
        "paired_dll_rel_err": r_dll, "ms": ms_a, "plain_ms": ms_a_plain,
        "paired_ms": ms_ap, "paired_plain_ms": ms_ap_plain, "pack_jvp_ms": ms_pack,
        "bound_ms": b_a[0], "bound_by": b_a[1], "paired_bound_ms": b_ap[0],
        "paired_bound_by": b_ap[1], "ok": ok_a,
        "launches": {"fused_nll": fused_nll.LAUNCHES, "fused_nll_paired": fused_nll.PAIRED_LAUNCHES},
    })
    if not ok_a:
        raise AssertionError("kernel A disagrees with its plain version")

    # ---------------------------------------------------------------- 3 ---
    planes = pkalman._make_filter_elements(ys_t, m0_t, S0_t, A_t, Q_t, C_t, rtv_t)
    out_k = fused_filter.filter_prefix(planes)
    out_p = fused_filter.filter_prefix_plain(planes)
    torch.cuda.synchronize()
    e_b, r_b = rel_err(out_k, out_p)
    ok_b = r_b <= RTOL_SCAN and bool(torch.isfinite(out_k).all())
    ms_b = time_cuda(torch, lambda: fused_filter.filter_prefix(planes), 50)
    ms_b_plain = time_cuda(torch, lambda: fused_filter.filter_prefix_plain(planes), 3)
    b_b = bound_ms(2 * planes.numel() * 4, scan_ops(N, T))
    emit({
        "phase": "kernel_B", "N": N, "P": planes.shape[1], "T": T, "rtol": RTOL_SCAN,
        "max_abs_err": e_b, "rel_err": r_b, "ms": ms_b, "plain_ms": ms_b_plain,
        "bound_ms": b_b[0], "ok": ok_b, "launches": {"prefix_scan_filter": fused_filter.LAUNCHES},
    })
    if not ok_b:
        raise AssertionError("kernel B disagrees with its plain version")

    # ---------------------------------------------------------------- 4 ---
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        df, _, _, _ = eks_tpu_torch.fit_eks_singlecam(
            os.path.join(REPO, "data", "singlecam"), os.path.join(tmp, "out.csv"),
            smooth_param=2.0, device="cuda",
        )
        wall = time.perf_counter() - t0
    ref = pd.read_csv(
        os.path.join(REPO, "tests", "integration", "golden", "singlecam_fixed.csv"),
        header=[0, 1, 2], index_col=0,
    )
    same_cols = [tuple(map(str, c)) for c in df.columns] == [tuple(map(str, c)) for c in ref.columns]
    gap = float(np.abs(df.to_numpy() - ref.to_numpy()).max()) if df.shape == ref.shape else math.inf
    emit({"phase": "golden_singlecam_fixed", "shape": list(df.shape), "max_abs_err": gap,
          "atol": 1e-4, "columns_match": same_cols, "wall_s": wall})
    if not (same_cols and gap <= 1e-4):
        raise AssertionError("singlecam_fixed golden mismatch")

    # ---------------------------------------------------------------- 5 ---
    arr = make_session(np, np.random.default_rng(0))
    ma = MarkerArray(arr, data_fields=["x", "y", "likelihood"])
    kps = [f"kp{i}" for i in range(K_HEAD)]
    # warm-up at the same shapes (context, allocator, library handles)
    eks_tpu_torch.ensemble_kalman_smoother_singlecam(ma, kps, device="cuda")
    fused_nll.LAUNCHES = fused_nll.PAIRED_LAUNCHES = fused_filter.LAUNCHES = 0
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df, s_finals = eks_tpu_torch.ensemble_kalman_smoother_singlecam(
        ma, kps, device="cuda", timings=timings
    )
    wall = time.perf_counter() - t0
    launches = {
        "fused_nll": fused_nll.LAUNCHES,
        "fused_nll_paired": fused_nll.PAIRED_LAUNCHES,
        "prefix_scan_filter": fused_filter.LAUNCHES,
    }
    table_np = df.to_numpy()
    finite = bool(np.isfinite(table_np).all()) and bool(np.isfinite(s_finals).all())
    iters = timings.get("adam_iters", 0)

    # the final pass against the float64 sequential smoother at these s
    from eks_tpu_torch.models.singlecam import _prep_singlecam

    raw = torch.as_tensor(arr[:, 0], device=dev)
    stats, ys_s, means, S0s = _prep_singlecam(raw[..., 0], raw[..., 1], raw[..., 2], SEEDS_HEAD,
                                              "median", "confidence_weighted_var")
    d64 = dict(dtype=torch.float64, device="cpu")
    eye = torch.eye(2, **d64).expand(K_HEAD, 2, 2)
    s64 = torch.as_tensor(s_finals, **d64)
    rs = torch.clamp(stats[..., 2:4].transpose(0, 1).to(**d64), min=1e-12)
    ref = kalman_smoother(ys_s.to(**d64), torch.zeros(K_HEAD, 2, **d64), S0s.to(**d64), eye,
                          s64[:, None, None] * eye, eye, rs)
    x_ref = (ref.smoothed_means.transpose(0, 1) + means.to(**d64)[None]).numpy()  # (T, K, 2)
    x_got = table_np.reshape(T_HEAD, K_HEAD, 9)[..., :2]
    seq_gap = float(np.abs(x_got - x_ref).max())
    emit({
        "phase": "headline_auto_s", "frames": T_HEAD, "keypoints": K_HEAD, "seeds": SEEDS_HEAD,
        "wall_s": wall, "prep_s": timings.get("prep"), "optimizer_s": timings.get("optimizer"),
        "final_pass_s": timings.get("final_pass"), "package_s": timings.get("package"),
        "adam_iters": iters,
        "us_per_adam_iter": timings["optimizer"] / iters * 1e6 if iters else None,
        "s_min": float(np.min(s_finals)), "s_median": float(np.median(s_finals)),
        "s_max": float(np.max(s_finals)), "finite": finite, "shape": list(df.shape),
        "launches": launches, "max_abs_err_vs_f64_sequential": seq_gap, "card": card,
    })
    if not finite or df.shape != (T_HEAD, K_HEAD * 9):
        raise AssertionError("headline output is not finite or has the wrong shape")
    if launches["fused_nll_paired"] <= 0 or launches["prefix_scan_filter"] <= 0:
        raise AssertionError(f"the main path did not run through both kernels: {launches}")
    if seq_gap > 1e-2:
        raise AssertionError(f"final pass is {seq_gap} from the float64 sequential smoother")

    # --------------------------------------------------------------- 5b ---
    # where the headline run's time goes: the same run once more under the
    # profiler (device activity only), for the device's busy time and what
    # runs on it. The profiler slows the host, so the idle share is taken
    # against the unprofiled wall of phase 5, on the same inputs.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eks_tpu_torch.ensemble_kalman_smoother_singlecam(ma, kps, device="cuda")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    n_device_ops = sum(e.count for e in on_device)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]
    emit({
        "phase": "headline_profile", "profiled_wall_s": prof_wall, "unprofiled_wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if busy_us else None,
        "device_ops": n_device_ops, "device_ops_per_adam_iter": n_device_ops / iters if iters else None,
        "top": [{"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3} for e in top],
    })

    # ---------------------------------------------------------------- 6 ---
    # the main path runs kernel A in its paired form only (the optimizer's
    # forward-mode gradient); the plain form's numbers are in phase 2's line
    src = "eks_tpu_torch/csrc/"
    kernels = [{
        "name": "fused_nll_paired", "route": "cuda", "source": src + "fused_nll.cu",
        "replaces": "eks_tpu/ops/pallas_nll.py:171",
        "launches": launches["fused_nll_paired"], "max_abs_err": max(e_pll, e_dll),
        "ms": ms_ap, "plain_ms": ms_ap_plain, "bound_ms": b_ap[0], "bound_by": b_ap[1],
        "library_ms": None,
    }, {
        "name": "prefix_scan_filter", "route": "cuda", "source": src + "prefix_scan.cu",
        "replaces": "eks_tpu/ops/pallas_filter.py:187",
        "launches": launches["prefix_scan_filter"], "max_abs_err": e_b,
        "ms": ms_b, "plain_ms": ms_b_plain, "bound_ms": b_b[0], "bound_by": b_b[1],
        "library_ms": None,
    }]
    emit({"launches": launches})
    print(gpu_name_power(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
