#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (eks_tpu_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and ``nvcc``:

  1. prints the card's name and power limit and builds the CUDA kernels
     from ``eks_tpu_torch/csrc`` (one nvcc per source, in parallel);
  2. holds kernel A (the fused constant-R NLL, plain and paired) against its
     plain PyTorch version at the headline shapes, and times both, printing
     its segments per lane G, threads per block, whether two launches gave
     the same bits, and the ptxas lines of its instance;
  3. holds kernel B (the filter prefix scan) against its plain version on
     the final pass's time-varying-R elements, at D = 2 (singlecam: 20
     lanes) and at D = 3 (pupil: 1 and 8 lanes), and times both; the
     smoother instance too, on the same pupil final pass's elements;
  4. runs ``fit_eks_singlecam`` on the bundled ``data/singlecam`` session
     with s = 2.0 and compares it with the committed golden at atol 1e-4;
  5. runs ``ensemble_kalman_smoother_singlecam`` with auto-tuned s on the
     headline session (10,000 frames x 20 keypoints x 5 seeds, seed 0),
     counting the kernels' launches, checks its final pass against the
     float64 sequential smoother, and profiles a repeat of it;
  6. holds kernel C (the fused time-varying-R NLL, plain and paired) against
     its plain version on the pupil optimizer's own operands: one session
     (2 lanes) and eight (16 lanes), 10,000 frames, D = 3, O = 8, and once
     more with noise variances clipped to 1e-12, printing each shape's
     segments per lane G, threads per block, and whether two launches gave
     the same bits;
  7. runs ``fit_eks_pupil`` on the bundled ``data/pupil`` session with
     fixed parameters and compares it with the committed golden at 1e-4,
     then with tuned parameters against the committed golden at 1e-2;
  8. runs ``ensemble_kalman_smoother_ibl_pupil`` with auto-tuned parameters
     on a 10,000-frame x 5-seed pupil session (seed 0), counting launches,
     checks its final pass against the float64 sequential smoother, and
     profiles a repeat capped at 200 Adam iterations;
  9. runs ``ensemble_kalman_smoother_ibl_pupil_sessions`` on eight such
     sessions and holds their parameters against solo runs;
 11. holds the other instances of the scan kernel against their plain
     versions: the smoother algebra (the backward RTS pass) at D = 2 (20
     lanes) and D = 3 (10 lanes: the two- and the six-camera final pass's
     elements), the float filter scan at D = 3 on those two final passes'
     elements, and the paired lane-batched filter scan at D = 3 (10 lanes,
     the six-camera optimizer's), at 10,000 steps, timing the smoother
     kernel against the plain reverse scan on the same operands; and the
     paired instances no path runs (the filter at D = 2, the smoother at
     D = 2 and 3) at the headline, two-camera and pupil final passes' shapes.
     Every scan instance it holds (here and in phases 3 and 3b) prints its
     G, threads per block, and whether two launches gave the same bits;
 12. holds kernel A at (D, O) = (3, 4), plain and paired, against its plain
     version on the two-camera optimizer's operands, with the same prints
     as phase 2;
 16. holds kernel A at each of its other ten instances, plain and paired,
     against its plain version: on the first-iteration operands of the
     linear multi-camera optimizer with one to four cameras at n_latent = D
     (10,000 frames x 10 keypoints), and at (3, 2), which no entry point
     reaches (n_latent is at most twice the cameras), on random-walk lanes;
     and the scan's D = 1 instances (filter and smoother, float and paired)
     on the one-latent two-camera final pass's elements;
 13. runs the mirrored family (fixed s; auto s with variance inflation) and
     the paw family through the bundled files against the committed goldens;
 14. runs ``ensemble_kalman_smoother_multicam`` with auto-tuned s on a
     two-camera session (10,000 frames x 10 keypoints x 2 cameras x 5 seeds,
     seed 0), counting launches, checks its final pass against the float64
     sequential smoother (``seq_smoother_f64``: each step's solves batched
     over the lanes through LAPACK, seconds where the port's unrolled
     sequential smoother takes minutes at 12 observations), and profiles a
     repeat of it;
 15. runs the same recipe at six cameras (12 observations), where the
     optimizer's loss is the staged plane NLL over the paired lane-batched
     scan, checks its final pass against the float64 sequential smoother,
     holds its s against a CPU run of the plain path on the same operands,
     both capped at a few Adam iterations, and profiles a capped repeat;
 17. runs the two-camera session through ``ensemble_kalman_smoother_multicam``
     with auto-tuned s at n_latent 1, 2 and 4 (kernel A at (1, 4) and
     (2, 4) and the D = 1 and 2 scans; at 4, beyond both, the staged loss
     and the final pass on the plain scan, counted as the plain route),
     counting launches; holds each final pass against the float64
     sequential smoother and each s against CPU runs of the plain path on
     the same operands (three keypoints, capped at a few Adam iterations):
     with the stop rule off, trajectory against trajectory; with it on, each
     lane's s against the CPU's trajectory at the iteration where that lane
     stopped on the card, printing the lanes' stop iterations on the card,
     the CPU and a float64 CPU run; and prints the seconds the phase took;
 18. runs ``fit_eks_multicam`` with the calibration on the bundled
     ``data/multicam`` session, auto s, against the committed goldens
     ``multicam_cal_cam0`` (5e-4) and ``multicam_cal_3d`` (1e-4), and with
     s = 10 on its 200-frame crop (``tests/integration/cropping.py``)
     against ``fast_multicam_cal_cam0`` and ``fast_multicam_cal_3d``;
 19. on the JAX package's calibrated recipe (bench.py: 10,000 frames x 5
     keypoints x 3 cameras x 5 seeds, seed 0, made with the port's
     ``Camera``) holds the scan kernel against its plain version on every
     operand one Adam iteration and the final pass give it (5 lanes: the
     three paired D = 3 filter sweeps, the 13 relinearized filter tables,
     the smoother table); runs ``ensemble_kalman_smoother_multicam(
     camgroup=...)`` with auto-tuned s, counting launches (3 paired D = 3
     filter scans an Adam iteration; 13 filter scans and 1 smoother scan in
     the final pass), checks its final pass against the float64 sequential
     EKF smoother (1e-4 in 3-D, 1e-2 px; printing the filtered-means
     control), holds its s on two keypoints against a CPU run of the plain
     path, both capped at a few Adam iterations, by phase 17's rule, and
     profiles a capped repeat;
 20. runs ``ensemble_kalman_smoother_singlecam_sessions`` on four headline
     sessions (seed 1) as 80 lanes of one run, first holding kernel A at
     (2, 2) paired and the D = 2 filter and smoother scans against their
     plain versions on the operands that run gives them (80 lanes), then
     counting launches, holding every session's s and table against its
     solo run (5e-4 of 1 + |solo|) and each batched and solo table against
     the float64 sequential smoother at its own s (printing two controls),
     and ``fit_eks_singlecam`` with s_frames [(0, 250)] on the bundled
     session against the committed ``singlecam_auto`` golden (1e-4), and
     profiles a repeat of the batched run. Phases 18-20 print their
     seconds; 18 and 19 run right after the build (1);
 21. runs the command line (``eks_tpu_torch/cli``), right after phase 19:
     (a) writes the headline session (phase 5's arrays) as 5 DLC CSVs, runs
     ``python -m eks_tpu_torch.cli.main singlecam --verbose`` on them in a
     process of its own, timed from start to exit, and prints the split of
     that wall from the process's run report (the package's import, CUDA
     context, kernel build and library load, CSV read, the entry point's
     stages and table, CSV write);
     holds its output table and s within 1e-6 of ``fit_eks_singlecam`` in
     this process with the arguments the CLI forwards; runs the same command
     line through ``main()`` in this process, counting launches (kernel A
     (2, 2) paired once an Adam iteration, one filter and one smoother
     scan, nothing else); requires that the process built no library and
     that every CSV of the phase went through the native reader and writer;
     and times those against pandas on the same files and table. (b) runs
     every subcommand through ``main()`` on the bundled ``data/`` sessions
     against the committed goldens at ``tests/integration/test_golden.py``'s
     limits, ``singlecam --sessions`` and ``ibl-pupil --sessions`` (auto
     s) on two copies of a session in directories of one basename against
     the solo runs (tables at ``SEQ_ATOL_SESSIONS``, s within 5e-4), and
     ``mirrored-multicam`` with the CLI's own defaults against
     ``fit_eks_mirrored_multicam`` with those arguments (1e-6);
 22. multi-device smoothing (``eks_tpu_torch/parallel``), after phase 20:
     prints the card count and the meshes it runs (four shards on cuda:0
     through ``parallel.mesh`` on any host; on a host with several cards
     also ``devices=min(4, count)``, a card each), and on a one-card host
     holds that ``devices=2`` raises ValueError; holds the carried scan
     (``prefix_scan.cu``'s phase A, then its downsweep from a carry) and its
     chunk total against their plain versions at every instance (filter and
     smoother, float and paired, D = 1, 2, 3, on 2,500-step chunks), times
     both phases and the uncarried scan of the same chunk with the L2
     flushed between calls, prints ptxas's registers and spills of the
     carried and uncarried kernels, and holds the sharded scans (four chunks
     of 10,000 steps) against the unsharded kernel scan, at
     ``RTOL_SCAN_NEW``; runs the
     headline with the keypoint axis and with the time axis over the shards
     (s per lane against a one-device run by phase 17's rule, the keypoint
     tables at ``SEQ_ATOL_SESSIONS``, the time axis's final pass against
     the float64 sequential smoother), the pupil solo session on the frame
     axis (the ``pupil_fixed`` golden at 1e-4 and the optimizer capped at
     ``CAP_PUPIL_22`` against the one-device run), the two-camera session
     and the calibrated rig on the keypoint axis (capped as in phase 19,
     the stop rule off, against one-device runs), and ``singlecam
     --devices`` on both axes against the ``singlecam_fixed`` golden;
     counts every launch of each run; prints each wall beside its
     one-device wall and the phase's seconds against its 180 s budget.

Each phase prints one JSON line; any failure raises, so the exit code is not
0. The last lines are the main paths' launch counts, the card's name and
power limit, the per-kernel JSON line, and ``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside a checkout of the repository, it exits with
a nonzero code before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# headline workload (the JAX package's bench.py: T, K, SEEDS and make_session)
T_HEAD, K_HEAD, SEEDS_HEAD = 10_000, 20, 5

# multi-camera workload (the JAX package's bench.py::bench_multicam): 10,000
# frames x 10 keypoints x 5 seeds, two cameras; and the same at six cameras
# (12 observations: beyond the fused NLL). Adam iterations of the capped
# six-camera runs that are held against the CPU's plain path
T_MC, K_MC, SEEDS_MC, CAMS_MC, CAMS_MC_WIDE, CAP_MC_WIDE = 10_000, 10, 5, 2, 6, 10
# the two-camera session at other latent sizes (phase 17), and how many of its
# keypoints the capped CPU run of the plain path takes to hold s against
N_LATENTS, NL_CHECK_LANES = (1, 2, 4), 3

# calibrated workload (the JAX package's bench.py: bench_multicam_calibrated
# and _calibrated_rig): 10,000 frames x 5 keypoints x 3 cameras x 5 seeds
# (O = 6, D = 3); how many of its keypoints the capped CPU run of the plain
# path takes to hold s against, at how many Adam iterations, and the Adam
# iterations of the profiled repeat
T_CAL, K_CAL, CAMS_CAL, SEEDS_CAL, CAL_CHECK_LANES, CAP_CAL, CAP_CAL_PROF = 10_000, 5, 3, 5, 2, 3, 4
# singlecam sessions (bench.py: bench_sessions): four headline sessions
N_SC_SESSIONS = 4

# phase 22: the pupil solo session's optimizer on the frame axis is capped at
# this many Adam iterations, as is the one-device run it is held against; the
# two take the same loss in two float32 evaluations (kernel C on one device,
# the time-varying-R loss in matrix form over the sharded scan on four
# shards), so
# their parameters may drift apart by rounding over the iterations. Relative
# limit on each parameter: the JAX package's own limit for its sharded pupil
# optimizer against its one-device run (tests/test_parallel.py, rtol 1e-3)
CAP_PUPIL_22, PUPIL_S_RTOL_22 = 200, 1e-3

# pupil workload (the JAX package's bench.py: bench_pupil and
# bench_pupil_sessions): 10,000 frames x 5 seeds, 8 sessions; how many of the
# 8 are also run alone, to hold the batched run's parameters against
T_PUPIL, SEEDS_PUPIL, N_SESSIONS, N_SOLO_CHECKED = 10_000, 5, 8, 2

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
# kernel C, per lane against 1 + |plain|, for the value and the derivative:
# its lanes are the pupil optimizer's, 10,000 steps of an 8-observation
# log-density, |ll| from 2e4 to 9e4. Kernel and plain version differ by about
# 0.04 absolute whatever |ll| is (each is about as far from the float64
# value, which phase 6 prints beside the gap), so the relative gap is largest
# on the lane with the smallest |ll|: 2.1e-6 measured on an H100 over 16
# lanes. The limit sits five times above it; a dropped or doubled step
# (about 8 of 2e4) would show 40 times over it
RTOL_NLL_TV = 1e-5
# kernel B at D = 3 on the pupil final pass's elements: 3.0e-6 measured, with
# the kernel 1.8e-6 and the plain version 2.2e-6 from the float64 scan
RTOL_SCAN_D3 = 1e-5
# the smoother and the paired instances of the scan, per entry against
# 1 + |plain|: same two association orders, same reason
RTOL_SCAN_NEW = 1e-5
# d ll / d log s on the multi-camera optimizers' operands, per lane against
# 1 + |the float64 plain value|, by the number of cameras: there |ll| is 1e6
# (two cameras) to 2e7 (six) and the derivative about -1e3, a sum of 10,000
# terms that cancel, so float32 leaves it 1e-2 to 4e-1 absolute from the
# float64 value whichever way it is computed. On an H100 the kernels' gaps
# from float64 were 7.5e-5 at two cameras and 3.7e-4 at six, the plain
# float32 version's 1.0e-4 and 3.7e-4; the limits sit four and under three
# times above the kernels'. Besides, a kernel may be at most DLL_GAP_FACTOR
# times as far from float64 as the plain float32 version is on the same
# operands, and as far from the plain float32 version as the limit. The value
# itself is held to RTOL_NLL / RTOL_NLL_TV against the plain float32 version
RTOL_DLL_MC = {2: 3e-4, 6: 1e-3}
# the same rule for kernel A's other instances (phase 16), by n_latent = D:
# the fewer latents, the more of the signal the constant R leaves in the
# residuals, the larger |ll| against d ll (phase 16 prints both), so the more
# the sum cancels. On an H100 the kernel's gaps from float64 were up to
# 1.1e-3 at D = 1, 6.4e-4 at D = 2 and 3.4e-4 at D = 3, the plain float32
# version's up to 1.3e-3, 4.6e-4 and 3.4e-4; the limits sit three to four
# times above the kernel's. (3, 2) is held on random-walk lanes, where
# nothing cancels: 1.0e-6 and 7.2e-7 measured for kernel and plain version,
# so there the gaps are rounding, and DLL_GAP_FACTOR is not applied
RTOL_DLL_A = {1: 4e-3, 2: 2e-3, 3: 1e-3, "lanes": 1e-5}
DLL_GAP_FACTOR = 2.0

# the calibrated final pass against the float64 sequential EKF smoother
# (phase 19), absolute, in 3-D units and in pixels. On an H100 the final
# pass was 1.0e-6 and 3.8e-4 px from it, and the control (the float64
# filtered means in place of the smoothed ones, what a final pass that
# skipped its smoother would give) 7.5e-3 and 1.5 px: the limits sit 100
# and 26 times above the first, 75 and 150 times under the second
SEQ_ATOL_CAL_3D = 1e-4
SEQ_ATOL_CAL_PX = 1e-2
# the sessions' batched and solo tables against the float64 sequential
# smoother at each run's s (phase 20), absolute, by column. On an H100 the
# eight tables were up to 3.5e-4 (x, y) and 6.2e-4 (posterior variances)
# from it; the controls, the float64 smoother at s 1 % off, 8.8e-3 and
# 2.9e-3, and the filtered means 1.8 (x, y). Each limit sits about midway
# (geometrically) between the two
SEQ_ATOL_SESSIONS = {"xy": 2e-3, "posterior_var": 1.5e-3}


_T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets the script's seconds so
    far (``elapsed_s``)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T_START}
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


def combine_ops(D, dual=False):
    """One filtering-element combine: eight D x D products, four matvecs,
    the closed-form D x D inverse (D <= 3) and the sums."""
    inv_mul, inv_add = {1: (0, 0), 2: (6, 1), 3: (30, 11)}[D]
    return _ops(
        mul=8 * D ** 3 + 4 * D * D + inv_mul,
        add=8 * D * D * (D - 1) + 4 * D * (D - 1) + D + inv_add + 4 * D + 2 * D * D,
        div=1, dual=dual,
    )


def smoother_combine_ops(D, dual=False):
    """One smoothing-element combine: E_e E_l, E_e g_l + g_e,
    (E_e L_l) E_eᵀ + L_e."""
    return _ops(mul=3 * D ** 3 + D * D, add=3 * D * D * (D - 1) + D * (D - 1) + D + D * D,
                div=0, dual=dual)


def nll_ops(N, T, D, O, dual):
    return N * T * kf_step_ops(D, O, dual)


def scan_ops(N, T, D):
    return N * (T - 1) * combine_ops(D)


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


def device_ms(torch, fn, reps):
    """(device milliseconds per call, and per kernel name) of the port's own
    kernels (those in a top-level anonymous namespace, as csrc/ declares
    them; PyTorch's own sit in one inside at::native), each of which a call
    launches once, under the profiler over ``reps`` calls: the mean of each
    kernel's recorded launches, so the card's time alone, without the launch
    gaps and the host's dispatch time that ``time_cuda`` also sees, and
    without counting a launch the profiler failed to record. A profile now
    and then records none of a kernel's launches, or none at all, so a
    reading counts only from the second profile on, when it recorded every
    kernel any profile has; after eight profiles without one it raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = set()
    for attempt in range(8):
        by_name = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            scope, _, rest = e.key.partition("(anonymous namespace)::")
            if e.device_type == torch.autograd.DeviceType.CUDA and rest and scope.strip() in ("", "void"):
                name = rest.split("<")[0].split("(")[0]
                total, count = by_name.get(name, (0.0, 0))
                by_name[name] = (total + e.self_device_time_total / 1e3, count + e.count)
        seen |= set(by_name)
        if by_name and set(by_name) == seen and attempt > 0:
            per_launch = {k: total / count for k, (total, count) in by_name.items()}
            return sum(per_launch.values()), per_launch
    raise RuntimeError(f"device_ms: eight profiles gave no record of all the kernels {sorted(seen)}: {by_name}")


def enqueue_ms(torch, fn, reps):
    """Mean host milliseconds to dispatch one call, over ``reps`` calls made
    back to back before one synchronise: where this reaches ``time_cuda``'s
    figure, the host, not the card, sets the pace of a loop of calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def device_profile(torch, prof, wall_s, iters):
    """What ran on the card under a device-only profile: busy seconds, the
    idle share against the unprofiled wall ``wall_s`` of the same work, the
    operations in all and per Adam iteration, and the six longest."""
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in on_device) / 1e6
    n_ops = sum(e.count for e in on_device)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s if busy_s else None,
        "device_ops": n_ops, "device_ops_per_adam_iter": n_ops / iters if iters else None,
        "top": [{"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3} for e in top],
    }


def ptxas_by_kernel(report: str) -> dict:
    """``ptxas_summary`` grouped: {mangled kernel name: its spill line and
    its registers line} (a kernel that is no template, and so has no name
    there, is left out)."""
    out, name = {}, None
    for line in ptxas_summary(report):
        if "_kernelI" in line:
            name = line
            out[name] = []
        elif name is not None and len(out[name]) < 2:
            out[name].append(line)
    return out


def ptxas_summary(report: str) -> list:
    """The kernels' register and spill lines from nvcc's -Xptxas -v output,
    each instance's under its (mangled) template name."""
    keep = []
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernelI\w+?)Ev", line)
        if entry:
            keep.append(entry.group(1))
        elif "Used" in line and "registers" in line or "spill" in line:
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


def make_multicam_session(np, rng, cams):
    """Synthetic multi-camera ensemble session (the recipe of the JAX
    package's bench.py::bench_multicam): a random walk per camera and
    coordinate, plus per-seed jitter."""
    T, K, M = T_MC, K_MC, SEEDS_MC
    base = rng.normal(size=(1, cams, T, K, 2)).cumsum(axis=2) * 0.3 + 50
    arr = np.zeros((M, cams, T, K, 3), dtype=np.float32)
    arr[..., :2] = base + rng.normal(size=(M, cams, T, K, 2)) * 0.3
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(M, cams, T, K))
    return arr


def make_pupil_session(np, rng):
    """Synthetic pupil ensemble session (the recipe of the JAX package's
    bench.py::bench_pupil): a random-walk centre and diameter seen through
    the four pupil edge keypoints, plus per-seed jitter."""
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


def calibrated_rig(np, rng):
    """The JAX package's bench.py::_calibrated_rig with the port's Camera:
    three cameras 0.4 rad apart around a 3-D random walk of K_CAL keypoints,
    each model's views with unit pixel noise. Returns (CameraGroup,
    (SEEDS_CAL, CAMS_CAL, T_CAL, K_CAL, 3) float32 predictions)."""
    import torch
    from eks_tpu_torch.geometry import Camera, CameraGroup

    cams = [Camera(name=f"cam{c}", matrix=np.array([[900.0, 0, 320], [0, 900.0, 240], [0, 0, 1]]),
                   dist=np.array([-0.05, 0.01, 0.0, 0.0, 0.0]), rvec=np.array([0.0, 0.4 * (c - 1), 0.0]),
                   tvec=np.array([0.25 * (c - 1), 0.0, 2.5])) for c in range(CAMS_CAL)]
    group = CameraGroup(cams)
    X = rng.normal(size=(T_CAL, K_CAL, 3)).cumsum(axis=0) * 0.002
    arr = np.zeros((SEEDS_CAL, CAMS_CAL, T_CAL, K_CAL, 3), dtype=np.float32)
    for c, cam in enumerate(cams):
        uv = cam.projection_fn("cpu", torch.float64)(torch.as_tensor(X.reshape(-1, 3))).numpy()
        arr[:, c, :, :, :2] = uv.reshape(T_CAL, K_CAL, 2)[None] + rng.normal(size=(SEEDS_CAL, T_CAL, K_CAL, 2))
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(SEEDS_CAL, CAMS_CAL, T_CAL, K_CAL))
    return group, arr


def fd_jacobian(torch, h_fn, m):
    """Jacobians (N, O, D) of ``h_fn`` at the float64 points m (N, D) by
    central differences, one batched call of ``h_fn`` on the 2D shifted
    points: truncation and rounding errors near 1e-10 relative."""
    D = m.shape[-1]
    step = 1e-6 * (1.0 + m.abs())[:, None, :] * torch.eye(D, dtype=m.dtype)  # (N, D, D)
    hv = h_fn(torch.cat([m[:, None] + step, m[:, None] - step], dim=1))  # (N, 2D, O)
    return ((hv[:, :D] - hv[:, D:]) / (2.0 * step.sum(dim=-1, keepdim=True))).transpose(-1, -2)


def seq_smoother_f64(torch, ys, m0, S0, A, Q, C, r, h_fn=None, filtered=False):
    """Smoothed means (N, T, D) and covariances (N, T, D, D) of the float64
    sequential (extended) Kalman filter and RTS smoother over N lanes on the
    host, every step's solves batched over the lanes through LAPACK
    (``torch.linalg``): the float64 oracle of the multi-camera final passes
    and of the sessions' tables. The recursion of the port's
    ``ops/kalman.py`` (y_0 against the prior, the update P - K S Kᵀ; with
    ``h_fn`` the emission linearized at each predicted mean, its Jacobian by
    ``fd_jacobian``), whose unrolled O x O algebra and per-step ``jacfwd``
    take minutes of host time per 10,000 steps. With ``filtered`` the
    filtered means (N, T, D) come third."""
    T = ys.shape[1]
    At = A.transpose(-1, -2)
    m, P, ms, Ps = m0, S0, [], []
    for t in range(T):
        if h_fn is None:
            H, hx = C, (C @ m[..., None])[..., 0]
        else:
            H, hx = fd_jacobian(torch, h_fn, m), h_fn(m)
        S = H @ P @ H.transpose(-1, -2) + torch.diag_embed(r[:, t])
        K = torch.cholesky_solve(H @ P, torch.linalg.cholesky(S)).transpose(-1, -2)
        m = m + (K @ (ys[:, t] - hx)[..., None])[..., 0]
        P = P - K @ S @ K.transpose(-1, -2)
        ms.append(m)
        Ps.append(P)
        m, P = (A @ m[..., None])[..., 0], A @ P @ At + Q
    m_s, P_s, out_m, out_P = ms[-1], Ps[-1], [ms[-1]], [Ps[-1]]
    for t in range(T - 2, -1, -1):
        P_pred = A @ Ps[t] @ At + Q
        G = torch.linalg.solve(P_pred, A @ Ps[t]).transpose(-1, -2)
        m_s = ms[t] + (G @ (m_s - (A @ ms[t][..., None])[..., 0])[..., None])[..., 0]
        P_s = Ps[t] + G @ (P_s - P_pred) @ G.transpose(-1, -2)
        out_m.append(m_s)
        out_P.append(P_s)
    smoothed = torch.stack(out_m[::-1], dim=1), torch.stack(out_P[::-1], dim=1)
    return smoothed + (torch.stack(ms, dim=1),) if filtered else smoothed


def lane_errs(a, b) -> tuple:
    """(max |a - b|, max |a - b| / (1 + |b|)) over the lanes where both are
    finite, and whether the two are finite on the same lanes."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    if not bool(both.any()):
        return 0.0, 0.0, bool((fa == fb).all())
    diff = (a[both] - b[both]).abs()
    return float(diff.max()), float((diff / (1.0 + b[both].abs())).max()), bool((fa == fb).all())


@contextlib.contextmanager
def recording(module, name: str, calls: list, first_only: bool = False):
    """While open, each call of ``module.name`` (a kernel's wrapper, which
    the port looks up at call time) appends its tensor arguments, cloned,
    to ``calls`` (only the first call with ``first_only``) and then runs as
    before: the operands a main path gives the kernel."""
    wrapper = getattr(module, name)

    def record(*args):
        if not (first_only and calls):
            calls.append(tuple(a.clone() if hasattr(a, "clone") else a for a in args))
        return wrapper(*args)

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, wrapper)


def rel_err(a, b) -> tuple:
    """(max |a - b|, max |a - b| / (1 + |b|)), both entry by entry: per lane
    for kernel A's (N,) outputs, per plane and step for kernel B's."""
    diff = (a - b).abs()
    return float(diff.max()), float((diff / (1.0 + b.abs())).max())


# --------------------------------------------------------------------------- #
# phase 21: the command line, as a user runs it
# --------------------------------------------------------------------------- #
# the sessions' tables against the solo run's, absolute, by column: the
# variances (ensemble and posterior) at SEQ_ATOL_SESSIONS["posterior_var"],
# every other column at its "xy"
def sessions_table_gap(np, got, want) -> dict:
    """max |got - want| over the variance columns and over the others, with
    whether the columns match and both tables are finite."""
    var = np.array(["var" in str(c[-1]) for c in want.columns])
    diff = np.abs(got.to_numpy() - want.to_numpy())
    return {
        "xy": float(diff[:, ~var].max()), "var": float(diff[:, var].max()) if var.any() else 0.0,
        "columns_match": [tuple(map(str, c)) for c in got.columns] == [tuple(map(str, c)) for c in want.columns],
        "finite": bool(np.isfinite(got.to_numpy()).all()),
    }


def cli_phase(torch, np, pd, card, reset_counts, read_counts, a_key, golden_gap) -> None:
    """Phase 21 (see the module docstring); raises on any miss."""
    import eks_tpu_torch
    from eks_tpu_torch import native
    from eks_tpu_torch.cli import main as cli_main
    from eks_tpu_torch.utils import io, save_dlc_csv

    t_phase = time.perf_counter()
    reads0, writes0 = dict(native.READS), dict(native.WRITES)
    failures = []
    log = logging.getLogger("eks_tpu_torch")
    reports = []

    class Reports(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("run report: "):
                reports.append(json.loads(msg[len("run report: "):]))

    def cli(*argv):
        """``main()`` in this process on ``argv --verbose``: its run report
        and wall. Its logs are captured, not printed."""
        saved_argv, level, propagate = sys.argv, log.level, log.propagate
        handler = Reports(logging.DEBUG)
        log.addHandler(handler)
        log.propagate = False
        sys.argv = ["eks-tpu-torch", *argv, "--verbose"]
        t0 = time.perf_counter()
        try:
            cli_main.main()
        finally:
            sys.argv = saved_argv
            log.setLevel(level)
            log.propagate = propagate
            log.removeHandler(handler)
        return {**reports.pop(), "wall_s": time.perf_counter() - t0}

    def read(path):
        return pd.read_csv(path, header=[0, 1, 2], index_col=0)

    def rel_gap(got, want):
        """(max |got - want|, max |got - want| / (1 + |want|))"""
        diff = np.abs(np.asarray(got, dtype=np.float64) - np.asarray(want, dtype=np.float64))
        return float(diff.max()), float((diff / (1.0 + np.abs(np.asarray(want, dtype=np.float64)))).max())

    def best_of(fn, reps=2):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the headline session as 5 DLC CSVs, through the CLI in a process
        # of its own, as a user runs it
        arr = make_session(np, np.random.default_rng(0))
        kps = [f"kp{i}" for i in range(K_HEAD)]
        src = os.path.join(tmp, "headline")
        os.makedirs(src)
        paths = []
        for m in range(SEEDS_HEAD):
            cols = pd.MultiIndex.from_product([[f"seed{m}"], kps, ["x", "y", "likelihood"]],
                                              names=["scorer", "bodyparts", "coords"])
            paths.append(os.path.join(src, f"session.rng={m}.csv"))
            save_dlc_csv(pd.DataFrame(arr[m, 0].reshape(T_HEAD, K_HEAD * 3), columns=cols), paths[-1])
        out_cli = os.path.join(tmp, "cli")
        argv = ["singlecam", "--input-dir", src, "--save-dir", out_cli]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "eks_tpu_torch.cli.main", *argv, "--verbose"], cwd=REPO,
                              capture_output=True, text=True, timeout=900)
        wall_sub = time.perf_counter() - t0
        found = re.search(r"run report: (\{.*\})", proc.stderr)
        if proc.returncode != 0 or found is None:
            raise AssertionError(f"the CLI process ended with {proc.returncode}:\n{proc.stderr[-4000:]}")
        rep = json.loads(found.group(1))
        # seconds by name: the process record's, then each span's total
        sec = {**rep["process"], **{k: v["s"] for k, v in rep["spans"].items()}}
        builds = {k.split(".", 1)[1]: v for k, v in rep["process"].items() if k.startswith("kernel_build.")}
        loads = [v for k, v in rep["process"].items() if k.startswith("kernel_load.")]
        # nvcc runs once per library, all at once: the longest is the build's wall
        sec.update(kernel_build=max(builds.values(), default=0.0), kernel_load=sum(loads))
        table_sub = read(os.path.join(out_cli, "eks_singlecam.csv"))

        # the entry point in this process, with the arguments the CLI forwards
        tm_in = {}
        t0 = time.perf_counter()
        df_in, s_in, _, _ = eks_tpu_torch.fit_eks_singlecam(
            input_source=src, save_file=os.path.join(tmp, "in", "eks_singlecam.csv"), bodypart_list=None,
            smooth_param=None, s_frames=None, blocks=[], devices=None, partition="keypoint", device="cuda",
            timings=tm_in)
        wall_in = time.perf_counter() - t0
        # the CSV holds each float32 by its shortest decimal: read back as
        # float32 it gives the same bits
        table_gap = rel_gap(table_sub.to_numpy().astype(np.float32), df_in.to_numpy())
        s_cli_gap = rel_gap(rep["s"][0], s_in)
        same_cols = [tuple(map(str, c)) for c in table_sub.columns] == [tuple(map(str, c)) for c in df_in.columns]

        # the same command line in this process, with the kernels' launches
        # counted: kernel A (2, 2) paired once an Adam iteration, then one
        # filter and one smoother scan
        reset_counts()
        rep_main = cli(*argv)
        launches_cli = read_counts()
        iters_cli = rep_main["spans"]["adam.loss"]["n"]
        want_launches = {"fused_nll_paired": iters_cli, a_key(2, 2, True): iters_cli,
                         "prefix_scan_filter": 1, "prefix_scan_smoother": 1}
        launches_ok = iters_cli > 0 and all(launches_cli[k] == want_launches.get(k, 0) for k in launches_cli)
        main_gap = rel_gap(read(os.path.join(out_cli, "eks_singlecam.csv")).to_numpy().astype(np.float32),
                           df_in.to_numpy())

        # the native reader and writer against pandas on the same files and
        # table (pandas called directly: not counted as the port's reads)
        read_native_s = best_of(lambda: [io._load_one_native(p) for p in paths])
        read_pandas_s = best_of(lambda: [io.convert_lp_dlc(raw, io.get_keypoint_names(raw)) for raw in
                                         (pd.read_csv(p, header=[0, 1, 2], index_col=0) for p in paths)])
        w_native, w_pandas = os.path.join(tmp, "native.csv"), os.path.join(tmp, "pandas.csv")
        def write_native():
            if not native.write_dlc_csv_fast(df_in, w_native):
                raise AssertionError("the native writer did not take the headline table")

        write_native_s = best_of(write_native)
        write_pandas_s = best_of(lambda: df_in.to_csv(w_pandas))
        with open(w_native, "rb") as f_n, open(w_pandas, "rb") as f_p:
            write_same_bytes = f_n.read() == f_p.read()

        accounted = sum(sec.get(k, 0.0) for k in ("import", "device_context", "kernel_build", "kernel_load", "fit"))
        headline = {
            "frames": T_HEAD, "keypoints": K_HEAD, "seeds": SEEDS_HEAD, "returncode": proc.returncode,
            "cli_wall_s": wall_sub,
            "split_s": {
                "interpreter_start_argparse_exit": wall_sub - accounted,
                "imports_torch_and_eks_tpu_torch": sec.get("import"),
                "cuda_context": sec.get("device_context"),
                "kernel_build": sec.get("kernel_build"), "kernel_library_load": sec.get("kernel_load"),
                "csv_read": sec.get("read"), "prep": sec.get("prep"), "optimizer": sec.get("optimizer"),
                "final_pass": sec.get("final_pass"), "package": sec.get("package"), "table": sec.get("table"),
                "csv_write": sec.get("write"), "entry_point_call": sec.get("fit"),
            },
            "adam_iters": rep["spans"]["adam.loss"]["n"], "kernels_built_by_cli": builds,
            "csv_libraries_built_by_cli": rep.get("csv_libraries_built"),
            "cli_csv_reads": rep["csv_reads"], "cli_csv_writes": rep["csv_writes"],
            "in_process_wall_s": wall_in,
            "in_process_timings": {k: v for k, v in tm_in.items() if k not in ("spans", "counts")},
            "table_max_abs_gap_vs_in_process": table_gap[0], "table_rel_gap_vs_in_process": table_gap[1],
            "s_max_abs_gap_vs_in_process": s_cli_gap[0], "s_rel_gap_vs_in_process": s_cli_gap[1],
            "in_process_main_table_rel_gap": main_gap[1], "rtol": 1e-6, "columns_match": same_cols,
            "launches_in_process_main": {k: v for k, v in launches_cli.items() if v},
            "in_process_main_wall_s": rep_main["wall_s"],
        }
        native_vs_pandas = {
            "read_5_files_native_s": read_native_s, "read_5_files_pandas_s": read_pandas_s,
            "write_table_native_s": write_native_s, "write_table_pandas_s": write_pandas_s,
            "table_shape": list(df_in.shape), "table_dtype": str(df_in.to_numpy().dtype),
            "write_byte_identical": write_same_bytes,
        }
        if not (same_cols and table_gap[1] <= 1e-6 and s_cli_gap[1] <= 1e-6 and main_gap[1] <= 1e-6):
            failures.append("the CLI's headline output differs from the entry point's in this process")
        if not launches_ok:
            failures.append(f"the CLI's launches are not one A (2, 2) an Adam iteration and one B filter and "
                            f"smoother: {launches_cli}")
        if builds or rep.get("csv_libraries_built"):
            failures.append("the CLI process built libraries the checkout already had")
        if rep["csv_reads"] != {"native": SEEDS_HEAD, "pandas": 0} or rep["csv_writes"] != {"native": 1, "pandas": 0}:
            failures.append(f"the CLI process's CSVs took pandas: {rep['csv_reads']}, {rep['csv_writes']}")
        if not write_same_bytes:
            failures.append("the native writer's table differs from pandas' bytes")

        # (b) every subcommand in this process on the bundled sessions, against
        # the committed goldens at test_golden.py's limits; both --sessions
        # modes on two copies of a session in directories of one basename,
        # against the solo runs; one subcommand with the CLI's own defaults
        data = os.path.join(REPO, "data")

        def out(name):
            return os.path.join(tmp, "b", name)

        def copies(family):
            dirs = [os.path.join(tmp, f"copy{i}", family) for i in range(2)]
            for d in dirs:
                shutil.copytree(os.path.join(data, family), d)
            return dirs

        mirrored = ["--input-dir", f"{data}/mirrored", "--camera-names", "top", "bot"]
        runs = {
            "singlecam_fixed": cli("singlecam", "--input-dir", f"{data}/singlecam", "--save-dir", out("sc_fixed"),
                                   "--s", "2.0"),
            "singlecam_auto": cli("singlecam", "--input-dir", f"{data}/singlecam", "--save-dir", out("sc_auto"),
                                  "--s-frames", "[(0,250)]"),
            "singlecam_sessions": cli("singlecam", "--sessions", *copies("singlecam"), "--save-dir",
                                      out("sc_sessions"), "--s-frames", "[(0,250)]"),
            "pupil_fixed": cli("ibl-pupil", "--input-dir", f"{data}/pupil", "--save-dir", out("pupil_fixed"),
                               "--diameter-s", "0.99", "--com-s", "0.98"),
            "pupil_auto": cli("ibl-pupil", "--input-dir", f"{data}/pupil", "--save-dir", out("pupil_auto")),
            "pupil_sessions": cli("ibl-pupil", "--sessions", *copies("pupil"), "--save-dir", out("pupil_sessions")),
            "mirrored_fixed": cli("mirrored-multicam", *mirrored, "--save-dir", out("mirrored_fixed"), "--s", "3.0",
                                  "--quantile-keep-pca", "50", "--no-inflate-vars"),
            "mirrored_auto_inflate": cli("mirrored-multicam", *mirrored, "--save-dir", out("mirrored_auto"),
                                         "--quantile-keep-pca", "50"),
            "multicam_calibrated": cli("multicam", "--input-dir", f"{data}/multicam", "--save-dir", out("cal"),
                                       "--calibration", f"{data}/multicam/calibration.toml", "--no-inflate-vars"),
            "paw": cli("ibl-paw", "--input-dir", f"{data}/paw", "--save-dir", out("paw"),
                       "--quantile-keep-pca", "50", "--no-inflate-vars"),
            "mirrored_cli_defaults": cli("mirrored-multicam", *mirrored, "--save-dir", out("mirrored_defaults")),
        }
        goldens = {}
        for name, path, atol in (
                ("singlecam_fixed", "sc_fixed/eks_singlecam.csv", 1e-4),
                ("singlecam_auto", "sc_auto/eks_singlecam.csv", 1e-4),
                ("pupil_fixed", "pupil_fixed/eks_ibl_pupil.csv", 1e-4),
                ("pupil_auto", "pupil_auto/eks_ibl_pupil.csv", 1e-2),
                ("mirrored_fixed", "mirrored_fixed/eks_mirrored_multicam.csv", 1e-4),
                ("mirrored_auto_inflate", "mirrored_auto/eks_mirrored_multicam.csv", 1e-4),
                ("multicam_cal_cam0", "cal/multicam_cam0_results.csv", 5e-4),
                ("multicam_cal_3d", "cal/multicam_3d_results.csv", 1e-4),
                ("paw_left", "paw/multicam_left_results.csv", 1e-4),
                ("paw_right", "paw/multicam_right_results.csv", 1e-4)):
            gap, same = golden_gap(read(out(path)), name)
            goldens[name] = {"max_abs_err": gap, "atol": atol, "columns_match": same}
            if not (same and gap <= atol):
                failures.append(f"{name} golden missed through the CLI: {goldens[name]}")

        sessions = {}
        for tag, solo, prefix, family, s_limit in (
                ("singlecam_sessions", "singlecam_auto", "sc", "singlecam", "rel"),
                ("pupil_sessions", "pupil_auto", "pupil", "pupil", "abs")):
            stem = "eks_singlecam" if family == "singlecam" else "eks_ibl_pupil"
            want = read(out(f"{prefix}_auto/{stem}.csv"))
            s_solo = np.asarray(runs[solo]["s"][0])
            for i in range(2):
                res = sessions_table_gap(np, read(out(f"{prefix}_sessions/{stem}_{i}_{family}.csv")), want)
                s_i = np.asarray(runs[tag]["s"][i])
                res["s_gap"] = float((np.abs(s_i / s_solo - 1.0) if s_limit == "rel" else np.abs(s_i - s_solo)).max())
                res["s_gap_kind"] = s_limit
                sessions[f"{tag}_{i}"] = res
                if not (res["columns_match"] and res["finite"] and res["xy"] <= SEQ_ATOL_SESSIONS["xy"]
                        and res["var"] <= SEQ_ATOL_SESSIONS["posterior_var"] and res["s_gap"] <= 5e-4):
                    failures.append(f"{tag} session {i} differs from the solo run: {res}")

        # the CLI's own defaults (quantile 95, variance inflation on, auto s),
        # which no golden covers, against the entry point with those arguments
        df_def, s_def, _, _ = eks_tpu_torch.fit_eks_mirrored_multicam(
            input_source=f"{data}/mirrored", save_file=os.path.join(tmp, "mirrored_defaults.csv"),
            bodypart_list=None, smooth_param=None, s_frames=None, camera_names=["top", "bot"],
            quantile_keep_pca=95, inflate_vars=True, n_latent=3, devices=None, partition="keypoint",
            device="cuda")
        def_gap = rel_gap(read(out("mirrored_defaults/eks_mirrored_multicam.csv")).to_numpy().astype(np.float32),
                          df_def.to_numpy())
        def_s_gap = rel_gap(runs["mirrored_cli_defaults"]["s"][0], s_def)
        defaults = {"table_rel_gap": def_gap[1], "s_rel_gap": def_s_gap[1], "rtol": 1e-6,
                    "s": runs["mirrored_cli_defaults"]["s"][0]}
        if max(def_gap[1], def_s_gap[1]) > 1e-6:
            failures.append(f"mirrored-multicam with the CLI's defaults differs from the entry point: {defaults}")

    reads = {k: v - reads0[k] for k, v in native.READS.items()}
    writes = {k: v - writes0[k] for k, v in native.WRITES.items()}
    if reads["pandas"] or writes["pandas"] or not (reads["native"] and writes["native"]):
        failures.append(f"a CSV of the phase went through pandas: reads {reads}, writes {writes}")
    emit({
        "phase": "cli", "headline": headline, "native_vs_pandas": native_vs_pandas, "goldens": goldens,
        "sessions": sessions, "seq_atol_sessions": SEQ_ATOL_SESSIONS, "cli_defaults_mirrored": defaults,
        "walls_s": {tag: r["wall_s"] for tag, r in runs.items()},
        "csv_reads": reads, "csv_writes": writes, "failures": failures,
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    if failures:
        raise AssertionError("; ".join(failures))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import numpy as np
        import pandas as pd

        import eks_tpu_torch
        from eks_tpu_torch.marker_array import MarkerArray
        from eks_tpu_torch.core import run_kalman_smoother
        from eks_tpu_torch.models import ibl_pupil, multicam
        from eks_tpu_torch import tracing
        from eks_tpu_torch.ops import cuda_build, fused_filter, fused_nll, pkalman
        from eks_tpu_torch.ops.kalman import kalman_smoother
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = gpu_name_power()

    def a_key(d, o, paired):
        """The count and row name of kernel A's instance (d, o)."""
        return f"fused_nll{'_paired' if paired else ''}_d{d}_o{o}"

    reset_counts = tracing.reset_launches

    def read_counts():
        launches = tracing.launches
        scans = {
            ("filter", False, 2): "prefix_scan_filter", ("filter", False, 3): "prefix_scan_filter_d3",
            ("smoother", False, 2): "prefix_scan_smoother", ("smoother", False, 3): "prefix_scan_smoother_d3",
        }
        for kind in ("filter", "smoother"):
            for paired in (False, True):
                for d in (1, 2, 3):
                    scans.setdefault((kind, paired, d), f"prefix_scan_{kind}{'_paired' if paired else ''}_d{d}")
        return {
            "fused_nll": launches("A", None, None, False),
            "fused_nll_paired": launches("A", None, None, True),
            "fused_nll_tv": launches("C", False),
            "fused_nll_tv_paired": launches("C", True),
            **{name: launches("scan", *key) for key, name in scans.items()},
            "plain_route": launches("scan_plain_route"),
            "carry_plain_route": launches("scan_carried_plain_route"),
            **{a_key(d, o, paired): launches("A", d, o, paired)
               for d, o in fused_nll._CUDA_SHAPES for paired in (False, True)},
            **{carry_key(*k): launches("scan_carried", *k) for k in scans},
        }

    def carry_key(kind, paired, d):
        """The count and row name of the carried downsweep's instance."""
        return f"carry_{kind}{'_paired' if paired else ''}_d{d}"

    def along_log_s(make, n):
        """(planes, tangents): ``make(log s)`` for n lanes at s = 1 and its
        derivative along log s, the direction the optimizers differentiate
        in (C and J stay symmetric along it)."""
        sl = torch.zeros(n, device=dev)
        planes_, tangents_ = torch.func.jvp(make, (sl,), (torch.ones_like(sl),))
        return planes_.contiguous(), tangents_.contiguous()

    def scan_check(kind, planes, tangents=None, timed=True):
        """One instance against its plain version (and both against the
        float64 plain version) on these operands, with times and bound
        unless not ``timed``."""
        paired = tangents is not None
        n_l, n_p, n_t = planes.shape
        if kind == "smoother":
            d = pkalman.smoother_state_dim(n_p)
            plain, wrapper, wrapper_p = (fused_filter.smoother_suffix_plain, fused_filter.smoother_suffix,
                                         fused_filter.smoother_suffix_paired)
            ops = n_l * (n_t - 1) * smoother_combine_ops(d, dual=paired)
        else:
            d = pkalman.filter_state_dim(n_p)
            plain, wrapper, wrapper_p = (fused_filter.filter_prefix_plain, fused_filter.filter_prefix,
                                         fused_filter.filter_prefix_paired)
            ops = n_l * (n_t - 1) * combine_ops(d, dual=paired)
        if paired:
            def run_k():
                return torch.cat(wrapper_p(planes, tangents), dim=1)

            def run_p(x=planes, dx=tangents):
                return torch.cat(torch.func.jvp(plain, (x,), (dx,)), dim=1)

            out_64 = run_p(planes.double(), tangents.double())
        else:
            def run_k():
                return wrapper(planes)

            def run_p():
                return plain(planes)

            out_64 = plain(planes.double())
        out_k, out_p = run_k(), run_p()
        torch.cuda.synchronize()
        e_abs, e_rel = rel_err(out_k, out_p)
        bound = bound_ms(2 * out_k.numel() * 4, ops)
        plan = fused_filter.scan_plan(n_l, n_t, kind, paired, d, dev)
        res = {
            "kind": kind, "paired": paired, "D": d, "lanes": n_l, "planes": out_k.shape[1], "T": n_t,
            "segments_G": plan["G"], "threads": plan["threads"], "deterministic": deterministic(run_k, out_k),
            "max_abs_err": e_abs, "rel_err": e_rel,
            "rel_err_kernel_vs_f64_plain": rel_err(out_k.double(), out_64)[1],
            "rel_err_plain_vs_f64_plain": rel_err(out_p.double(), out_64)[1],
            "bound_ms": bound[0], "bound_by": bound[1],
        }
        if timed:
            res.update({
                "ms": time_cuda(torch, run_k, 50), "enqueue_ms": enqueue_ms(torch, run_k, 50),
                "device_ms": device_ms(torch, run_k, 20)[0],
                "plain_ms": time_cuda(torch, run_p, 1 if paired else 3),
            })
        res["ok"] = res["deterministic"] and e_rel <= RTOL_SCAN_NEW and bool(torch.isfinite(out_k).all())
        return res

    def deterministic(run, first):
        """Whether another launch on the same inputs gives the same bits."""
        again = run()
        torch.cuda.synchronize()
        return bool(torch.equal(again, first))

    def dll_ok(cams, kernel_vs_64, plain_vs_64, kernel_vs_plain):
        """The derivative's three relative gaps against the limits stated at
        RTOL_DLL_MC."""
        return (kernel_vs_64 <= RTOL_DLL_MC[cams] and kernel_vs_plain <= RTOL_DLL_MC[cams]
                and kernel_vs_64 <= DLL_GAP_FACTOR * plain_vs_64)

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

    def nll_ptxas(d, o):
        """The ptxas lines of kernel A's (d, o) instance, plain and paired:
        its reduce and downsweep, and the totals kernel of its D."""
        by_kernel = ptxas_by_kernel(report.get("fused_nll", (0, ""))[1])
        return {k: v for k, v in by_kernel.items() if k.endswith((f"Li{d}ELi{o}EE", f"totals_kernelIfLi{d}EE",
                                                                     f"totals_kernelIN3eks4DualELi{d}EE"))}

    rng = np.random.default_rng(0)

    fields = ["x", "y", "likelihood"]

    # the golden comparison of the golden phases, and the capped optimizer
    # runs phases 17 and 19 hold against the CPU's plain path
    def golden_gap(df_got, name):
        ref_g = pd.read_csv(os.path.join(REPO, "tests", "integration", "golden", f"{name}.csv"),
                            header=[0, 1, 2], index_col=0)
        same = [tuple(map(str, c)) for c in df_got.columns] == [tuple(map(str, c)) for c in ref_g.columns]
        if df_got.shape != ref_g.shape:
            return math.inf, same
        return float(np.abs(df_got.to_numpy() - ref_g.to_numpy()).max()), same

    core_log = logging.getLogger("eks_tpu_torch.core")

    class BlockIters(logging.Handler):
        """The Adam iterations each block of the s-optimizer took, read
        from the optimizer's DEBUG report ("... after N iters ...")."""

        def __init__(self):
            super().__init__(logging.DEBUG)
            self.iters = []

        def emit(self, record):
            m = re.search(r"after (\d+) iters", record.getMessage())
            if m:
                self.iters.append(int(m.group(1)))

    def capped_opt(ops_dev, tol, cap, run=None):
        """(s, Adam iterations per lane, seconds) of ``run(ops_dev, tol,
        cap)``, by default the optimizer and final pass on ``ops_dev``,
        capped at ``cap`` iterations."""
        handler, level, propagate = BlockIters(), core_log.level, core_log.propagate
        core_log.addHandler(handler)
        core_log.setLevel(logging.DEBUG)
        core_log.propagate = False
        try:
            t0 = time.perf_counter()
            if run is None:
                s_cap = run_kalman_smoother(*ops_dev, safety_cap=cap, tol=tol)[0]
            else:
                s_cap = run(ops_dev, tol, cap)
            seconds = time.perf_counter() - t0
        finally:
            core_log.removeHandler(handler)
            core_log.setLevel(level)
            core_log.propagate = propagate
        if len(handler.iters) != len(s_cap):
            raise AssertionError(f"the optimizer reported {len(handler.iters)} blocks for {len(s_cap)} lanes")
        return s_cap, np.array(handler.iters), seconds

    def s_gap(a, b):
        return np.abs(a / b - 1.0)

    # phases 18 and 19 run first: in a process that had run the other phases
    # before them, the calibrated path's Adam iterations, all host time in
    # forward-mode Python decompositions, ran 2.5-3.5 times as long on an
    # H100 (not explained yet), and the script overran its time limit
    # --------------------------------------------------------------- 18 ---
    # the calibrated family through the bundled data/multicam session and its
    # calibration, against the committed goldens: auto s on the whole
    # session, and s = 10 on the 200-frame crop the fast goldens were made on
    from tests.integration.cropping import make_cropped_session

    t_phase = time.perf_counter()
    cal_golden = {}
    cal_src = os.path.join(REPO, "data", "multicam")
    with tempfile.TemporaryDirectory() as tmp:
        crop = make_cropped_session(cal_src, os.path.join(tmp, "crop"))
        for tag, src, kw, names in (
                ("auto", cal_src, {}, ("multicam_cal_cam0", "multicam_cal_3d")),
                ("fast_fixed", crop, dict(smooth_param=10.0), ("fast_multicam_cal_cam0", "fast_multicam_cal_3d"))):
            t0 = time.perf_counter()
            dfs_g, s_g, _, _, df3_g = eks_tpu_torch.fit_eks_multicam(
                src, os.path.join(tmp, tag), calibration=os.path.join(src, "calibration.toml"), device="cuda", **kw)
            wall_g = time.perf_counter() - t0
            for df, name, atol in ((dfs_g[0], names[0], 5e-4), (df3_g, names[1], 1e-4)):
                gap, same_cols = golden_gap(df, name)
                cal_golden[name] = {"max_abs_err": gap, "atol": atol, "columns_match": same_cols,
                                    "s": [float(x) for x in s_g], "wall_s": wall_g}
    emit({"phase": "golden_multicam_calibrated", "goldens": cal_golden, "seconds": time.perf_counter() - t_phase})
    for name, res in cal_golden.items():
        if not (res["columns_match"] and res["max_abs_err"] <= res["atol"]):
            raise AssertionError(f"{name} golden mismatch: {res}")

    # --------------------------------------------------------------- 19 ---
    # the calibrated family at full width (bench.py's recipe): the optimizer's
    # loss is the iterated-EKF plane NLL, three paired D = 3 filter scans an
    # Adam iteration from the triangulated trajectories; the final pass 13
    # filter scans (12 relinearizations from the prior and the last) and one
    # smoother scan. First the scan kernel on those scans' operands; the
    # optimizer and final pass capped, timed and under the profiler (the
    # timed run's warm-up); then the timed run; its final pass against the
    # float64 sequential EKF smoother at the tuned s;
    # its s on two keypoints against the plain path on the CPU, both capped,
    # by phase 17's rule
    from eks_tpu_torch import core
    from eks_tpu_torch.geometry import make_projection_from_camgroup, stack_camera_params

    t_phase = time.perf_counter()
    cal_group, cal_arr = calibrated_rig(np, np.random.default_rng(0))
    cal_ma = MarkerArray(cal_arr, data_fields=fields)
    cal_kps, cal_cams = [f"kp{i}" for i in range(K_CAL)], [c.name for c in cal_group.cameras]

    def cal_run():
        reset_counts()
        tm = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eks_tpu_torch.ensemble_kalman_smoother_multicam(
            cal_ma, cal_kps, cal_cams, camgroup=cal_group, device="cuda", timings=tm)
        return out, time.perf_counter() - t0, tm, read_counts()

    # the optimizer's operands, from the same prep on the card
    cal_params = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in stack_camera_params(cal_group)]
    cal_t = torch.as_tensor(cal_arr, device=dev)
    _, ys_cal, ev_cal, m0_cal, S0_cal, A_cal, Q_cal, x3_cal = multicam._prep_multicam_nonlinear(
        cal_t[..., 0], cal_t[..., 1], cal_t[..., 2], SEEDS_CAL, "median", "confidence_weighted_var", *cal_params)
    h_card = make_projection_from_camgroup(cal_group, device=dev)[0]
    h_cpu = make_projection_from_camgroup(cal_group, device="cpu")[0]
    h_64 = make_projection_from_camgroup(cal_group, device="cpu", dtype=torch.float64)[0]

    # where a calibrated iteration's time goes, and the warm-up of the timed
    # run below: the optimizer and final pass of the whole session capped,
    # once plain and once under the profiler (device activity only)
    ops_cal_all = (ys_cal, m0_cal, S0_cal, A_cal, A_cal, Q_cal, ev_cal.transpose(0, 1))

    # the operands the calibrated path gives the scan kernel (5 lanes), from
    # one Adam iteration of the whole session's optimizer (its three sweeps'
    # information-form planes and their tangents) and its final pass (the 13
    # relinearized covariance-form filter tables and the smoother's), each
    # held against the plain version, the last of each kind timed
    cal_calls = {"filter_prefix_paired": [], "filter_prefix": [], "smoother_suffix": []}
    with contextlib.ExitStack() as stack:
        for name, calls in cal_calls.items():
            stack.enter_context(recording(fused_filter, name, calls))
        run_kalman_smoother(*ops_cal_all, safety_cap=1, h_fn=h_card, x_init=x3_cal)
    cal_scans = {name: [scan_check("smoother" if name == "smoother_suffix" else "filter", *args,
                                   timed=i == len(calls) - 1) for i, args in enumerate(calls)]
                 for name, calls in cal_calls.items()}
    del cal_calls
    emit({"phase": "calibrated_scan_operands", "rtol": RTOL_SCAN_NEW,
          **{name: {"calls": len(res), "rel_err": [r["rel_err"] for r in res],
                    "rel_err_kernel_vs_f64_plain": [r["rel_err_kernel_vs_f64_plain"] for r in res],
                    "rel_err_plain_vs_f64_plain": [r["rel_err_plain_vs_f64_plain"] for r in res],
                    "timed": res[-1]} for name, res in cal_scans.items()}})
    if [len(v) for v in cal_scans.values()] != [3, 13, 1] or not all(r["ok"] for v in cal_scans.values() for r in v):
        raise AssertionError("a scan instance disagrees with its plain version on the calibrated path's operands")

    def capped_cal():
        tm_c = {}
        run_kalman_smoother(*ops_cal_all, safety_cap=CAP_CAL_PROF, h_fn=h_card, x_init=x3_cal, timings=tm_c)
        torch.cuda.synchronize()
        return tm_c

    t0 = time.perf_counter()
    tm_cc = capped_cal()
    capped_wall_cal = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        capped_cal()
        prof_wall = time.perf_counter() - t0
    emit({
        "phase": "multicam_calibrated_profile", "adam_iters": tm_cc.get("adam_iters"),
        "profiled_wall_s": prof_wall, "unprofiled_wall_s": capped_wall_cal,
        "unprofiled_optimizer_s": tm_cc.get("optimizer"), "unprofiled_final_pass_s": tm_cc.get("final_pass"),
        **device_profile(torch, prof, capped_wall_cal, tm_cc.get("adam_iters")),
    })

    (dfs_cal, s_cal, df3_cal), wall_cal, tm_cal, launches_cal = cal_run()
    iters_cal = tm_cal.get("adam_iters", 0)
    finite_cal = all(np.isfinite(d.to_numpy()).all() and d.shape == (T_CAL, K_CAL * 9) for d in dfs_cal) \
        and bool(np.isfinite(df3_cal.to_numpy()).all()) and bool(np.isfinite(s_cal).all())
    kernels_cal = (launches_cal["prefix_scan_filter_paired_d3"] == 3 * iters_cal > 0
                   and launches_cal["prefix_scan_filter_d3"] == 13 and launches_cal["prefix_scan_smoother_d3"] == 1
                   and launches_cal["plain_route"] == 0 and launches_cal["fused_nll_paired"] == 0)

    # the final pass against the float64 sequential EKF smoother
    d64 = dict(dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    ref_cal, _, filt_cal = seq_smoother_f64(
        torch, ys_cal.to(**d64), m0_cal.to(**d64), S0_cal.to(**d64), A_cal.to(**d64),
        torch.as_tensor(s_cal, **d64)[:, None, None] * Q_cal.to(**d64), None,
        torch.clamp(ev_cal, min=1e-12).to(**d64), h_fn=h_64, filtered=True)
    ref_cal_s = time.perf_counter() - t0
    xyz_got = df3_cal.to_numpy().reshape(T_CAL, K_CAL, 6)[..., :3]
    xyz_ref = ref_cal.transpose(0, 1).numpy()
    seq_gap_cal = float(np.abs(xyz_got - xyz_ref).max())
    pix_ref = h_64(ref_cal).numpy()  # (K, T, 2C)
    pix_gap_cal = max(float(np.abs(d.to_numpy().reshape(T_CAL, K_CAL, 9)[..., :2]
                                   - pix_ref[:, :, 2 * i:2 * i + 2].transpose(1, 0, 2)).max())
                      for i, d in enumerate(dfs_cal))
    # the control: how far a final pass that returned the filtered means
    # instead of the smoothed ones would be, in 3-D and in pixels
    ctl_cal = {"max_abs_err_3d": float((filt_cal - ref_cal).abs().max()),
               "max_abs_err_pixels": float((h_64(filt_cal) - h_64(ref_cal)).abs().max())}

    # s on two keypoints, on the card and through the plain versions on the
    # CPU, capped, from the same operands: the stop rule off (trajectory
    # against trajectory), and on (each lane against the CPU's trajectory at
    # the iteration where it stopped on the card)
    def cal_opt(h):
        def run(ops, tol, cap):
            ys_o, m0_o, S0_o, A_o, Q_o, ev_o, x_o = ops
            g = core._device_s_guesses(ev_o)
            guess = torch.where(torch.isfinite(g) & (g > 0.0), g, torch.full_like(g, 2.0))
            return core.optimize_smooth_param(ys_o, m0_o, S0_o, A_o, A_o, Q_o, ev_o, None, None, guess,
                                              tol=tol, safety_cap=cap, h_fn=h, x_init=x_o).cpu().numpy()
        return run

    sub = slice(0, CAL_CHECK_LANES)
    ops_cal = (ys_cal[sub], m0_cal[sub], S0_cal[sub], A_cal[sub], Q_cal[sub], ev_cal[sub].transpose(0, 1),
               x3_cal[sub])
    ops_cal_cpu = tuple(x.cpu() for x in ops_cal)
    traj_card = capped_opt(ops_cal, -1.0, CAP_CAL, cal_opt(h_card))
    traj_cpu = {CAP_CAL: capped_opt(ops_cal_cpu, -1.0, CAP_CAL, cal_opt(h_cpu))}
    s_gap_cal = float(s_gap(traj_card[0], traj_cpu[CAP_CAL][0]).max())
    stop_card = capped_opt(ops_cal, 1e-2, CAP_CAL, cal_opt(h_card))
    at_stop = np.empty(CAL_CHECK_LANES)
    for c in sorted(set(stop_card[1].tolist())):
        if c not in traj_cpu:
            traj_cpu[c] = capped_opt(ops_cal_cpu, -1.0, c, cal_opt(h_cpu))
        at_stop[stop_card[1] == c] = traj_cpu[c][0][stop_card[1] == c]
    s_gap_stop_cal = float(s_gap(stop_card[0], at_stop).max())
    emit({
        "phase": "multicam_calibrated_auto_s", "frames": T_CAL, "keypoints": K_CAL, "cameras": CAMS_CAL,
        "seeds": SEEDS_CAL, "wall_s": wall_cal, "prep_s": tm_cal.get("prep"),
        "optimizer_s": tm_cal.get("optimizer"), "final_pass_s": tm_cal.get("final_pass"),
        "package_s": tm_cal.get("package"), "adam_iters": iters_cal,
        "us_per_adam_iter": tm_cal["optimizer"] / iters_cal * 1e6 if iters_cal else None,
        "s_min": float(np.min(s_cal)), "s_median": float(np.median(s_cal)), "s_max": float(np.max(s_cal)),
        "finite": bool(finite_cal), "launches": {k: v for k, v in launches_cal.items() if v},
        "paired_filter_d3_per_adam_iter": launches_cal["prefix_scan_filter_paired_d3"] / iters_cal if iters_cal else None,
        "kernels_ran": bool(kernels_cal), "max_abs_err_3d_vs_f64_sequential_ekf": seq_gap_cal,
        "seq_atol_3d": SEQ_ATOL_CAL_3D, "max_abs_err_pixels_vs_f64_sequential_ekf": pix_gap_cal,
        "seq_atol_pixels": SEQ_ATOL_CAL_PX, "control_filtered_vs_f64_smoothed": ctl_cal,
        "f64_sequential_ekf_s": ref_cal_s,
        "capped_iters": CAP_CAL, "capped_lanes": CAL_CHECK_LANES, "s_rtol": 5e-4,
        "s_rel_gap_card_vs_cpu_plain_capped": s_gap_cal, "cpu_plain_capped_s": traj_cpu[CAP_CAL][2],
        "with_stop_rule": {"s_rel_gap_card_vs_cpu_trajectory_at_card_stop": s_gap_stop_cal,
                           "lane_iters_card": stop_card[1].tolist()},
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    if not finite_cal:
        raise AssertionError("calibrated output is not finite or has the wrong shape")
    if not kernels_cal:
        raise AssertionError(f"the calibrated path did not run through its kernels as expected: {launches_cal}")
    if seq_gap_cal > SEQ_ATOL_CAL_3D or pix_gap_cal > SEQ_ATOL_CAL_PX:
        raise AssertionError(f"calibrated final pass is {seq_gap_cal} (3-D), {pix_gap_cal} (pixels) from the "
                             "float64 sequential EKF smoother")
    if s_gap_cal > 5e-4 or s_gap_stop_cal > 5e-4:
        raise AssertionError(f"calibrated s on the card is off the CPU's plain path: {s_gap_cal}, {s_gap_stop_cal}")

    # --------------------------------------------------------------- 21 ---
    cli_phase(torch, np, pd, card, reset_counts, read_counts, a_key, golden_gap)

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
    plan_a = fused_nll.nll_plan(N, T, dev)
    det_a = (deterministic(lambda: fused_nll.fused_nll(table, y_pl), ll_k)
             and deterministic(lambda: torch.stack(fused_nll.fused_nll_paired(table, dtable, y_pl)),
                               torch.stack((pll_k, dll_k))))
    ok_a = max(r_ll, r_pll, r_dll) <= RTOL_NLL and bool(torch.isfinite(dll_k).all()) and det_a
    # the optimizer's per-iteration plain PyTorch work beside the kernel:
    # the scalar table and its tangent d(table)/d(log s)
    ms_pack = time_cuda(torch, lambda: torch.func.jvp(pack, (s_log,), (torch.ones_like(s_log),)), 20)
    ms_a = time_cuda(torch, lambda: fused_nll.fused_nll(table, y_pl), 50)
    ms_ap = time_cuda(torch, lambda: fused_nll.fused_nll_paired(table, dtable, y_pl), 50)
    dev_a, _ = device_ms(torch, lambda: fused_nll.fused_nll(table, y_pl), 20)
    dev_ap, dev_ap_by_kernel = device_ms(torch, lambda: fused_nll.fused_nll_paired(table, dtable, y_pl), 20)
    enq_ap = enqueue_ms(torch, lambda: fused_nll.fused_nll_paired(table, dtable, y_pl), 50)
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
        "device_ms": dev_a, "paired_device_ms": dev_ap, "paired_device_ms_by_kernel": dev_ap_by_kernel,
        "paired_enqueue_ms": enq_ap,
        "bound_ms": b_a[0], "bound_by": b_a[1], "paired_bound_ms": b_ap[0],
        "paired_bound_by": b_ap[1], "segments_G": plan_a["G"], "threads": plan_a["threads"],
        "deterministic": det_a, "ptxas": nll_ptxas(D, O), "ok": ok_a,
        "launches": {k: v for k, v in read_counts().items() if k in ("fused_nll", "fused_nll_paired")},
    })
    if not ok_a:
        raise AssertionError("kernel A disagrees with its plain version or is not deterministic")

    # ---------------------------------------------------------------- 3 ---
    planes = pkalman._make_filter_elements(ys_t, m0_t, S0_t, A_t, Q_t, C_t, rtv_t)
    out_k = fused_filter.filter_prefix(planes)
    out_p = fused_filter.filter_prefix_plain(planes)
    torch.cuda.synchronize()
    e_b, r_b = rel_err(out_k, out_p)
    ok_b = r_b <= RTOL_SCAN and bool(torch.isfinite(out_k).all())
    ms_b = time_cuda(torch, lambda: fused_filter.filter_prefix(planes), 50)
    ms_b_plain = time_cuda(torch, lambda: fused_filter.filter_prefix_plain(planes), 3)
    b_b = bound_ms(2 * planes.numel() * 4, scan_ops(N, T, D))
    det_b = deterministic(lambda: fused_filter.filter_prefix(planes), out_k)
    dev_b = device_ms(torch, lambda: fused_filter.filter_prefix(planes), 20)[0]
    emit({
        "phase": "kernel_B", "N": N, "P": planes.shape[1], "T": T, "rtol": RTOL_SCAN,
        "max_abs_err": e_b, "rel_err": r_b, "ms": ms_b, "device_ms": dev_b, "plain_ms": ms_b_plain,
        "bound_ms": b_b[0], "ok": ok_b, "launches": {"prefix_scan_filter": tracing.launches("scan")},
        "segments_G": fused_filter.scan_plan(N, T, "filter", False, D, dev)["G"],
        "threads": fused_filter.scan_plan(N, T, "filter", False, D, dev)["threads"], "deterministic": det_b,
    })
    if not (ok_b and det_b):
        raise AssertionError("kernel B disagrees with its plain version or is not deterministic")

    # --------------------------------------------------------------- 3b ---
    # kernel B at D = 3, on the pupil final pass's own elements: the eight
    # sessions of phases 8-9 at the optimizer's starting parameters
    prng = np.random.default_rng(0)
    pupil_mas = [MarkerArray(make_pupil_session(np, prng), data_fields=fields) for _ in range(N_SESSIONS)]
    names = ibl_pupil.BODYPART_LIST
    preps = [ibl_pupil._pupil_prep(ma, names, "median", "confidence_weighted_var") for ma in pupil_mas]

    def pupil_operands(n):
        """Device tensors of the first n sessions: y, r (n, T, 8), m0, S0,
        the shared C, and the three variance scales (n,)."""
        cols = list(zip(*preps[:n]))
        return ibl_pupil._tensors(
            dev, np.stack(cols[3]), np.clip(np.stack(cols[1]), 1e-12, None), np.stack(cols[4]),
            np.stack(cols[5]), ibl_pupil.PUPIL_C, cols[8], cols[9], cols[10],
        )

    b3, sm_pupil = {}, {}
    for n in (1, N_SESSIONS):
        y_p, r_p, m0_p, S0_p, C_p, dv, xv, yv = pupil_operands(n)
        s_start = torch.tensor([0.99, 0.98], device=dev).expand(n, 2)
        A_p, Q_p = ibl_pupil._pupil_model(s_start[:, 0], s_start[:, 1], dv, xv, yv)
        planes3 = pkalman._make_filter_elements(y_p, m0_p, S0_p, A_p, Q_p, C_p.expand(n, 8, 3), r_p)
        out_k = fused_filter.filter_prefix(planes3)
        out_p = fused_filter.filter_prefix_plain(planes3)
        torch.cuda.synchronize()
        e3, r3 = rel_err(out_k, out_p)
        out_64 = fused_filter.filter_prefix_plain(planes3.double())
        bound3 = bound_ms(2 * planes3.numel() * 4, scan_ops(n, T_PUPIL, 3))
        plan3 = fused_filter.scan_plan(n, T_PUPIL, "filter", False, 3, dev)
        b3[n] = {
            "segments_G": plan3["G"], "threads": plan3["threads"],
            "deterministic": deterministic(lambda: fused_filter.filter_prefix(planes3), out_k),
            "max_abs_err": e3, "rel_err": r3,
            "rel_err_kernel_vs_f64_plain": rel_err(out_k.double(), out_64)[1],
            "rel_err_plain_vs_f64_plain": rel_err(out_p.double(), out_64)[1],
            "ms": time_cuda(torch, lambda: fused_filter.filter_prefix(planes3), 50),
            "device_ms": device_ms(torch, lambda: fused_filter.filter_prefix(planes3), 20)[0],
            "plain_ms": time_cuda(torch, lambda: fused_filter.filter_prefix_plain(planes3), 3),
            "bound_ms": bound3[0], "bound_by": bound3[1],
            "ok": r3 <= RTOL_SCAN_D3 and bool(torch.isfinite(out_k).all()),
        }
        b3[n]["ok"] = b3[n]["ok"] and b3[n]["deterministic"]
        # and the smoother instance on the same final pass's elements
        fr_p = pkalman.kalman_filter_parallel(y_p, m0_p, S0_p, A_p, Q_p, C_p.expand(n, 8, 3), r_p,
                                              compute_ll=False)
        sm_pupil[n] = scan_check(
            "smoother", pkalman._make_smoother_elements(fr_p.filtered_means, fr_p.filtered_covs, A_p, Q_p))
        if n == 1:
            # the paired smoother, which no path runs, at the pupil final
            # pass's shape: tangent along the log of Q's scale
            sm_pupil_paired = scan_check("smoother", *along_log_s(
                lambda sl: pkalman._make_smoother_elements(
                    fr_p.filtered_means, fr_p.filtered_covs, A_p, torch.exp(sl)[:, None, None] * Q_p), n))
    emit({"phase": "kernel_B_d3", "P": 33, "T": T_PUPIL, "rtol": RTOL_SCAN_D3,
          "lanes": {str(n): v for n, v in b3.items()},
          "smoother_lanes": {str(n): v for n, v in sm_pupil.items()},
          "smoother_paired_1_lane": sm_pupil_paired,
          "launches": {"prefix_scan_filter_d3": tracing.launches("scan", "filter", False, 3)}})
    if not all(v["ok"] for v in list(b3.values()) + list(sm_pupil.values()) + [sm_pupil_paired]):
        raise AssertionError("kernel B at D = 3 disagrees with its plain version")

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
    reset_counts()
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df, s_finals = eks_tpu_torch.ensemble_kalman_smoother_singlecam(
        ma, kps, device="cuda", timings=timings
    )
    wall = time.perf_counter() - t0
    launches = read_counts()
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
    if min(launches["fused_nll_paired"], launches["prefix_scan_filter"], launches["prefix_scan_smoother"]) <= 0:
        raise AssertionError(f"the main path did not run through its three kernels: {launches}")
    if seq_gap > 1e-2:
        raise AssertionError(f"final pass is {seq_gap} from the float64 sequential smoother")

    # --------------------------------------------------------------- 5b ---
    # where the headline run's time goes: the same run once more under the
    # profiler (device activity only), for the device's busy time and what
    # runs on it. The profiler slows the host, so the idle share is taken
    # against the unprofiled wall of phase 5, on the same inputs.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eks_tpu_torch.ensemble_kalman_smoother_singlecam(ma, kps, device="cuda")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    emit({
        "phase": "headline_profile", "profiled_wall_s": prof_wall, "unprofiled_wall_s": wall,
        **device_profile(torch, prof, wall, iters),
    })

    # ---------------------------------------------------------------- 6 ---
    # kernel C on the pupil optimizer's own operands at its starting
    # parameters: one session (2 lanes) and eight (16 lanes)
    c_res = {}
    for n in (1, N_SESSIONS):
        y_p, r_p, m0_p, S0_p, C_p, dv, xv, yv = pupil_operands(n)
        yr, tables, tangents = ibl_pupil._pupil_lanes(y_p, r_p, m0_p, S0_p, C_p, dv, xv, yv)
        U = ibl_pupil._rep2(ibl_pupil._initial_u(n, dev))

        def pack_tv():
            return torch.func.jvp(tables, (U,), (tangents,))

        tab_c, dtab_c = (x.contiguous() for x in pack_tv())
        cll_k = fused_nll.fused_nll_tv(tab_c, yr)
        cll_p = fused_nll._fused_nll_tv_plain(tab_c, yr)
        cpll_k, cdll_k = fused_nll.fused_nll_tv_paired(tab_c, dtab_c, yr)
        cpll_p, cdll_p = fused_nll._fused_nll_tv_paired_plain(tab_c, dtab_c, yr)
        torch.cuda.synchronize()
        ce_ll, cr_ll = rel_err(cll_k, cll_p)
        ce_pll, cr_pll = rel_err(cpll_k, cpll_p)
        ce_dll, cr_dll = rel_err(cdll_k, cdll_p)
        ll_64 = fused_nll._fused_nll_tv_plain(tab_c.double(), yr.double())
        L = 2 * n
        in_bytes = (yr.numel() + tab_c.numel()) * 4
        bound_c = bound_ms(in_bytes + L * 4, nll_ops(L, T_PUPIL, 3, 8, False))
        bound_cp = bound_ms(in_bytes + tab_c.numel() * 4 + 2 * L * 4, nll_ops(L, T_PUPIL, 3, 8, True))
        plan_c = fused_nll.tv_plan(L, T_PUPIL, dev)
        det_c = (deterministic(lambda: fused_nll.fused_nll_tv(tab_c, yr), cll_k)
                 and deterministic(lambda: torch.stack(fused_nll.fused_nll_tv_paired(tab_c, dtab_c, yr)),
                                   torch.stack((cpll_k, cdll_k))))
        c_res[n] = {
            "lanes": L, "segments_G": plan_c["G"], "threads": plan_c["threads"], "deterministic": det_c,
            "ll_max_abs_err": ce_ll, "ll_rel_err": cr_ll,
            "ll_rel_err_kernel_vs_f64_plain": rel_err(cll_k.double(), ll_64)[1],
            "ll_rel_err_plain_vs_f64_plain": rel_err(cll_p.double(), ll_64)[1],
            "paired_ll_max_abs_err": ce_pll, "paired_ll_rel_err": cr_pll,
            "paired_dll_max_abs_err": ce_dll, "paired_dll_rel_err": cr_dll,
            "ms": time_cuda(torch, lambda: fused_nll.fused_nll_tv(tab_c, yr), 30),
            "plain_ms": time_cuda(torch, lambda: fused_nll._fused_nll_tv_plain(tab_c, yr), 2),
            "paired_ms": time_cuda(torch, lambda: fused_nll.fused_nll_tv_paired(tab_c, dtab_c, yr), 30),
            "paired_enqueue_ms": enqueue_ms(
                torch, lambda: fused_nll.fused_nll_tv_paired(tab_c, dtab_c, yr), 30),
            "device_ms": device_ms(torch, lambda: fused_nll.fused_nll_tv(tab_c, yr), 20)[0],
            "paired_device_ms_by_kernel": device_ms(
                torch, lambda: fused_nll.fused_nll_tv_paired(tab_c, dtab_c, yr), 20)[1],
            "paired_plain_ms": time_cuda(
                torch, lambda: fused_nll._fused_nll_tv_paired_plain(tab_c, dtab_c, yr), 1),
            "pack_jvp_ms": time_cuda(torch, pack_tv, 20),
            "bound_ms": bound_c[0], "bound_by": bound_c[1],
            "paired_bound_ms": bound_cp[0], "paired_bound_by": bound_cp[1],
            "ok": det_c and max(cr_ll, cr_pll, cr_dll) <= RTOL_NLL_TV and bool(torch.isfinite(cdll_k).all()),
        }
    # noise variances clipped to 1e-12, as the pupil path clips an ensemble
    # variance of zero: sessions 4-7 get 30 such entries each, which puts
    # 1/r = 1e12 into their information-form elements. Every lane is held to
    # the same limit, and the two must be finite on the same lanes
    r_c = r_p.clone()
    r_c[N_SESSIONS // 2:, 100::997, ::3] = 1e-12
    yr_c, _, _ = ibl_pupil._pupil_lanes(y_p, r_c, m0_p, S0_p, C_p, dv, xv, yv)
    cl_k, cd_k = fused_nll.fused_nll_tv_paired(tab_c, dtab_c, yr_c)
    cl_p, cd_p = fused_nll._fused_nll_tv_paired_plain(tab_c, dtab_c, yr_c)
    torch.cuda.synchronize()
    e_c, r_cl, same_l = lane_errs(cl_k, cl_p)
    e_cd, r_cd, same_d = lane_errs(cd_k, cd_p)
    clipped = {
        "clipped_entries_per_lane": int((r_c[-1] == 1e-12).sum()), "lanes_with_clipped_entries": N_SESSIONS,
        "finite_lanes_kernel": int(torch.isfinite(cl_k).sum()),
        "finite_lanes_plain": int(torch.isfinite(cl_p).sum()),
        "ll_max_abs_err": e_c, "ll_rel_err": r_cl, "dll_max_abs_err": e_cd, "dll_rel_err": r_cd,
        "ok": same_l and same_d and max(r_cl, r_cd) <= RTOL_NLL_TV,
    }
    emit({"phase": "kernel_C", "T": T_PUPIL, "D": 3, "O": 8, "rtol": RTOL_NLL_TV, "sessions": {str(n): v for n, v in c_res.items()},
          "clipped": clipped,
          "launches": {"fused_nll_tv": tracing.launches("C", False),
                       "fused_nll_tv_paired": tracing.launches("C", True)}})
    if not (all(v["ok"] for v in c_res.values()) and clipped["ok"]):
        raise AssertionError("kernel C disagrees with its plain version or is not deterministic")

    # ---------------------------------------------------------------- 7 ---
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        df, s_fixed, _, _ = eks_tpu_torch.fit_eks_pupil(
            os.path.join(REPO, "data", "pupil"), os.path.join(tmp, "out.csv"),
            smooth_params=[0.99, 0.98], device="cuda",
        )
        wall = time.perf_counter() - t0
    ref = pd.read_csv(
        os.path.join(REPO, "tests", "integration", "golden", "pupil_fixed.csv"),
        header=[0, 1, 2], index_col=0,
    )
    same_cols = [tuple(map(str, c)) for c in df.columns] == [tuple(map(str, c)) for c in ref.columns]
    gap = float(np.abs(df.to_numpy() - ref.to_numpy()).max()) if df.shape == ref.shape else math.inf
    emit({"phase": "golden_pupil_fixed", "shape": list(df.shape), "max_abs_err": gap,
          "atol": 1e-4, "columns_match": same_cols, "s": s_fixed, "wall_s": wall})
    if not (same_cols and gap <= 1e-4):
        raise AssertionError("pupil_fixed golden mismatch")

    # --------------------------------------------------------------- 7b ---
    # the same session with both parameters tuned, against the JAX package's
    # committed output: two gradient implementations drift apart at float32
    # level over thousands of Adam steps, and the diameter's sensitivity to
    # s_diam near 1 amplifies that, hence the family's 1e-2 on the table
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        df, s_auto, _, _ = eks_tpu_torch.fit_eks_pupil(
            os.path.join(REPO, "data", "pupil"), os.path.join(tmp, "out.csv"), device="cuda",
        )
        wall = time.perf_counter() - t0
    ref = pd.read_csv(
        os.path.join(REPO, "tests", "integration", "golden", "pupil_auto.csv"),
        header=[0, 1, 2], index_col=0,
    )
    gap = float(np.abs(df.to_numpy() - ref.to_numpy()).max()) if df.shape == ref.shape else math.inf
    emit({"phase": "golden_pupil_auto", "shape": list(df.shape), "max_abs_err": gap,
          "atol": 1e-2, "s": s_auto, "wall_s": wall})
    if not gap <= 1e-2:
        raise AssertionError("pupil_auto golden mismatch")

    # ---------------------------------------------------------------- 8 ---
    def pupil_solo(i):
        """Session i alone through the entry point, with the counts read
        around it: (df, [s_diam, s_com], wall, timings, launches)."""
        reset_counts()
        tm = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df_i, s_i = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
            pupil_mas[i], names, device="cuda", timings=tm
        )
        return df_i, s_i, time.perf_counter() - t0, tm, read_counts()

    # warm-up: three Adam iterations and the final pass at the same shapes
    eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(pupil_mas[0], names, safety_cap=3, device="cuda")
    df, s_solo, wall_solo, tm, launches_pupil = pupil_solo(0)
    solo = {0: (s_solo, wall_solo)}
    iters_pupil = tm.get("adam_iters", 0)
    finite = bool(np.isfinite(df.to_numpy()).all()) and bool(np.isfinite(s_solo).all())

    # the final pass against the float64 sequential smoother at these
    # parameters, through the same packaging
    (preds0, vars0, likes0, yobs0, m00, S00, mx0, my0, dv0, xv0, yv0) = preps[0]
    d64 = dict(dtype=torch.float64, device="cpu")

    def t64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), **d64)

    A64, Q64 = ibl_pupil._pupil_model(t64([s_solo[0]]), t64([s_solo[1]]), t64([dv0]), t64([xv0]), t64([yv0]))
    t0 = time.perf_counter()
    ref_m, ref_P = seq_smoother_f64(torch, t64(yobs0)[None], t64(m00)[None], t64(S00)[None], A64, Q64,
                                    t64(ibl_pupil.PUPIL_C)[None], t64(np.clip(vars0, 1e-12, None))[None])
    ref_s = time.perf_counter() - t0
    df_ref = ibl_pupil._pupil_package(names, ref_m[0].numpy(), ref_P[0].numpy(), preds0, vars0, likes0, mx0, my0)
    xy = [c for c in df.columns if c[2] in ("x", "y")]
    seq_gap = float(np.abs(df[xy].to_numpy() - df_ref[xy].to_numpy()).max())
    emit({
        "phase": "pupil_auto_s", "frames": T_PUPIL, "seeds": SEEDS_PUPIL,
        "wall_s": wall_solo, "prep_s": tm.get("prep"), "optimizer_s": tm.get("optimizer"),
        "final_pass_s": tm.get("final_pass"), "package_s": tm.get("package"),
        "adam_iters": iters_pupil,
        "us_per_adam_iter": tm["optimizer"] / iters_pupil * 1e6 if iters_pupil else None,
        "s_diam_s_com": s_solo, "finite": finite, "shape": list(df.shape),
        "launches": launches_pupil, "max_abs_err_vs_f64_sequential": seq_gap,
        "f64_sequential_s": ref_s, "card": card,
    })
    if not finite or df.shape != (T_PUPIL, 4 * 9):
        raise AssertionError("pupil output is not finite or has the wrong shape")
    if min(launches_pupil["fused_nll_tv_paired"], launches_pupil["prefix_scan_filter_d3"],
           launches_pupil["prefix_scan_smoother_d3"]) <= 0:
        raise AssertionError(f"the pupil path did not run through its three kernels: {launches_pupil}")
    if seq_gap > 1e-2:
        raise AssertionError(f"pupil final pass is {seq_gap} from the float64 sequential smoother")

    # --------------------------------------------------------------- 8b ---
    # where a pupil iteration's time goes: the same session with the
    # optimizer capped at 200 iterations, once plain and once under the
    # profiler (device activity only); the idle share is taken against the
    # unprofiled wall
    cap = 200

    def capped():
        tm_c = {}
        eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
            pupil_mas[0], names, safety_cap=cap, device="cuda", timings=tm_c
        )
        torch.cuda.synchronize()
        return tm_c

    t0 = time.perf_counter()
    tm_c = capped()
    capped_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        capped()
        prof_wall = time.perf_counter() - t0
    emit({
        "phase": "pupil_profile", "adam_iters": cap, "profiled_wall_s": prof_wall,
        "unprofiled_wall_s": capped_wall, "unprofiled_optimizer_s": tm_c.get("optimizer"),
        **device_profile(torch, prof, capped_wall, cap),
    })

    # ---------------------------------------------------------------- 9 ---
    reset_counts()
    tm_s = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil_sessions(
        pupil_mas, device="cuda", timings=tm_s
    )
    wall_sessions = time.perf_counter() - t0
    launches_sessions = read_counts()
    for i in range(1, N_SOLO_CHECKED):
        _, s_i, wall_i, _, _ = pupil_solo(i)
        solo[i] = (s_i, wall_i)
    s_gaps = {i: float(np.abs(np.asarray(batched[i][1]) - np.asarray(s_i)).max())
              for i, (s_i, _) in solo.items()}
    finite_s = all(np.isfinite(df_i.to_numpy()).all() and df_i.shape == (T_PUPIL, 36)
                   for df_i, _ in batched)
    iters_s = tm_s.get("adam_iters", 0)
    emit({
        "phase": "pupil_sessions", "sessions": N_SESSIONS, "frames": T_PUPIL,
        "wall_s": wall_sessions, "solo_wall_s_times_sessions": N_SESSIONS * wall_solo,
        "prep_s": tm_s.get("prep"), "optimizer_s": tm_s.get("optimizer"),
        "final_pass_s": tm_s.get("final_pass"), "package_s": tm_s.get("package"),
        "adam_iters": iters_s,
        "us_per_adam_iter": tm_s["optimizer"] / iters_s * 1e6 if iters_s else None,
        "s_diam_s_com": [s for _, s in batched], "finite": bool(finite_s),
        "sessions_checked_against_solo": sorted(solo), "s_max_abs_gap_vs_solo": s_gaps,
        "s_atol": 5e-4, "solo_walls_s": {i: w for i, (_, w) in solo.items()},
        "launches": launches_sessions,
    })
    if not finite_s:
        raise AssertionError("a session's output is not finite or has the wrong shape")
    if min(launches_sessions["fused_nll_tv_paired"], launches_sessions["prefix_scan_filter_d3"],
           launches_sessions["prefix_scan_smoother_d3"]) <= 0:
        raise AssertionError(f"the sessions path did not run through its three kernels: {launches_sessions}")
    if max(s_gaps.values()) > 5e-4:
        raise AssertionError(f"sessions parameters differ from the solo runs: {s_gaps}")

    # --------------------------------------------------------------- 11 ---
    # the other instances of the scan kernel. Operands: the headline lanes of
    # phase 2 (D = 2), and the multi-camera sessions' own prep (D = 3)
    mc_arr = {c: make_multicam_session(np, np.random.default_rng(0), c) for c in (CAMS_MC, CAMS_MC_WIDE)}
    mc_names = [f"kp{i}" for i in range(K_MC)]

    def mc_prep(c, n_latent=3):
        """(stats, ys, evars, m0s, S0s, As, Qs, Cs, means) of the c-camera
        session at ``n_latent``, on the card."""
        if c not in mc_arr:
            mc_arr[c] = make_multicam_session(np, np.random.default_rng(0), c)
        t = torch.as_tensor(mc_arr[c], device=dev)
        return multicam._prep_multicam_linear(
            t[..., 0], t[..., 1], t[..., 2], SEEDS_MC, "median", "confidence_weighted_var", n_latent, 50.0)

    def mc_optimizer_operands(c, n_latent=3):
        """The c-camera optimizer's first iteration at ``n_latent``: scalar
        table, its tangent in log s, the observation planes, and the starting
        log s."""
        from eks_tpu_torch.core import _device_constant_r, _device_s_guesses

        _, ys_c, ev_c, m0_c, S0_c, A_c, Q_c, C_c, _ = mc_prep(c, n_latent)
        g = _device_s_guesses(ev_c.transpose(0, 1))
        sl0 = torch.log(torch.clamp(torch.where(torch.isfinite(g) & (g > 0), g, torch.full_like(g, 2.0)), 1e-6, 1e3))
        r_c = _device_constant_r(ev_c, 1e-4)

        def pack_c(sl):
            return pkalman._pack_scalars(ys_c[:, 0], m0_c, S0_c, A_c, torch.exp(sl)[:, None, None] * Q_c, C_c, r_c)

        tab, dtab = torch.func.jvp(pack_c, (sl0,), (torch.ones_like(sl0),))
        return tab.contiguous(), dtab.contiguous(), ys_c.transpose(1, 2).contiguous(), sl0, pack_c

    # smoother at D = 2: the headline final pass's shape (20 lanes)
    fr2 = pkalman.kalman_filter_parallel(ys_t, m0_t, S0_t, A_t, Q_t, C_t, rtv_t, compute_ll=False)
    sm2 = scan_check("smoother", pkalman._make_smoother_elements(fr2.filtered_means, fr2.filtered_covs, A_t, Q_t))
    # smoother at D = 3: the two-camera final pass's shape (10 lanes)
    _, ys_m, ev_m, m0_m, S0_m, A_m, Q_m, C_m, _ = mc_prep(CAMS_MC)
    tab_m, dtab_m, y_m_pl, sl0_m, pack_m = mc_optimizer_operands(CAMS_MC)
    sQ_m = torch.exp(sl0_m)[:, None, None] * Q_m
    fr3 = pkalman.kalman_filter_parallel(ys_m, m0_m, S0_m, A_m, sQ_m, C_m, torch.clamp(ev_m, min=1e-12),
                                         compute_ll=False)
    sm3 = scan_check("smoother", pkalman._make_smoother_elements(fr3.filtered_means, fr3.filtered_covs, A_m, sQ_m))
    # the float filter scan at D = 3 on the multi-camera final passes' own
    # elements (10 lanes; 4 and 12 observations), and the smoother on the
    # six-camera ones
    ff3 = scan_check("filter", pkalman._make_filter_elements(
        ys_m, m0_m, S0_m, A_m, sQ_m, C_m, torch.clamp(ev_m, min=1e-12)))
    _, ys_w, ev_w, m0_w, S0_w, A_w, Q_w, C_w, _ = mc_prep(CAMS_MC_WIDE)
    # paired lane-batched filter scan at D = 3: the six-camera optimizer's
    # element planes and their tangent in log s (10 lanes)
    tab_w, dtab_w, y_w_pl, sl0_w, _ = mc_optimizer_operands(CAMS_MC_WIDE)
    sQ_w = torch.exp(sl0_w)[:, None, None] * Q_w
    r_w = torch.clamp(ev_w, min=1e-12)
    ff3_w = scan_check("filter", pkalman._make_filter_elements(ys_w, m0_w, S0_w, A_w, sQ_w, C_w, r_w))
    fr3_w = pkalman.kalman_filter_parallel(ys_w, m0_w, S0_w, A_w, sQ_w, C_w, r_w, compute_ll=False)
    sm3_w = scan_check("smoother", pkalman._make_smoother_elements(
        fr3_w.filtered_means, fr3_w.filtered_covs, A_w, sQ_w))
    rows_w, drows_w = torch.func.jvp(lambda tab: pkalman._table_planes(tab, y_w_pl, 3), (tab_w,), (dtab_w,))
    fp3 = scan_check("filter", rows_w.contiguous(), drows_w.contiguous())
    # the paired instances no path runs, at the final passes' shapes, with
    # tangents along the log of Q's scale: the filter and the smoother at
    # D = 2 on the headline's elements (20 lanes), the smoother at D = 3 on
    # the two-camera ones (10 lanes); the one-lane pupil one is in phase 3b
    fp2 = scan_check("filter", *along_log_s(lambda sl: pkalman._make_filter_elements(
        ys_t, m0_t, S0_t, A_t, torch.exp(sl)[:, None, None] * Q_t, C_t, rtv_t), K_HEAD))
    sp2 = scan_check("smoother", *along_log_s(lambda sl: pkalman._make_smoother_elements(
        fr2.filtered_means, fr2.filtered_covs, A_t, torch.exp(sl)[:, None, None] * Q_t), K_HEAD))
    sp3 = scan_check("smoother", *along_log_s(lambda sl: pkalman._make_smoother_elements(
        fr3.filtered_means, fr3.filtered_covs, A_m, torch.exp(sl)[:, None, None] * sQ_m), K_MC))
    # and the staged loss around it against the same on the plain scan
    sll_k, sdll_k = pkalman._staged_nll_paired(tab_w, dtab_w, y_w_pl)
    sll_p, sdll_p = fused_nll._fused_nll_paired_plain(tab_w, dtab_w, y_w_pl)
    _, sdll_64 = fused_nll._fused_nll_paired_plain(tab_w.double(), dtab_w.double(), y_w_pl.double())
    torch.cuda.synchronize()
    staged = {
        "ll_rtol": RTOL_NLL_TV, "dll_rtol": RTOL_DLL_MC[CAMS_MC_WIDE], "dll_gap_factor": DLL_GAP_FACTOR,
        "ll_rel_err": rel_err(sll_k, sll_p)[1], "dll_rel_err": rel_err(sdll_k, sdll_p)[1],
        "dll_rel_err_kernel_vs_f64_plain": rel_err(sdll_k.double(), sdll_64)[1],
        "dll_rel_err_plain_vs_f64_plain": rel_err(sdll_p.double(), sdll_64)[1],
        "ms": time_cuda(torch, lambda: pkalman._staged_nll_paired(tab_w, dtab_w, y_w_pl), 5),
    }
    staged["ok"] = (staged["ll_rel_err"] <= RTOL_NLL_TV
                    and dll_ok(CAMS_MC_WIDE, staged["dll_rel_err_kernel_vs_f64_plain"],
                               staged["dll_rel_err_plain_vs_f64_plain"], staged["dll_rel_err"])
                    and bool(torch.isfinite(sdll_k).all()))
    scans = {"smoother_d2": sm2, "smoother_d3": sm3, "filter_d3_two_cameras": ff3,
             "filter_d3_six_cameras": ff3_w, "smoother_d3_six_cameras": sm3_w, "filter_paired_d3": fp3,
             "filter_paired_d2_headline": fp2, "smoother_paired_d2_headline": sp2,
             "smoother_paired_d3_two_cameras": sp3}
    emit({"phase": "scan_instances", "rtol": RTOL_SCAN_NEW, **scans, "staged_nll_paired_o12": staged,
          "smoother_kernel_vs_plain_reverse_scan": {
              "d2_kernel_ms": sm2["ms"], "d2_plain_ms": sm2["plain_ms"],
              "d3_kernel_ms": sm3["ms"], "d3_plain_ms": sm3["plain_ms"]}})
    if not (all(v["ok"] for v in scans.values()) and staged["ok"]):
        raise AssertionError("a scan instance disagrees with its plain version or is not deterministic")

    # --------------------------------------------------------------- 12 ---
    # kernel A at (D, O) = (3, 4): the two-camera optimizer's first iteration
    all_k = fused_nll.fused_nll(tab_m, y_m_pl)
    all_p = fused_nll._fused_nll_plain(tab_m, y_m_pl)
    apl_k, adl_k = fused_nll.fused_nll_paired(tab_m, dtab_m, y_m_pl)
    apl_p, adl_p = fused_nll._fused_nll_paired_plain(tab_m, dtab_m, y_m_pl)
    torch.cuda.synchronize()
    ea_ll, ra_ll = rel_err(all_k, all_p)
    ea_pll, ra_pll = rel_err(apl_k, apl_p)
    ea_dll, ra_dll = rel_err(adl_k, adl_p)
    ll_64, dll_64 = fused_nll._fused_nll_paired_plain(tab_m.double(), dtab_m.double(), y_m_pl.double())
    det_a3 = (deterministic(lambda: fused_nll.fused_nll(tab_m, y_m_pl), all_k)
              and deterministic(lambda: torch.stack(fused_nll.fused_nll_paired(tab_m, dtab_m, y_m_pl)),
                                torch.stack((apl_k, adl_k))))
    plan_a3 = fused_nll.nll_plan(K_MC, T_MC, dev)
    in_bytes_m = (y_m_pl.numel() + tab_m.numel()) * 4
    b_a3 = bound_ms(in_bytes_m + K_MC * 4, nll_ops(K_MC, T_MC, 3, 4, False))
    b_a3p = bound_ms(in_bytes_m + tab_m.numel() * 4 + 2 * K_MC * 4, nll_ops(K_MC, T_MC, 3, 4, True))
    a3 = {
        "ll_max_abs_err": ea_ll, "ll_rel_err": ra_ll,
        "ll_rel_err_kernel_vs_f64_plain": rel_err(all_k.double(), ll_64)[1],
        "ll_rel_err_plain_vs_f64_plain": rel_err(all_p.double(), ll_64)[1],
        "paired_ll_max_abs_err": ea_pll, "paired_ll_rel_err": ra_pll,
        "paired_dll_max_abs_err": ea_dll, "paired_dll_rel_err": ra_dll,
        "dll_rtol": RTOL_DLL_MC[CAMS_MC], "dll_gap_factor": DLL_GAP_FACTOR,
        "paired_dll_rel_err_kernel_vs_f64_plain": rel_err(adl_k.double(), dll_64)[1],
        "paired_dll_rel_err_plain_vs_f64_plain": rel_err(adl_p.double(), dll_64)[1],
        "ms": time_cuda(torch, lambda: fused_nll.fused_nll(tab_m, y_m_pl), 50),
        "plain_ms": time_cuda(torch, lambda: fused_nll._fused_nll_plain(tab_m, y_m_pl), 3),
        "paired_ms": time_cuda(torch, lambda: fused_nll.fused_nll_paired(tab_m, dtab_m, y_m_pl), 50),
        **dict(zip(("paired_device_ms", "paired_device_ms_by_kernel"),
                   device_ms(torch, lambda: fused_nll.fused_nll_paired(tab_m, dtab_m, y_m_pl), 20))),
        "paired_enqueue_ms": enqueue_ms(torch, lambda: fused_nll.fused_nll_paired(tab_m, dtab_m, y_m_pl), 50),
        "device_ms": device_ms(torch, lambda: fused_nll.fused_nll(tab_m, y_m_pl), 20)[0],
        "paired_plain_ms": time_cuda(torch, lambda: fused_nll._fused_nll_paired_plain(tab_m, dtab_m, y_m_pl), 3),
        "pack_jvp_ms": time_cuda(torch, lambda: torch.func.jvp(pack_m, (sl0_m,), (torch.ones_like(sl0_m),)), 20),
        "bound_ms": b_a3[0], "bound_by": b_a3[1], "paired_bound_ms": b_a3p[0], "paired_bound_by": b_a3p[1],
        "segments_G": plan_a3["G"], "threads": plan_a3["threads"], "deterministic": det_a3,
        "ptxas": nll_ptxas(3, 4),
    }
    a3["ok"] = (det_a3 and max(ra_ll, ra_pll) <= RTOL_NLL
                and dll_ok(CAMS_MC, a3["paired_dll_rel_err_kernel_vs_f64_plain"],
                           a3["paired_dll_rel_err_plain_vs_f64_plain"], ra_dll)
                and bool(torch.isfinite(adl_k).all()))
    emit({"phase": "kernel_A_d3", "N": K_MC, "T": T_MC, "D": 3, "O": 4, "rtol": RTOL_NLL, **a3})
    if not a3["ok"]:
        raise AssertionError("kernel A at (3, 4) disagrees with its plain version or is not deterministic")

    # --------------------------------------------------------------- 16 ---
    # kernel A's other instances, each on the operands of the multi-camera
    # optimizer that reaches it (cameras = O / 2, n_latent = D), and (3, 2)
    # on random-walk lanes; then the scan's D = 1 instances
    t_phase = time.perf_counter()

    def nll_check(tab, dtab, y, cams, dll_rtol):
        """Kernel A, plain and paired, against its plain version and both
        against the float64 plain version on these operands: ll to
        RTOL_NLL, d ll by the multi-camera rule at ``dll_rtol`` (without its
        gap factor for lanes of no session, ``cams`` None), two launches to
        the same bits; with times, bound and ptxas lines."""
        n_l, o_, n_t = y.shape
        d_ = pkalman._table_dims(tab.shape[1], o_)

        def run_k():
            return fused_nll.fused_nll(tab, y)

        def run_kp():
            return torch.stack(fused_nll.fused_nll_paired(tab, dtab, y))

        def run_p():
            return fused_nll._fused_nll_plain(tab, y)

        def run_pp():
            return torch.stack(fused_nll._fused_nll_paired_plain(tab, dtab, y))

        l_k, p_k, l_p, p_p = run_k(), run_kp(), run_p(), run_pp()
        p_64 = torch.stack(fused_nll._fused_nll_paired_plain(tab.double(), dtab.double(), y.double()))
        torch.cuda.synchronize()
        in_b = (y.numel() + tab.numel()) * 4
        b_ = bound_ms(in_b + n_l * 4, nll_ops(n_l, n_t, d_, o_, False))
        bp_ = bound_ms(in_b + tab.numel() * 4 + 2 * n_l * 4, nll_ops(n_l, n_t, d_, o_, True))
        plan = fused_nll.nll_plan(n_l, n_t, dev)
        res = {
            "D": d_, "O": o_, "lanes": n_l, "T": n_t, "cameras": cams, "segments_G": plan["G"],
            "threads": plan["threads"], "deterministic": deterministic(run_k, l_k) and deterministic(run_kp, p_k),
            "ll_max_abs_err": rel_err(l_k, l_p)[0], "ll_rel_err": rel_err(l_k, l_p)[1],
            "paired_ll_max_abs_err": rel_err(p_k[0], p_p[0])[0], "paired_ll_rel_err": rel_err(p_k[0], p_p[0])[1],
            "paired_dll_max_abs_err": rel_err(p_k[1], p_p[1])[0], "paired_dll_rel_err": rel_err(p_k[1], p_p[1])[1],
            "dll_rtol": dll_rtol, "dll_gap_factor": DLL_GAP_FACTOR,
            "paired_dll_rel_err_kernel_vs_f64_plain": rel_err(p_k[1].double(), p_64[1])[1],
            "paired_dll_rel_err_plain_vs_f64_plain": rel_err(p_p[1].double(), p_64[1])[1],
            "max_abs_ll_f64": float(p_64[0].abs().max()), "max_abs_dll_f64": float(p_64[1].abs().max()),
            "ms": time_cuda(torch, run_k, 30), "paired_ms": time_cuda(torch, run_kp, 30),
            "device_ms": device_ms(torch, run_k, 10)[0], "paired_device_ms": device_ms(torch, run_kp, 10)[0],
            "paired_enqueue_ms": enqueue_ms(torch, run_kp, 30),
            "plain_ms": time_cuda(torch, run_p, 1), "paired_plain_ms": time_cuda(torch, run_pp, 1),
            "bound_ms": b_[0], "bound_by": b_[1], "paired_bound_ms": bp_[0], "paired_bound_by": bp_[1],
            "ptxas": nll_ptxas(d_, o_),
        }
        k64, p64 = res["paired_dll_rel_err_kernel_vs_f64_plain"], res["paired_dll_rel_err_plain_vs_f64_plain"]
        res["ok"] = (res["deterministic"] and max(res["ll_rel_err"], res["paired_ll_rel_err"]) <= RTOL_NLL
                     and max(k64, res["paired_dll_rel_err"]) <= dll_rtol
                     and (cams is None or k64 <= DLL_GAP_FACTOR * p64)
                     and bool(torch.isfinite(p_k).all()))
        return res

    a_new = {}
    for cams_i, d_i in ((1, 1), (2, 1), (3, 1), (4, 1), (2, 2), (3, 2), (4, 2), (3, 3), (4, 3)):
        tab_i, dtab_i, y_i, _, _ = mc_optimizer_operands(cams_i, d_i)
        a_new[f"d{d_i}_o{2 * cams_i}"] = nll_check(tab_i, dtab_i, y_i, cams_i, RTOL_DLL_A[d_i])
    ys_l, m0_l, S0_l, A_l, Q_l, C_l, r_l, _ = (
        torch.as_tensor(x, device=dev) for x in lane_problem(np, np.random.default_rng(32), K_MC, T_MC, 2, 3))
    tab_l, dtab_l = torch.func.jvp(
        lambda sl: pkalman._pack_scalars(ys_l[:, 0], m0_l, S0_l, A_l, torch.exp(sl)[:, None, None] * Q_l, C_l, r_l),
        (torch.zeros(K_MC, device=dev),), (torch.ones(K_MC, device=dev),))
    a_new["d3_o2"] = nll_check(tab_l.contiguous(), dtab_l.contiguous(), ys_l.transpose(1, 2).contiguous(), None,
                               RTOL_DLL_A["lanes"])
    # the D = 1 scans on the one-latent two-camera final pass's elements,
    # at the optimizer's starting s; the paired ones along log s
    _, ys_1, ev_1, m0_1, S0_1, A_1, Q_1, C_1, _ = mc_prep(CAMS_MC, 1)
    sl0_1 = mc_optimizer_operands(CAMS_MC, 1)[3]
    r_1 = torch.clamp(ev_1, min=1e-12)

    def elems_1(sl):
        return pkalman._make_filter_elements(ys_1, m0_1, S0_1, A_1, torch.exp(sl)[:, None, None] * Q_1, C_1, r_1)

    fr_1 = pkalman.kalman_filter_parallel(ys_1, m0_1, S0_1, A_1, torch.exp(sl0_1)[:, None, None] * Q_1, C_1, r_1,
                                          compute_ll=False)

    def smoother_elems_1(sl):
        return pkalman._make_smoother_elements(fr_1.filtered_means, fr_1.filtered_covs, A_1,
                                               torch.exp(sl)[:, None, None] * Q_1)

    scans_1 = {
        "filter_d1": scan_check("filter", elems_1(sl0_1).contiguous()),
        "smoother_d1": scan_check("smoother", smoother_elems_1(sl0_1).contiguous()),
        "filter_paired_d1": scan_check("filter", *along_log_s(lambda sl: elems_1(sl0_1 + sl), K_MC)),
        "smoother_paired_d1": scan_check("smoother", *along_log_s(lambda sl: smoother_elems_1(sl0_1 + sl), K_MC)),
    }
    emit({"phase": "kernel_A_instances", "N": K_MC, "T": T_MC, "rtol": RTOL_NLL, "scan_rtol": RTOL_SCAN_NEW,
          "instances": a_new, "scans_d1": scans_1, "seconds": time.perf_counter() - t_phase})
    if not (all(v["ok"] for v in a_new.values()) and all(v["ok"] for v in scans_1.values())):
        raise AssertionError("a kernel A instance or a D = 1 scan disagrees with its plain version")

    # --------------------------------------------------------------- 13 ---
    # the mirrored and paw families through the bundled files, against the
    # committed goldens at the reference's contract
    golden_res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in (("mirrored_fixed", dict(smooth_param=3.0)), ("mirrored_auto_inflate", dict(inflate_vars=True))):
            t0 = time.perf_counter()
            df, s_g, _, _ = eks_tpu_torch.fit_eks_mirrored_multicam(
                os.path.join(REPO, "data", "mirrored"), os.path.join(tmp, name + ".csv"),
                camera_names=["top", "bot"], device="cuda", **kw)
            gap, same_cols = golden_gap(df, name)
            golden_res[name] = {"max_abs_err": gap, "columns_match": same_cols, "s": [float(x) for x in s_g],
                                "wall_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        dfs_paw, s_g, _, _ = eks_tpu_torch.fit_eks_multicam_ibl_paw(
            os.path.join(REPO, "data", "paw"), os.path.join(tmp, "paw"), var_mode="var", device="cuda")
        for df, name in zip(dfs_paw, ("paw_left", "paw_right")):
            gap, same_cols = golden_gap(df, name)
            golden_res[name] = {"max_abs_err": gap, "columns_match": same_cols, "s": [float(x) for x in s_g],
                                "wall_s": time.perf_counter() - t0}
    emit({"phase": "golden_multicam", "atol": 1e-4, "goldens": golden_res})
    for name, res in golden_res.items():
        if not (res["columns_match"] and res["max_abs_err"] <= 1e-4):
            raise AssertionError(f"{name} golden mismatch: {res}")

    # --------------------------------------------------------------- 14 ---
    def mc_run(c, n_latent=3):
        """The c-camera session through the entry point at ``n_latent``,
        counts read around it: (camera_dfs, s_finals, wall, timings,
        launches)."""
        reset_counts()
        tm = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dfs_c, s_c, _ = eks_tpu_torch.ensemble_kalman_smoother_multicam(
            MarkerArray(mc_arr[c], data_fields=fields), mc_names, [f"cam{i}" for i in range(c)],
            n_latent=n_latent, device="cuda", timings=tm)
        return dfs_c, s_c, time.perf_counter() - t0, tm, read_counts()

    def mc_seq_gap(c, dfs_c, s_c, n_latent=3):
        """The c-camera run's x and y columns against the float64 sequential
        smoother at the same s, from the same prep: (largest gap, the
        sequential smoother's seconds)."""
        _, ys_c, ev_c, m0_c, S0_c, A_c, Q_c, C_c, means_c = mc_prep(c, n_latent)
        d64 = dict(dtype=torch.float64, device="cpu")
        s64 = torch.as_tensor(s_c, **d64)
        t0 = time.perf_counter()
        ref, _ = seq_smoother_f64(torch, ys_c.to(**d64), m0_c.to(**d64), S0_c.to(**d64), A_c.to(**d64),
                                  s64[:, None, None] * Q_c.to(**d64), C_c.to(**d64),
                                  torch.clamp(ev_c, min=1e-12).to(**d64))
        ref_s = time.perf_counter() - t0
        y_ref = torch.einsum("koj,ktj->kto", C_c.to(**d64), ref)  # (K, T, 2C)
        gap = 0.0
        for i, d in enumerate(dfs_c):
            got_xy = d.to_numpy().reshape(T_MC, K_MC, 9)[..., :2]
            ref_xy = y_ref[:, :, 2 * i:2 * i + 2].transpose(0, 1) + means_c[i].to(**d64)[None]
            gap = max(gap, float(np.abs(got_xy - ref_xy.numpy()).max()))
        return gap, ref_s

    mc_run(CAMS_MC)  # warm-up at the same shapes
    dfs_mc, s_mc, wall_mc, tm_mc, launches_mc = mc_run(CAMS_MC)
    iters_mc = tm_mc.get("adam_iters", 0)
    finite = all(np.isfinite(d.to_numpy()).all() and d.shape == (T_MC, K_MC * 9) for d in dfs_mc) \
        and bool(np.isfinite(s_mc).all())

    seq_gap, ref_s = mc_seq_gap(CAMS_MC, dfs_mc, s_mc)
    emit({
        "phase": "multicam_auto_s", "frames": T_MC, "keypoints": K_MC, "cameras": CAMS_MC, "seeds": SEEDS_MC,
        "wall_s": wall_mc, "prep_s": tm_mc.get("prep"), "optimizer_s": tm_mc.get("optimizer"),
        "final_pass_s": tm_mc.get("final_pass"), "package_s": tm_mc.get("package"),
        "adam_iters": iters_mc,
        "us_per_adam_iter": tm_mc["optimizer"] / iters_mc * 1e6 if iters_mc else None,
        "s_min": float(np.min(s_mc)), "s_median": float(np.median(s_mc)), "s_max": float(np.max(s_mc)),
        "finite": bool(finite), "launches": launches_mc, "max_abs_err_vs_f64_sequential": seq_gap,
        "f64_sequential_s": ref_s, "card": card,
    })
    if not finite:
        raise AssertionError("two-camera output is not finite or has the wrong shape")
    if min(launches_mc["fused_nll_paired"], launches_mc["prefix_scan_filter_d3"],
           launches_mc["prefix_scan_smoother_d3"]) <= 0 or launches_mc["prefix_scan_filter_paired_d3"] != 0:
        raise AssertionError(f"the two-camera path did not run through its three kernels: {launches_mc}")
    if seq_gap > 1e-2:
        raise AssertionError(f"two-camera final pass is {seq_gap} from the float64 sequential smoother")

    # -------------------------------------------------------------- 14b ---
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mc_run(CAMS_MC)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    emit({
        "phase": "multicam_profile", "profiled_wall_s": prof_wall, "unprofiled_wall_s": wall_mc,
        **device_profile(torch, prof, wall_mc, iters_mc),
    })

    # --------------------------------------------------------------- 15 ---
    # six cameras: 12 observations, beyond the fused NLL, so the optimizer's
    # loss is the staged plane NLL over the paired lane-batched scan
    # first the same optimizer on the card and, through its plain versions,
    # on the CPU, from one prep, both capped at a few iterations (the plain
    # paired path costs seconds per iteration at this size); it also warms
    # the card up for the timed run
    ops_w = (ys_w, m0_w, S0_w, A_w, C_w, Q_w, ev_w.transpose(0, 1))
    s_card, _, _ = run_kalman_smoother(*ops_w, safety_cap=CAP_MC_WIDE)
    t0 = time.perf_counter()
    s_cpu, _, _ = run_kalman_smoother(*(x.cpu() for x in ops_w), safety_cap=CAP_MC_WIDE)
    cpu_s = time.perf_counter() - t0
    s_rel_gap = float(np.max(np.abs(s_card - s_cpu) / np.abs(s_cpu)))
    dfs_w, s_w, wall_w, tm_w, launches_w = mc_run(CAMS_MC_WIDE)
    iters_w = tm_w.get("adam_iters", 0)
    finite_w = all(np.isfinite(d.to_numpy()).all() and d.shape == (T_MC, K_MC * 9) for d in dfs_w) \
        and bool(np.isfinite(s_w).all())
    seq_gap_w, ref_s_w = mc_seq_gap(CAMS_MC_WIDE, dfs_w, s_w)
    emit({
        "phase": "multicam_six_cameras_auto_s", "frames": T_MC, "keypoints": K_MC, "cameras": CAMS_MC_WIDE,
        "seeds": SEEDS_MC, "wall_s": wall_w, "prep_s": tm_w.get("prep"), "optimizer_s": tm_w.get("optimizer"),
        "final_pass_s": tm_w.get("final_pass"), "package_s": tm_w.get("package"),
        "adam_iters": iters_w,
        "us_per_adam_iter": tm_w["optimizer"] / iters_w * 1e6 if iters_w else None,
        "s_min": float(np.min(s_w)), "s_median": float(np.median(s_w)), "s_max": float(np.max(s_w)),
        "finite": bool(finite_w), "launches": launches_w,
        "max_abs_err_vs_f64_sequential": seq_gap_w, "f64_sequential_s": ref_s_w,
        "capped_iters": CAP_MC_WIDE, "s_rel_gap_card_vs_cpu_plain_capped": s_rel_gap, "s_rtol": 5e-4,
        "cpu_plain_capped_s": cpu_s, "card": card,
    })
    if not finite_w:
        raise AssertionError("six-camera output is not finite or has the wrong shape")
    if launches_w["prefix_scan_filter_paired_d3"] != iters_w or iters_w <= 0 or launches_w["fused_nll_paired"] != 0:
        raise AssertionError(f"the six-camera optimizer did not take one paired scan per iteration: {launches_w}")
    if min(launches_w["prefix_scan_filter_d3"], launches_w["prefix_scan_smoother_d3"]) <= 0:
        raise AssertionError(f"the six-camera final pass did not run through both scans: {launches_w}")
    if seq_gap_w > 1e-2:
        raise AssertionError(f"six-camera final pass is {seq_gap_w} from the float64 sequential smoother")
    if s_rel_gap > 5e-4:
        raise AssertionError(f"six-camera s on the card is {s_rel_gap} from the CPU's plain path")

    # -------------------------------------------------------------- 15b ---
    # where a six-camera iteration's time goes: the optimizer and final pass
    # on the same operands capped at a few iterations, once plain and once
    # under the profiler (device activity only)
    def capped_w():
        tm_c = {}
        run_kalman_smoother(*ops_w, safety_cap=CAP_MC_WIDE, timings=tm_c)
        torch.cuda.synchronize()
        return tm_c

    t0 = time.perf_counter()
    tm_cw = capped_w()
    capped_wall_w = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        capped_w()
        prof_wall = time.perf_counter() - t0
    emit({
        "phase": "multicam_six_cameras_profile", "adam_iters": tm_cw.get("adam_iters"),
        "profiled_wall_s": prof_wall, "unprofiled_wall_s": capped_wall_w,
        "unprofiled_optimizer_s": tm_cw.get("optimizer"),
        **device_profile(torch, prof, capped_wall_w, tm_cw.get("adam_iters")),
    })

    # --------------------------------------------------------------- 17 ---
    # the two-camera session at other latent sizes through the entry point:
    # n_latent 1 and 2 on kernel A at (1, 4) and (2, 4) and the D = 1 and 2
    # scans; n_latent 4 beyond both, on the staged loss and the plain scan
    # (the JAX package's XLA route there), which the plain-route count shows.
    # Before each timed run, the optimizer on three of its keypoints, on the
    # card and through the plain versions on the CPU, capped, from one prep,
    # held two ways. With the stop rule off (tol < 0: every lane takes the
    # capped number of Adam steps) the two s trajectories are held to each
    # other. With the rule on, as the entry point runs, a lane stops once two
    # consecutive float32 losses differ by less than about 0.16; at n_latent 1
    # |ll| passes 1e7 (phase 16), where a float32 step is 1 or more, so a lane
    # stops where two losses round alike, which the card's and the CPU's
    # rounding decide differently near the optimum. So each lane's s on the
    # card is held against the CPU's trajectory at the iteration where the
    # card's lane stopped (from the optimizer's own per-block report). The
    # float64 CPU run with the rule on is printed beside it as the witness of
    # how far float32's stop alone moves s
    t_phase = time.perf_counter()
    nl_res, launches_nl = {}, {}
    for k in N_LATENTS:
        _, ys_k, ev_k, m0_k, S0_k, A_k, Q_k, C_k, _ = mc_prep(CAMS_MC, k)
        sub = slice(0, NL_CHECK_LANES)
        ops_k = (ys_k[sub], m0_k[sub], S0_k[sub], A_k[sub], C_k[sub], Q_k[sub], ev_k[sub].transpose(0, 1))
        ops_cpu = tuple(x.cpu() for x in ops_k)
        traj_card = capped_opt(ops_k, -1.0, CAP_MC_WIDE)
        traj_cpu = {CAP_MC_WIDE: capped_opt(ops_cpu, -1.0, CAP_MC_WIDE)}
        s_gap_k = float(s_gap(traj_card[0], traj_cpu[CAP_MC_WIDE][0]).max())
        stop_card, stop_cpu = capped_opt(ops_k, 1e-2, CAP_MC_WIDE), capped_opt(ops_cpu, 1e-2, CAP_MC_WIDE)
        stop_64 = capped_opt(tuple(x.double() for x in ops_cpu), 1e-2, CAP_MC_WIDE)
        # the CPU's trajectory at each iteration where a lane stopped on the card
        at_card_stop = np.empty(NL_CHECK_LANES)
        for c in sorted(set(stop_card[1].tolist())):
            if c not in traj_cpu:
                traj_cpu[c] = capped_opt(ops_cpu, -1.0, c)
            lanes = stop_card[1] == c
            at_card_stop[lanes] = traj_cpu[c][0][lanes]
        s_gap_stop_k = float(s_gap(stop_card[0], at_card_stop).max())
        dfs_k, s_k, wall_k, tm_k, launches_k = mc_run(CAMS_MC, k)
        iters_k = tm_k.get("adam_iters", 0)
        finite_k = all(np.isfinite(d.to_numpy()).all() and d.shape == (T_MC, K_MC * 9) for d in dfs_k) \
            and bool(np.isfinite(s_k).all())
        seq_gap_k, ref_s_k = mc_seq_gap(CAMS_MC, dfs_k, s_k, k)
        launches_nl[k] = launches_k
        if k <= 3:
            kernels_ran = (launches_k[a_key(k, 2 * CAMS_MC, True)] == iters_k > 0
                           and launches_k["plain_route"] == 0
                           and launches_k[f"prefix_scan_filter_d{k}" if k != 2 else "prefix_scan_filter"] == 1
                           and launches_k[f"prefix_scan_smoother_d{k}" if k != 2 else "prefix_scan_smoother"] == 1)
        else:
            kernels_ran = (launches_k["fused_nll_paired"] == 0 and iters_k > 0
                           and launches_k["plain_route"] == iters_k + 2)
        nl_res[k] = {
            "wall_s": wall_k, "prep_s": tm_k.get("prep"), "optimizer_s": tm_k.get("optimizer"),
            "final_pass_s": tm_k.get("final_pass"), "package_s": tm_k.get("package"), "adam_iters": iters_k,
            "us_per_adam_iter": tm_k["optimizer"] / iters_k * 1e6 if iters_k else None,
            "s_min": float(np.min(s_k)), "s_median": float(np.median(s_k)), "s_max": float(np.max(s_k)),
            "finite": bool(finite_k), "launches": {key: v for key, v in launches_k.items() if v},
            "fused_nll_instance": [k, 2 * CAMS_MC] if k <= 3 else None,
            "plain_route": launches_k["plain_route"], "kernels_ran": bool(kernels_ran),
            "max_abs_err_vs_f64_sequential": seq_gap_k, "f64_sequential_s": ref_s_k,
            "capped_iters": CAP_MC_WIDE, "capped_lanes": NL_CHECK_LANES,
            "s_rel_gap_card_vs_cpu_plain_capped": s_gap_k, "cpu_plain_capped_s": traj_cpu[CAP_MC_WIDE][2],
            "with_stop_rule": {
                "s_rel_gap_card_vs_cpu_trajectory_at_card_stop": s_gap_stop_k,
                "lane_iters_card": stop_card[1].tolist(), "lane_iters_cpu": stop_cpu[1].tolist(),
                "lane_iters_cpu_f64": stop_64[1].tolist(),
                "lane_s_rel_gap_card_vs_cpu": s_gap(stop_card[0], stop_cpu[0]).tolist(),
                "lane_s_rel_gap_cpu_vs_cpu_f64": s_gap(stop_cpu[0], stop_64[0]).tolist(),
                "lane_s_rel_gap_card_vs_cpu_f64": s_gap(stop_card[0], stop_64[0]).tolist(),
            },
        }
    emit({"phase": "multicam_n_latent", "frames": T_MC, "keypoints": K_MC, "cameras": CAMS_MC,
          "seeds": SEEDS_MC, "s_rtol": 5e-4, "seq_atol": 1e-2, "n_latent": {str(k): v for k, v in nl_res.items()},
          "seconds": time.perf_counter() - t_phase, "card": card})
    for k, v in nl_res.items():
        if not v["finite"]:
            raise AssertionError(f"n_latent {k}: output is not finite or has the wrong shape")
        if not v["kernels_ran"]:
            raise AssertionError(f"n_latent {k}: the path did not run through its kernels: {launches_nl[k]}")
        if v["max_abs_err_vs_f64_sequential"] > 1e-2:
            raise AssertionError(f"n_latent {k}: final pass is {v['max_abs_err_vs_f64_sequential']} from float64")
        if v["s_rel_gap_card_vs_cpu_plain_capped"] > 5e-4:
            raise AssertionError(f"n_latent {k}: s on the card is {v['s_rel_gap_card_vs_cpu_plain_capped']} "
                                 "from the CPU's plain path")
        if v["with_stop_rule"]["s_rel_gap_card_vs_cpu_trajectory_at_card_stop"] > 5e-4:
            raise AssertionError(f"n_latent {k}: with the stop rule, s on the card is off the CPU's plain "
                                 f"trajectory: {v['with_stop_rule']}")

    # --------------------------------------------------------------- 20 ---
    # singlecam sessions: four headline sessions stacked as 80 lanes of one
    # run (kernel A at (2, 2) paired over 80 lanes), each held against its
    # solo run and against the float64 sequential smoother; and auto s with
    # s_frames on the bundled session against the committed golden
    t_phase = time.perf_counter()
    srng = np.random.default_rng(1)
    sc_mas = [MarkerArray(make_session(np, srng), data_fields=fields) for _ in range(N_SC_SESSIONS)]
    sc_kps = [[f"kp{i}" for i in range(K_HEAD)]] * N_SC_SESSIONS
    # the warm-up run records the operands the path gives its kernels at 80
    # lanes: kernel A paired's first Adam iteration, the final pass's filter
    # and smoother elements
    sc_calls = {"fused_nll_paired": [], "filter_prefix": [], "smoother_suffix": []}
    with contextlib.ExitStack() as stack:
        stack.enter_context(recording(fused_nll, "fused_nll_paired", sc_calls["fused_nll_paired"], first_only=True))
        for name in ("filter_prefix", "smoother_suffix"):
            stack.enter_context(recording(fused_filter, name, sc_calls[name]))
        eks_tpu_torch.ensemble_kalman_smoother_singlecam_sessions(sc_mas, sc_kps, device="cuda")
    reset_counts()
    tm_sc = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc_batched = eks_tpu_torch.ensemble_kalman_smoother_singlecam_sessions(sc_mas, sc_kps, device="cuda",
                                                                          timings=tm_sc)
    wall_sc = time.perf_counter() - t0
    launches_sc = read_counts()
    iters_sc = tm_sc.get("adam_iters", 0)

    # kernel A paired at (2, 2) over the 80 lanes, and the D = 2 scans at 80
    # lanes, against their plain versions on those operands
    tab_s, dtab_s, y_s = sc_calls["fused_nll_paired"][0]
    sa_k = fused_nll.fused_nll_paired(tab_s, dtab_s, y_s)
    sa_p = fused_nll._fused_nll_paired_plain(tab_s, dtab_s, y_s)
    torch.cuda.synchronize()
    n_s, t_s = y_s.shape[0], y_s.shape[2]
    b_as = bound_ms((n_s * 2 * t_s + 2 * n_s * tab_s.shape[1]) * 4 + 2 * n_s * 4, nll_ops(n_s, t_s, 2, 2, True))
    a80 = {
        "lanes": n_s, "T": t_s, "rtol": RTOL_NLL, "paired_ll_max_abs_err": rel_err(sa_k[0], sa_p[0])[0],
        "paired_ll_rel_err": rel_err(sa_k[0], sa_p[0])[1], "paired_dll_max_abs_err": rel_err(sa_k[1], sa_p[1])[0],
        "paired_dll_rel_err": rel_err(sa_k[1], sa_p[1])[1], "segments_G": fused_nll.nll_plan(n_s, t_s, dev)["G"],
        "deterministic": deterministic(lambda: torch.stack(fused_nll.fused_nll_paired(tab_s, dtab_s, y_s)),
                                       torch.stack(sa_k)),
        "ms": time_cuda(torch, lambda: fused_nll.fused_nll_paired(tab_s, dtab_s, y_s), 50),
        "device_ms": device_ms(torch, lambda: fused_nll.fused_nll_paired(tab_s, dtab_s, y_s), 20)[0],
        "plain_ms": time_cuda(torch, lambda: fused_nll._fused_nll_paired_plain(tab_s, dtab_s, y_s), 3),
        "bound_ms": b_as[0], "bound_by": b_as[1],
    }
    a80["ok"] = (max(a80["paired_ll_rel_err"], a80["paired_dll_rel_err"]) <= RTOL_NLL and a80["deterministic"]
                 and bool(torch.isfinite(sa_k[1]).all()))
    sc_scans = {name: scan_check("smoother" if name == "smoother_suffix" else "filter", *calls[0])
                for name, calls in sc_calls.items() if name != "fused_nll_paired"}
    del sc_calls, tab_s, dtab_s, y_s
    emit({"phase": "singlecam_sessions_kernels", "fused_nll_paired_d2_o2": a80, **sc_scans})
    if not (a80["ok"] and all(r["ok"] for r in sc_scans.values())):
        raise AssertionError("a kernel disagrees with its plain version on the sessions path's operands")

    sc_s_gap, sc_table_gap, sc_solo_walls, sc_solo = [], [], [], []
    sc_label_gap = np.zeros(9)
    for (df_b, s_b), ma_i, kps_i in zip(sc_batched, sc_mas, sc_kps):
        t0 = time.perf_counter()
        df_i, s_i = eks_tpu_torch.ensemble_kalman_smoother_singlecam(ma_i, kps_i, device="cuda")
        sc_solo_walls.append(time.perf_counter() - t0)
        sc_solo.append((df_i, s_i))
        sc_s_gap.append(float(np.max(np.abs(s_b / s_i - 1.0))))
        b_np, i_np = df_b.to_numpy(), df_i.to_numpy()
        sc_table_gap.append(float(np.max(np.abs(b_np - i_np) / (1.0 + np.abs(i_np)))))
        sc_label_gap = np.maximum(sc_label_gap, np.abs(b_np - i_np).reshape(T_HEAD, K_HEAD, 9).max(axis=(0, 1)))
    # every session's batched and solo tables against the float64
    # sequential smoother at that run's s (all 80 lanes in one call each);
    # and, as controls, the float64 filtered means in place of the smoothed
    # ones, and the float64 smoother at s 1 % off
    sc_ops = []
    for ma_i in sc_mas:
        raw_i = torch.as_tensor(ma_i.array[:, 0], dtype=torch.float32, device=dev)
        stats_i, ys_i, means_i, S0s_i = _prep_singlecam(raw_i[..., 0], raw_i[..., 1], raw_i[..., 2], SEEDS_HEAD,
                                                        "median", "confidence_weighted_var")
        sc_ops.append((ys_i, S0s_i, torch.clamp(stats_i[..., 2:4].transpose(0, 1), min=1e-12), means_i))
    ys80, S080, r80 = (torch.cat([o[j] for o in sc_ops]).to(**d64) for j in range(3))
    means80 = torch.cat([o[3] for o in sc_ops]).to(**d64)  # (80, 2)
    n80 = ys80.shape[0]

    def f64_tables(*s80s):
        """For each (80,) s: (x, y (80, T, 2), posterior variances (80, T, 2),
        filtered x, y) of the float64 sequential smoother at the lanes' s,
        all in one call (its cost is per step, not per lane)."""
        n = len(s80s)

        def rep(x):
            return x.repeat((n,) + (1,) * (x.dim() - 1))

        eye = torch.eye(2, **d64).expand(n * n80, 2, 2)
        s_all = torch.as_tensor(np.concatenate(s80s), **d64)
        m, P, f = seq_smoother_f64(torch, rep(ys80), torch.zeros(n * n80, 2, **d64), rep(S080), eye,
                                   s_all[:, None, None] * eye, eye, rep(r80), filtered=True)
        mu = rep(means80)[:, None]
        xy, var, fxy = m + mu, torch.diagonal(P, dim1=-2, dim2=-1), f + mu
        return [(xy[i * n80:(i + 1) * n80], var[i * n80:(i + 1) * n80], fxy[i * n80:(i + 1) * n80])
                for i in range(n)]

    def table_gaps(tables, xy_ref, var_ref):
        """Per session, the largest |x, y| and |posterior variance| gaps of
        (T, K * 9) tables from the (80, T, 2) references."""
        res = []
        for i, table in enumerate(tables):
            t9 = torch.tensor(table.reshape(T_HEAD, K_HEAD, 9), **d64).transpose(0, 1)
            lanes = slice(i * K_HEAD, (i + 1) * K_HEAD)
            res.append({"xy": float((t9[..., :2] - xy_ref[lanes]).abs().max()),
                        "posterior_var": float((t9[..., 7:9] - var_ref[lanes]).abs().max())})
        return res

    t0 = time.perf_counter()
    s_b80 = np.concatenate([s for _, s in sc_batched])
    (xy_b, var_b, filt_b), (xy_i, var_i, _), (xy_off, var_off, _) = f64_tables(
        s_b80, np.concatenate([s for _, s in sc_solo]), s_b80 * 1.01)
    sc_vs_f64 = {"batched": table_gaps([df.to_numpy() for df, _ in sc_batched], xy_b, var_b),
                 "solo": table_gaps([df.to_numpy() for df, _ in sc_solo], xy_i, var_i)}
    sc_controls = {"filtered_xy": float((filt_b - xy_b).abs().max()),
                   "s_1_percent_off": {"xy": float((xy_off - xy_b).abs().max()),
                                       "posterior_var": float((var_off - var_b).abs().max())}}
    sc_f64_s = time.perf_counter() - t0
    sc_f64_worst = {k: max(g[k] for runs in sc_vs_f64.values() for g in runs) for k in ("xy", "posterior_var")}
    finite_sc = all(np.isfinite(df.to_numpy()).all() and df.shape == (T_HEAD, K_HEAD * 9) for df, _ in sc_batched)
    kernels_sc = (launches_sc[a_key(2, 2, True)] == iters_sc > 0 and launches_sc["prefix_scan_filter"] == 1
                  and launches_sc["prefix_scan_smoother"] == 1)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        df_auto, s_auto, _, _ = eks_tpu_torch.fit_eks_singlecam(
            os.path.join(REPO, "data", "singlecam"), os.path.join(tmp, "out.csv"), s_frames=[(0, 250)],
            device="cuda")
        wall_auto = time.perf_counter() - t0
    gap_auto, cols_auto = golden_gap(df_auto, "singlecam_auto")
    emit({
        "phase": "singlecam_sessions", "sessions": N_SC_SESSIONS, "frames": T_HEAD, "keypoints": K_HEAD,
        "lanes": N_SC_SESSIONS * K_HEAD, "wall_s": wall_sc, "solo_walls_s": sc_solo_walls,
        "prep_s": tm_sc.get("prep"), "optimizer_s": tm_sc.get("optimizer"), "final_pass_s": tm_sc.get("final_pass"),
        "package_s": tm_sc.get("package"), "adam_iters": iters_sc,
        "us_per_adam_iter": tm_sc["optimizer"] / iters_sc * 1e6 if iters_sc else None,
        "finite": bool(finite_sc), "launches": {k: v for k, v in launches_sc.items() if v},
        "kernels_ran": bool(kernels_sc), "s_rel_gap_vs_solo": sc_s_gap, "table_rel_gap_vs_solo": sc_table_gap,
        "table_abs_gap_vs_solo_by_label": dict(zip(eks_tpu_torch.models.singlecam.OUTPUT_LABELS,
                                                   sc_label_gap.tolist())),
        "rtol": 5e-4, "abs_gap_vs_f64_sequential": sc_vs_f64, "f64_atol": SEQ_ATOL_SESSIONS,
        "f64_controls": sc_controls, "f64_sequential_s": sc_f64_s,
        "golden_singlecam_auto": {"max_abs_err": gap_auto, "atol": 1e-4, "columns_match": cols_auto,
                                  "s": [float(x) for x in s_auto], "wall_s": wall_auto},
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    if not finite_sc:
        raise AssertionError("a singlecam session's output is not finite or has the wrong shape")
    if not kernels_sc:
        raise AssertionError(f"the sessions path did not run through its kernels: {launches_sc}")
    if max(sc_s_gap + sc_table_gap) > 5e-4:
        raise AssertionError(f"sessions differ from their solo runs: s {sc_s_gap}, tables {sc_table_gap}")
    if any(sc_f64_worst[k] > SEQ_ATOL_SESSIONS[k] for k in SEQ_ATOL_SESSIONS):
        raise AssertionError(f"a session's table is off the float64 sequential smoother: {sc_vs_f64}")
    if not (cols_auto and gap_auto <= 1e-4):
        raise AssertionError(f"singlecam_auto golden mismatch: {gap_auto}")

    # -------------------------------------------------------------- 20b ---
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eks_tpu_torch.ensemble_kalman_smoother_singlecam_sessions(sc_mas, sc_kps, device="cuda")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    emit({
        "phase": "singlecam_sessions_profile", "profiled_wall_s": prof_wall, "unprofiled_wall_s": wall_sc,
        **device_profile(torch, prof, wall_sc, iters_sc),
    })

    # --------------------------------------------------------------- 22 ---
    # multi-device smoothing (parallel/mesh.py): the carried scan against its
    # plain version, the sharded scans against the unsharded kernel scan, and
    # the headline (keypoint and time axis), pupil (time axis), two-camera and
    # calibrated (keypoint axis) runs over four shards, each against its
    # one-device run, and the command line with --devices. Four shards sit
    # on cuda:0 through parallel.mesh on any host (the counterpart of the JAX
    # tests' virtual devices); a host with several cards runs the public
    # devices=min(4, count) too, each shard on a card of its own
    from unittest import mock

    from eks_tpu_torch.cli.main import main as cli_main
    from eks_tpu_torch.models.singlecam import _prep_singlecam
    from eks_tpu_torch.parallel import mesh as pmesh

    t_phase22 = time.perf_counter()
    n_cards = torch.cuda.device_count()

    @contextlib.contextmanager
    def four_shards_on_card0():
        """``devices=n`` through the entry points gives n shards of cuda:0."""
        real = pmesh.make_mesh
        pmesh.make_mesh = lambda n_devices=None, device="cuda": (dev,) * int(n_devices)
        try:
            yield
        finally:
            pmesh.make_mesh = real

    setups = [("4_shards_on_cuda0", 4, four_shards_on_card0)]
    if n_cards >= 2:
        setups.append((f"{min(4, n_cards)}_cards", min(4, n_cards), contextlib.nullcontext))
    one_card_refusal = None
    if n_cards < 2:
        # one card: devices=2 raises before any work, and the mesh never
        # names the CPU
        try:
            eks_tpu_torch.ensemble_kalman_smoother_singlecam(ma, kps, smooth_param=2.0, device="cuda", devices=2)
            one_card_refusal = "ran"
        except ValueError as exc:
            one_card_refusal = str(exc)
        if "requested 2 devices but only 1 available" not in one_card_refusal:
            raise AssertionError(f"devices=2 on a one-card host did not raise as it should: {one_card_refusal}")
    cuda_only = all(d.type == "cuda" for d in pmesh.make_mesh(n_cards, "cuda"))
    emit({"phase": "parallel_setup", "card_count": n_cards, "setups": [s[0] for s in setups],
          "meshes": {name: [str(d) for d in (pmesh.make_mesh(n, "cuda") if name.endswith("cards") else (dev,) * n)]
                     for name, n, _ in setups},
          "shards_on_distinct_cards": {name: name.endswith("cards") for name, _, _ in setups},
          "one_card_devices_2": one_card_refusal, "mesh_is_cuda_only": cuda_only, "card": card})
    if not cuda_only:
        raise AssertionError("make_mesh named a device that is not a card")

    # the carried scan, every instance (phase A, then phase B from a carry),
    # against its plain version on the final pass's elements of 2 x 2,500
    # steps: a chunk's own elements and the total of the chunk before it in
    # scan order
    def carry_operands(kind, D, N, Tc):
        g = np.random.default_rng(22 + D)
        ys_ = torch.as_tensor(g.normal(size=(N, 2 * Tc, D)).cumsum(1) * 0.1, dtype=torch.float32, device=dev)
        r_ = torch.as_tensor(g.uniform(0.5, 2.0, size=(N, 2 * Tc, D)), dtype=torch.float32, device=dev)
        eye_ = torch.eye(D, device=dev).expand(N, D, D).contiguous()
        Cs_ = eye_[:, None].expand(N, 2 * Tc, D, D)

        def make(sl):
            Q_ = torch.exp(sl)[:, None, None] * eye_ * 0.1
            el = pkalman._make_filter_elements_tv(ys_, torch.zeros(N, D, device=dev), eye_, eye_ * 0.95, Q_, Cs_, r_)
            if kind == "smoother":
                ms_, Ps_ = pkalman._filtered_moments(fused_filter.filter_prefix_plain(el), D)
                el = pkalman._make_smoother_elements(ms_, Ps_, eye_ * 0.95, Q_)
            return el

        planes_, tangents_ = along_log_s(make, N)
        src, loc = (slice(0, Tc), slice(Tc, None)) if kind == "filter" else (slice(Tc, None), slice(0, Tc))
        tot, dtot = torch.func.jvp(lambda x: fused_filter.scan_total_plain(x, kind),
                                   (planes_[..., src].contiguous(),), (tangents_[..., src].contiguous(),))
        return (tot.contiguous(), dtot.contiguous(), planes_[..., loc].contiguous(),
                tangents_[..., loc].contiguous(), planes_, tangents_)

    # 96 MB written between timed calls evicts the 50 MB L2, so every call
    # reads its operands from device memory and its time can be held against
    # the bytes bound: back to back, a chunk of a few MB stays in the L2, and
    # a reading then beats the bound
    l2_flush = torch.empty(24 * 2 ** 20, dtype=torch.float32, device=dev)

    def flushed(fn):
        def run():
            l2_flush.zero_()
            return fn()
        return run

    # the uncarried scans, float and paired, that a carried chunk is timed beside
    scans_by_kind = {"filter": (fused_filter.filter_prefix, fused_filter.filter_prefix_paired),
                     "smoother": (fused_filter.smoother_suffix, fused_filter.smoother_suffix_paired)}

    def carry_check(kind, D, paired, ops):
        c, dc, x, dx = ops[:4]
        N, P, Tc = x.shape
        if paired:
            def run_k():
                return torch.cat(fused_filter.scan_carried(x, c, kind, dx, dc), dim=1)

            def run_p(v=(x, c, dx, dc)):
                return torch.cat(torch.func.jvp(lambda a, b: fused_filter.scan_carried_plain(a, b, kind),
                                                (v[0], v[1]), (v[2], v[3])), dim=1)

            def run_uncarried():
                return torch.cat(scans_by_kind[kind][1](x, dx), dim=1)

            total = torch.cat(fused_filter.scan_total(x, kind, dx), dim=1)
            total_p = torch.cat(torch.func.jvp(lambda a: fused_filter.scan_total_plain(a, kind), (x,), (dx,)), dim=1)
            out_64 = run_p(tuple(v.double() for v in (x, c, dx, dc)))
        else:
            def run_k():
                return fused_filter.scan_carried(x, c, kind)

            def run_p(v=(x, c)):
                return fused_filter.scan_carried_plain(v[0], v[1], kind)

            def run_uncarried():
                return scans_by_kind[kind][0](x)

            total, total_p = fused_filter.scan_total(x, kind), fused_filter.scan_total_plain(x, kind)
            out_64 = run_p((x.double(), c.double()))
        out_k, out_p = run_k(), run_p()
        torch.cuda.synchronize()
        e_abs, e_rel = rel_err(out_k, out_p)
        w = 2 if paired else 1
        # the scanned chunk read and written once, the carry read, the total written
        n_bytes = (2 * N * w * P * Tc + 2 * N * w * P) * 4
        n_ops = N * Tc * (combine_ops(D, paired) if kind == "filter" else smoother_combine_ops(D, paired))
        bound = bound_ms(n_bytes, n_ops)
        # in turns, uncarried, carried, carried, uncarried: a card's clocks
        # drift between readings of a few microseconds
        dev_u = [device_ms(torch, flushed(run_uncarried), 20)[0]]
        dev_c = [device_ms(torch, flushed(run_k), 20)[0] for _ in range(2)]
        dev_u.append(device_ms(torch, flushed(run_uncarried), 20)[0])
        dev_carried, dev_uncarried = sum(dev_c) / 2, sum(dev_u) / 2
        res = {
            "kind": kind, "paired": paired, "D": D, "lanes": N, "T_chunk": Tc, "planes": out_k.shape[1],
            "deterministic": deterministic(run_k, out_k), "max_abs_err": e_abs, "rel_err": e_rel,
            "total_rel_err": rel_err(total, total_p)[1],
            "rel_err_kernel_vs_f64_plain": rel_err(out_k.double(), out_64)[1],
            "rel_err_plain_vs_f64_plain": rel_err(out_p.double(), out_64)[1],
            "ms": time_cuda(torch, run_k, 50), "device_ms": dev_carried,
            "uncarried_device_ms": dev_uncarried, "carry_cost_ms": dev_carried - dev_uncarried,
            "device_ms_in_turn": {"uncarried": dev_u, "carried": dev_c},
            "plain_ms": time_cuda(torch, run_p, 1 if paired else 3), "bound_ms": bound[0], "bound_by": bound[1],
            "share_of_bound": bound[0] / dev_carried,
        }
        res["ok"] = (res["deterministic"] and max(e_rel, res["total_rel_err"]) <= RTOL_SCAN_NEW
                     and bool(torch.isfinite(out_k).all()) and res["share_of_bound"] <= 1.0)
        return res

    # (kind, D, lanes): the headline's time-sharded final pass and optimizer
    # (D = 2, 20 lanes), the pupil's (D = 3, 2 lanes: its loss's two lanes;
    # its final pass has one), and D = 1 on ten lanes (on no path)
    carry_res, carry_ops = {}, {}
    for kind, D, N_c in (("filter", 2, K_HEAD), ("smoother", 2, K_HEAD), ("filter", 3, 2), ("smoother", 3, 2),
                         ("filter", 1, 10), ("smoother", 1, 10)):
        carry_ops[(kind, D)] = carry_operands(kind, D, N_c, 2500)
        for paired in (False, True):
            carry_res[(kind, paired, D)] = carry_check(kind, D, paired, carry_ops[(kind, D)])

    # the whole sharded scan, four chunks of 10,000 steps, against the
    # unsharded kernel scan on the same (headline-shaped) elements
    sharded_scans = {}
    for kind in ("filter", "smoother"):
        planes_w, tangents_w = carry_ops[(kind, 2)][4:]
        chunks = [x.contiguous() for x in torch.tensor_split(planes_w, 4, dim=-1)]
        dchunks = [x.contiguous() for x in torch.tensor_split(tangents_w, 4, dim=-1)]
        sharded = pmesh.filter_prefix_sharded if kind == "filter" else pmesh.smoother_suffix_sharded
        sharded_p = pmesh.filter_prefix_paired_sharded if kind == "filter" else pmesh.smoother_suffix_paired_sharded
        whole = fused_filter.filter_prefix if kind == "filter" else fused_filter.smoother_suffix
        whole_p = fused_filter.filter_prefix_paired if kind == "filter" else fused_filter.smoother_suffix_paired
        got = torch.cat(sharded(chunks), dim=-1)
        got_p = torch.cat([torch.cat(p, dim=1) for p in sharded_p(chunks, dchunks)], dim=-1)
        want, want_p = whole(planes_w), torch.cat(whole_p(planes_w, tangents_w), dim=1)
        torch.cuda.synchronize()
        sharded_scans[kind] = {"float_rel_err": rel_err(got, want)[1], "paired_rel_err": rel_err(got_p, want_p)[1]}
    # ptxas's registers and spills of the scan's totals and downsweep
    # kernels, the carried instances (Lb1E) beside the uncarried (Lb0E)
    scan_ptxas = {k: v for k, v in ptxas_by_kernel(report.get("prefix_scan", (0, ""))[1]).items()
                  if "downsweep" in k or "totals" in k}
    emit({"phase": "parallel_carried_scan", "rtol": RTOL_SCAN_NEW,
          "instances": {f"{k}{'_paired' if p else ''}_d{d}": r for (k, p, d), r in carry_res.items()},
          "sharded_scan_4_chunks_T10000_vs_unsharded_kernel": sharded_scans, "ptxas": scan_ptxas, "card": card})
    if not all(r["ok"] for r in carry_res.values()):
        raise AssertionError("a carried scan instance disagrees with its plain version, or read past its bound")
    if max(v for r in sharded_scans.values() for v in r.values()) > RTOL_SCAN_NEW:
        raise AssertionError(f"a sharded scan disagrees with the unsharded kernel scan: {sharded_scans}")

    def with_iters(run):
        """(result, seconds, launch counts, Adam iterations per block from
        the optimizer's DEBUG report) of ``run()``."""
        handler, level, propagate = BlockIters(), core_log.level, core_log.propagate
        core_log.addHandler(handler)
        core_log.setLevel(logging.DEBUG)
        core_log.propagate = False
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            core_log.removeHandler(handler)
            core_log.setLevel(level)
            core_log.propagate = propagate
        return out, seconds, read_counts(), np.array(handler.iters)

    # the headline's operands (phase 5's prep), for the one-device
    # trajectories phase 17's rule reads and the float64 final-pass check
    arr_head = make_session(np, np.random.default_rng(0))
    raw_h = torch.as_tensor(arr_head[:, 0], device=dev)
    stats_h, ys_h, means_h, S0_h = _prep_singlecam(raw_h[..., 0], raw_h[..., 1], raw_h[..., 2], SEEDS_HEAD,
                                                   "median", "confidence_weighted_var")
    eye_h = torch.eye(2, device=dev).expand(K_HEAD, 2, 2).contiguous()
    ops_head = (ys_h, torch.zeros(K_HEAD, 2, device=dev), S0_h, eye_h, eye_h, eye_h, stats_h[..., 2:4].contiguous())

    def s_by_rule(s_got, it_got, s_one, it_one):
        """Phase 17's rule: each lane's s against the one-device run where
        both stopped at the same Adam iteration, else against the
        one-device trajectory (stop rule off) at the iteration where this
        lane stopped; the largest relative gap."""
        gaps = s_gap(s_got, s_one)
        for c in sorted(set(it_got[it_got != it_one].tolist())):
            traj = capped_opt(ops_head, -1.0, c)[0]
            lanes = (it_got != it_one) & (it_got == c)
            gaps[lanes] = s_gap(s_got[lanes], traj[lanes])
        return float(gaps.max()), int((it_got != it_one).sum())

    (df_one, s_one), wall_one, _, it_one = with_iters(
        lambda: eks_tpu_torch.ensemble_kalman_smoother_singlecam(ma, kps, device="cuda"))
    d64 = dict(dtype=torch.float64, device="cpu")
    par_runs, par_launches = {}, {}
    for setup, n_dev, ctx in setups:
        with ctx():
            tag = "" if setup.startswith("4_shards") else f"_{setup}"
            # headline, keypoint axis
            tm_k = {}
            (df_k, s_k), wall_k, launches_k, it_k = with_iters(
                lambda: eks_tpu_torch.ensemble_kalman_smoother_singlecam(ma, kps, device="cuda", devices=n_dev,
                                                                         timings=tm_k))
            gap_k, lanes_k = s_by_rule(s_k, it_k, s_one, it_one)
            table_k = sessions_table_gap(np, df_k, df_one)
            counts_ok_k = (launches_k[a_key(2, 2, True)] == sum(tm_k["adam_iters_per_shard"]) > 0
                           and launches_k["prefix_scan_filter"] == n_dev and launches_k["prefix_scan_smoother"] == n_dev
                           and not any(v for k, v in launches_k.items() if k.startswith("carry_")))
            par_launches["parallel_headline_keypoint" + tag] = launches_k
            par_runs["headline_keypoint" + tag] = {
                "wall_s": wall_k, "one_device_wall_s": wall_one, "adam_iters_per_shard": tm_k["adam_iters_per_shard"],
                "s_rel_gap_by_phase_17_rule": gap_k, "lanes_stopped_elsewhere": lanes_k, "table_gap": table_k,
                "launches": {k: v for k, v in launches_k.items() if v}, "counts_ok": counts_ok_k,
                "ok": (gap_k <= 1e-4 and counts_ok_k and table_k["columns_match"] and table_k["finite"]
                       and table_k["xy"] <= SEQ_ATOL_SESSIONS["xy"]
                       and table_k["var"] <= SEQ_ATOL_SESSIONS["posterior_var"]),
            }

            # headline, time axis: the staged loss over the sharded paired
            # scan, and the time-sharded final pass
            tm_t = {}
            (df_t, s_t), wall_t, launches_t, it_t = with_iters(
                lambda: eks_tpu_torch.ensemble_kalman_smoother_singlecam(ma, kps, device="cuda", devices=n_dev,
                                                                         partition="time", timings=tm_t))
            gap_t, lanes_t = s_by_rule(s_t, it_t, s_one, it_one)
            eye64 = torch.eye(2, **d64).expand(K_HEAD, 2, 2)
            ref_t, _ = seq_smoother_f64(torch, ys_h.to(**d64), torch.zeros(K_HEAD, 2, **d64), S0_h.to(**d64), eye64,
                                        torch.as_tensor(s_t, **d64)[:, None, None] * eye64, eye64,
                                        torch.clamp(stats_h[..., 2:4].transpose(0, 1).to(**d64), min=1e-12))
            x_ref_t = (ref_t.transpose(0, 1) + means_h.to(**d64)[None]).numpy()
            seq_gap_t = float(np.abs(df_t.to_numpy().reshape(T_HEAD, K_HEAD, 9)[..., :2] - x_ref_t).max())
            iters_t = tm_t.get("adam_iters", 0)
            counts_ok_t = (iters_t > 0 and launches_t[a_key(2, 2, True)] == 0
                           and launches_t["prefix_scan_filter_paired_d2"] == n_dev * iters_t
                           and launches_t["carry_filter_paired_d2"] == (n_dev - 1) * iters_t
                           and launches_t["prefix_scan_filter"] == n_dev and launches_t["prefix_scan_smoother"] == n_dev
                           and launches_t["carry_filter_d2"] == n_dev - 1
                           and launches_t["carry_smoother_d2"] == n_dev - 1)
            par_launches["parallel_headline_time" + tag] = launches_t
            par_runs["headline_time" + tag] = {
                "wall_s": wall_t, "one_device_wall_s": wall_one, "optimizer_s": tm_t.get("optimizer"),
                "final_pass_s": tm_t.get("final_pass"), "adam_iters": iters_t,
                "us_per_adam_iter": tm_t["optimizer"] / iters_t * 1e6 if iters_t else None,
                "s_rel_gap_by_phase_17_rule": gap_t, "lanes_stopped_elsewhere": lanes_t,
                "max_abs_err_vs_f64_sequential": seq_gap_t, "launches": {k: v for k, v in launches_t.items() if v},
                "counts_ok": counts_ok_t, "ok": gap_t <= 1e-4 and seq_gap_t <= 1e-2 and counts_ok_t,
            }

            # pupil: the bundled session's fixed-parameter golden, and the
            # solo session's optimizer capped, on the frame axis
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                df_pf, _, _, _ = eks_tpu_torch.fit_eks_pupil(
                    os.path.join(REPO, "data", "pupil"), os.path.join(tmp, "out.csv"),
                    smooth_params=[0.99, 0.98], device="cuda", devices=n_dev)
                wall_pf = time.perf_counter() - t0
            gap_pf, cols_pf = golden_gap(df_pf, "pupil_fixed")
            pupil_scan_calls = []
            tm_p1, tm_p = {}, {}
            (df_p1, s_p1), wall_p1, _, _ = with_iters(lambda: eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
                pupil_mas[0], names, safety_cap=CAP_PUPIL_22, device="cuda", timings=tm_p1))
            with recording(fused_filter, "chunk_total", pupil_scan_calls, first_only=True):
                (df_p, s_p), wall_p, launches_p, _ = with_iters(lambda: eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
                    pupil_mas[0], names, safety_cap=CAP_PUPIL_22, device="cuda", devices=n_dev, timings=tm_p))
            gap_p = float(np.max(np.abs(np.asarray(s_p) / np.asarray(s_p1) - 1.0)))
            table_gap_p = float(np.abs(df_p.to_numpy() - df_p1.to_numpy()).max())
            counts_ok_p = (launches_p["fused_nll_tv_paired"] == 0
                           and launches_p["prefix_scan_filter_paired_d3"] == n_dev * CAP_PUPIL_22
                           and launches_p["carry_filter_paired_d3"] == (n_dev - 1) * CAP_PUPIL_22
                           and launches_p["prefix_scan_filter_d3"] == n_dev
                           and launches_p["prefix_scan_smoother_d3"] == n_dev
                           and launches_p["carry_filter_d3"] == n_dev - 1 and launches_p["carry_smoother_d3"] == n_dev - 1)
            par_launches["parallel_pupil_time" + tag] = launches_p
            par_runs["pupil_time" + tag] = {
                "golden_pupil_fixed": {"max_abs_err": gap_pf, "atol": 1e-4, "columns_match": cols_pf,
                                       "wall_s": wall_pf},
                "capped_iters": CAP_PUPIL_22, "wall_s": wall_p, "one_device_wall_s": wall_p1,
                "optimizer_s": tm_p.get("optimizer"), "one_device_optimizer_s": tm_p1.get("optimizer"),
                "us_per_adam_iter": tm_p["optimizer"] / CAP_PUPIL_22 * 1e6,
                "s": list(map(float, s_p)), "one_device_s": list(map(float, s_p1)), "s_rel_gap": gap_p,
                "s_rtol": PUPIL_S_RTOL_22, "table_abs_gap_vs_one_device": table_gap_p,
                "launches": {k: v for k, v in launches_p.items() if v}, "counts_ok": counts_ok_p,
                "ok": (cols_pf and gap_pf <= 1e-4 and gap_p <= PUPIL_S_RTOL_22 and counts_ok_p
                       and bool(np.isfinite(df_p.to_numpy()).all())),
            }

            # the two-camera session and the calibrated rig on the keypoint
            # axis, capped as in phase 19 with the stop rule off, so both runs
            # take the same trajectory
            _, ys_c2, ev_c2, m0_c2, S0_c2, A_c2, Q_c2, C_c2, _ = mc_prep(CAMS_MC)
            ops_c2 = (ys_c2, m0_c2, S0_c2, A_c2, C_c2, Q_c2, ev_c2.transpose(0, 1))
            for name_c, ops_c, kw_c, checks in (
                    ("two_cameras_keypoint", ops_c2, {}, lambda lc: (
                        lc[a_key(3, 4, True)] == n_dev * CAP_CAL and lc["prefix_scan_filter_d3"] == n_dev
                        and lc["prefix_scan_smoother_d3"] == n_dev)),
                    ("calibrated_keypoint", ops_cal_all, dict(h_fn=h_card, x_init=x3_cal), lambda lc: (
                        lc["prefix_scan_filter_paired_d3"] == 3 * CAP_CAL * n_dev
                        and lc["prefix_scan_filter_d3"] == 13 * n_dev and lc["prefix_scan_smoother_d3"] == n_dev))):
                tm_1, tm_c = {}, {}
                (s_c1, ms_c1, Vs_c1), wall_c1, _, _ = with_iters(
                    lambda: run_kalman_smoother(*ops_c, safety_cap=CAP_CAL, tol=-1.0, timings=tm_1, **kw_c))
                (s_c, ms_c, Vs_c), wall_c, launches_c, _ = with_iters(
                    lambda: run_kalman_smoother(*ops_c, safety_cap=CAP_CAL, tol=-1.0, devices=n_dev, timings=tm_c,
                                                **kw_c))
                gap_s = float(s_gap(s_c, s_c1).max())
                gap_m = max(rel_err(ms_c, ms_c1)[1], rel_err(Vs_c, Vs_c1)[1])
                counts_ok_c = bool(checks(launches_c)) and not any(
                    v for k, v in launches_c.items() if k.startswith("carry_"))
                par_launches["parallel_" + name_c + tag] = launches_c
                par_runs[name_c + tag] = {
                    "capped_iters": CAP_CAL, "wall_s": wall_c, "one_device_wall_s": wall_c1,
                    "adam_iters_per_shard": tm_c.get("adam_iters_per_shard"), "s_rel_gap": gap_s,
                    "moments_rel_gap": gap_m, "launches": {k: v for k, v in launches_c.items() if v},
                    "counts_ok": counts_ok_c, "ok": gap_s <= 1e-4 and gap_m <= 5e-4 and counts_ok_c,
                }

            # the command line: singlecam --devices n on the bundled session,
            # both axes, against the committed golden
            cli_gaps = {}
            with tempfile.TemporaryDirectory() as tmp:
                for part in ("keypoint", "time"):
                    argv = ["eks-tpu-torch", "singlecam", "--input-dir", os.path.join(REPO, "data", "singlecam"),
                            "--save-dir", os.path.join(tmp, part), "--s", "2.0", "--devices", str(n_dev),
                            "--partition", part]
                    t0 = time.perf_counter()
                    with mock.patch.object(sys, "argv", argv):
                        cli_main()
                    df_cli = pd.read_csv(os.path.join(tmp, part, "eks_singlecam.csv"), header=[0, 1, 2], index_col=0)
                    gap_cli, cols_cli = golden_gap(df_cli, "singlecam_fixed")
                    cli_gaps[part] = {"max_abs_err": gap_cli, "atol": 1e-4, "columns_match": cols_cli,
                                      "wall_s": time.perf_counter() - t0}
            par_runs["cli_singlecam" + tag] = {**cli_gaps, "ok": all(
                g["columns_match"] and g["max_abs_err"] <= 1e-4 for g in cli_gaps.values())}
    pupil_planes, pupil_kind, pupil_tangents = pupil_scan_calls[0]  # chunk_total(planes, kind, tangents)
    if pupil_kind != "filter" or pupil_tangents is None:
        raise AssertionError(f"the pupil path's first chunk scan is not its loss's paired filter: {pupil_kind}")
    pupil_scan = scan_check("filter", pupil_planes, pupil_tangents)
    seconds22 = time.perf_counter() - t_phase22
    emit({"phase": "parallel_runs", "runs": par_runs, "pupil_chunk_paired_filter_scan": pupil_scan,
          "card": card, "seconds": seconds22})
    emit({"phase": "parallel_budget", "seconds": seconds22, "limit_s": 180.0, "within": seconds22 <= 180.0,
          "script_elapsed_s": time.perf_counter() - _T_START, "card": card})
    bad = [k for k, r in par_runs.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"sharded runs disagree with their one-device runs or goldens: {bad}")
    if not pupil_scan["ok"]:
        raise AssertionError("the paired D = 3 filter scan disagrees with its plain version on a pupil chunk")

    # --------------------------------------------------------------- 10 ---
    # the main paths run kernels A and C in their paired forms only (the
    # optimizers' forward-mode gradients); the plain forms' numbers are in
    # the lines of phases 2, 6 and 12. Kernel C's and kernel B's D = 3
    # filter numbers are at the solo pupil path's shapes (2 lanes, 1 lane);
    # the smoother instances' at the headline's (D = 2, 20 lanes) and the
    # two-camera session's (D = 3, 10 lanes); the paired lane-batched scan's
    # at the six-camera optimizer's (10 lanes). `launches` is the count of the
    # first path named beside it. `ms` is CUDA events around back-to-back
    # calls, which on a slow host is the host's dispatch rate once a kernel is
    # shorter than its wrapper's Python; `device_ms` is the kernels' own
    # device time per call under the profiler. Kernel A's rows, the D = 1
    # scans' and those of the paired smoother and the paired filter at D = 2
    # (on no path) give as `launches` the sum of every main path's count of
    # that instance, and as `launches_by_path` each path's
    c1, b31 = c_res[1], b3[1]
    path_counts = {"headline": launches, "pupil": launches_pupil, "pupil_sessions": launches_sessions,
                   "multicam": launches_mc, "multicam_six_cameras": launches_w,
                   **{f"multicam_n_latent_{k}": launches_nl[k] for k in N_LATENTS},
                   "multicam_calibrated": launches_cal, "singlecam_sessions": launches_sc, **par_launches}
    src = "eks_tpu_torch/csrc/"

    def counted(key):
        """A row's launches of the instance counted as ``key``: in all, and
        by main path."""
        by_path = {p: c[key] for p, c in path_counts.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    kernels = [{
        "name": "fused_nll_paired", "route": "cuda", "source": src + "fused_nll.cu",
        "replaces": "eks_tpu/ops/pallas_nll.py:171", "path": "headline", "shape": [2, 2],
        **counted(a_key(2, 2, True)), "max_abs_err": max(e_pll, e_dll),
        "ms": ms_ap, "device_ms": dev_ap, "plain_ms": ms_ap_plain, "bound_ms": b_ap[0], "bound_by": b_ap[1],
        "library_ms": None,
    }, {
        "name": "prefix_scan_filter", "route": "cuda", "source": src + "prefix_scan.cu",
        "replaces": "eks_tpu/ops/pallas_filter.py:187",
        "launches": launches["prefix_scan_filter"],
        "launches_by_path": counted("prefix_scan_filter")["launches_by_path"], "max_abs_err": e_b,
        "ms": ms_b, "device_ms": dev_b, "plain_ms": ms_b_plain, "bound_ms": b_b[0], "bound_by": b_b[1],
        "library_ms": None,
    }, {
        "name": "fused_nll_tv_paired", "route": "cuda", "source": src + "fused_nll_tv.cu",
        "replaces": "eks_tpu/ops/pallas_nll.py:541",
        "launches": launches_pupil["fused_nll_tv_paired"],
        "launches_sessions": launches_sessions["fused_nll_tv_paired"],
        "max_abs_err": max(c1["paired_ll_max_abs_err"], c1["paired_dll_max_abs_err"]),
        "ms": c1["paired_ms"], "device_ms": sum(c1["paired_device_ms_by_kernel"].values()),
        "plain_ms": c1["paired_plain_ms"],
        "bound_ms": c1["paired_bound_ms"], "bound_by": c1["paired_bound_by"],
        "library_ms": None,
    }, {
        "name": "prefix_scan_filter_d3", "route": "cuda", "source": src + "prefix_scan.cu",
        "replaces": "eks_tpu/ops/pallas_filter.py:187",
        "launches": launches_pupil["prefix_scan_filter_d3"],
        "launches_sessions": launches_sessions["prefix_scan_filter_d3"],
        "max_abs_err": b31["max_abs_err"], "ms": b31["ms"], "device_ms": b31["device_ms"],
        "plain_ms": b31["plain_ms"],
        "launches_multicam": launches_mc["prefix_scan_filter_d3"],
        "launches_by_path": counted("prefix_scan_filter_d3")["launches_by_path"],
        "bound_ms": b31["bound_ms"], "bound_by": b31["bound_by"], "library_ms": None,
    }, {
        "name": "fused_nll_paired_d3_o4", "route": "cuda", "source": src + "fused_nll.cu",
        "replaces": "eks_tpu/ops/pallas_nll.py:171", "path": "multicam", "shape": [3, 4],
        **counted(a_key(3, 4, True)),
        "max_abs_err": max(a3["paired_ll_max_abs_err"], a3["paired_dll_max_abs_err"]),
        "ms": a3["paired_ms"], "device_ms": a3["paired_device_ms"], "plain_ms": a3["paired_plain_ms"],
        "bound_ms": a3["paired_bound_ms"], "bound_by": a3["paired_bound_by"], "library_ms": None,
    }, {
        "name": "prefix_scan_smoother", "route": "cuda", "source": src + "prefix_scan.cu",
        "replaces": "eks_tpu/ops/pallas_filter.py:136", "path": "headline",
        "launches": launches["prefix_scan_smoother"],
        "launches_by_path": counted("prefix_scan_smoother")["launches_by_path"], "max_abs_err": sm2["max_abs_err"],
        "ms": sm2["ms"], "device_ms": sm2["device_ms"], "plain_ms": sm2["plain_ms"], "bound_ms": sm2["bound_ms"],
        "bound_by": sm2["bound_by"], "library_ms": None,
    }, {
        "name": "prefix_scan_smoother_d3", "route": "cuda", "source": src + "prefix_scan.cu",
        "replaces": "eks_tpu/ops/pallas_filter.py:136", "path": "multicam",
        "launches": launches_mc["prefix_scan_smoother_d3"],
        "launches_pupil": launches_pupil["prefix_scan_smoother_d3"],
        "launches_six_cameras": launches_w["prefix_scan_smoother_d3"],
        "launches_by_path": counted("prefix_scan_smoother_d3")["launches_by_path"],
        "max_abs_err": sm3["max_abs_err"], "ms": sm3["ms"], "device_ms": sm3["device_ms"],
        "plain_ms": sm3["plain_ms"],
        "bound_ms": sm3["bound_ms"], "bound_by": sm3["bound_by"], "library_ms": None,
    }, {
        "name": "prefix_scan_filter_paired_d3", "route": "cuda", "source": src + "prefix_scan.cu",
        "replaces": "eks_tpu/ops/pallas_filter.py:252", "path": "multicam_six_cameras",
        "launches": launches_w["prefix_scan_filter_paired_d3"],
        "launches_by_path": counted("prefix_scan_filter_paired_d3")["launches_by_path"],
        "max_abs_err": fp3["max_abs_err"],
        "ms": fp3["ms"], "device_ms": fp3["device_ms"], "plain_ms": fp3["plain_ms"], "bound_ms": fp3["bound_ms"],
        "bound_by": fp3["bound_by"], "library_ms": None,
    }] + [{
        "name": name, "route": "cuda", "source": src + "prefix_scan.cu", "replaces": "eks_tpu/ops/pallas_filter.py:169",
        "path": None, "shape": shape, **counted(key),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
    } for name, key, shape, r in (
        ("prefix_scan_filter_paired_d2", "prefix_scan_filter_paired_d2", "headline", fp2),
        ("prefix_scan_smoother_paired_d2", "prefix_scan_smoother_paired_d2", "headline", sp2),
        ("prefix_scan_smoother_paired_d3", "prefix_scan_smoother_paired_d3", "two_cameras", sp3),
        ("prefix_scan_smoother_paired_d3_1_lane", "prefix_scan_smoother_paired_d3", "pupil", sm_pupil_paired))]
    # the instances at the shapes of the sessions path (80 lanes) and of the
    # calibrated path (5 lanes), held in phases 19 and 20 on those paths' own
    # operands; `launches` is that path's count of the instance
    kernels += [{
        "name": "fused_nll_paired_80_lanes", "route": "cuda", "source": src + "fused_nll.cu",
        "replaces": "eks_tpu/ops/pallas_nll.py:171", "path": "singlecam_sessions", "shape": [2, 2], "lanes": 80,
        "launches": launches_sc[a_key(2, 2, True)],
        "max_abs_err": max(a80["paired_ll_max_abs_err"], a80["paired_dll_max_abs_err"]), "ms": a80["ms"],
        "device_ms": a80["device_ms"], "plain_ms": a80["plain_ms"], "bound_ms": a80["bound_ms"],
        "bound_by": a80["bound_by"], "library_ms": None,
    }] + [{
        "name": name, "route": "cuda", "source": src + "prefix_scan.cu", "replaces": replaces, "path": path,
        "lanes": r["lanes"], "launches": counts[key], "max_abs_err": max(x["max_abs_err"] for x in rs),
        "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
    } for name, key, replaces, path, counts, rs in (
        ("prefix_scan_filter_80_lanes", "prefix_scan_filter", "eks_tpu/ops/pallas_filter.py:187",
         "singlecam_sessions", launches_sc, [sc_scans["filter_prefix"]]),
        ("prefix_scan_smoother_80_lanes", "prefix_scan_smoother", "eks_tpu/ops/pallas_filter.py:136",
         "singlecam_sessions", launches_sc, [sc_scans["smoother_suffix"]]),
        ("prefix_scan_filter_paired_d3_calibrated", "prefix_scan_filter_paired_d3", "eks_tpu/ops/pallas_filter.py:252",
         "multicam_calibrated", launches_cal, cal_scans["filter_prefix_paired"]),
        ("prefix_scan_filter_d3_calibrated", "prefix_scan_filter_d3", "eks_tpu/ops/pallas_filter.py:187",
         "multicam_calibrated", launches_cal, cal_scans["filter_prefix"]),
        ("prefix_scan_smoother_d3_calibrated", "prefix_scan_smoother_d3", "eks_tpu/ops/pallas_filter.py:136",
         "multicam_calibrated", launches_cal, cal_scans["smoother_suffix"]),
    ) for r in (rs[-1],)]
    # kernel A's plain forms (on no path: the optimizers run the paired ones)
    # at the two shapes of phases 2 and 12, and both forms of its other
    # instances (phase 16): at (1, 4) and (2, 4) the paired form is on the
    # n_latent 1 and 2 paths of phase 17. A row's `path` is the first path
    # that launched it, None where none did
    a_src = {"route": "cuda", "source": src + "fused_nll.cu", "replaces": "eks_tpu/ops/pallas_nll.py:171",
             "library_ms": None}

    def first_path(row):
        return next((p for p, n in row["launches_by_path"].items() if n), None)

    def a_row(name, d, o, paired, **fields):
        counts = counted(a_key(d, o, paired))
        return {"name": name, "shape": [d, o], "path": first_path(counts), **counts, **fields, **a_src}

    kernels += [
        a_row("fused_nll", 2, 2, False, max_abs_err=e_ll, ms=ms_a, device_ms=dev_a, plain_ms=ms_a_plain,
              bound_ms=b_a[0], bound_by=b_a[1]),
        a_row("fused_nll_d3_o4", 3, 4, False, max_abs_err=ea_ll, ms=a3["ms"], device_ms=a3["device_ms"],
              plain_ms=a3["plain_ms"], bound_ms=a3["bound_ms"], bound_by=a3["bound_by"]),
    ]
    for key, r in a_new.items():
        kernels += [
            a_row(f"fused_nll_paired_{key}", r["D"], r["O"], True,
                  max_abs_err=max(r["paired_ll_max_abs_err"], r["paired_dll_max_abs_err"]), ms=r["paired_ms"],
                  device_ms=r["paired_device_ms"], plain_ms=r["paired_plain_ms"], bound_ms=r["paired_bound_ms"],
                  bound_by=r["paired_bound_by"]),
            a_row(f"fused_nll_{key}", r["D"], r["O"], False, max_abs_err=r["ll_max_abs_err"], ms=r["ms"],
                  device_ms=r["device_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"]),
        ]
    for key, r in scans_1.items():
        count_key = "prefix_scan_" + key
        scan_counts = counted(count_key)
        kernels.append({
            "name": count_key, "route": "cuda", "source": src + "prefix_scan.cu",
            "replaces": ("eks_tpu/ops/pallas_filter.py:169" if "paired" in key else
                         "eks_tpu/ops/pallas_filter.py:187" if key.startswith("filter") else
                         "eks_tpu/ops/pallas_filter.py:136"),
            "path": first_path(scan_counts), **scan_counts,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    # the carried scan (phase 22): phase A and the carried downsweep of a
    # chunk of a time-sharded scan, which replace no Pallas kernel (the JAX
    # package carries the time-sharded scan's combines with XLA
    # collectives); `device_ms` is both phases with the L2 flushed between
    # calls, `uncarried_device_ms` the uncarried scan of the same chunk;
    # `launches` sums the time-axis paths' carried downsweeps; and the
    # paired D = 3 filter scan at the pupil's time-sharded loss (2 lanes,
    # one chunk)
    for (kind, paired, d), r in carry_res.items():
        kernels.append({
            "name": carry_key(kind, paired, d), "route": "cuda", "kernel": "prefix_scan carried downsweep",
            "source": src + "prefix_scan.cu", "replaces": "none", "lanes": r["lanes"], "T_chunk": r["T_chunk"],
            **counted(carry_key(kind, paired, d)), "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "uncarried_device_ms": r["uncarried_device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    kernels.append({
        "name": "prefix_scan_filter_paired_d3_pupil_chunk", "route": "cuda", "source": src + "prefix_scan.cu",
        "replaces": "eks_tpu/ops/pallas_filter.py:252", "path": "parallel_pupil_time", "lanes": pupil_scan["lanes"],
        "T": pupil_scan["T"], "launches": par_launches["parallel_pupil_time"]["prefix_scan_filter_paired_d3"],
        "max_abs_err": pupil_scan["max_abs_err"], "ms": pupil_scan["ms"], "device_ms": pupil_scan["device_ms"],
        "plain_ms": pupil_scan["plain_ms"], "bound_ms": pupil_scan["bound_ms"], "bound_by": pupil_scan["bound_by"],
        "library_ms": None,
    })
    emit({"launches": {p: {k: v for k, v in c.items() if v} for p, c in path_counts.items()}})
    print(gpu_name_power(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
