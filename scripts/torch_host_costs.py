"""Host costs behind the calibrated family's times and its float64 oracle.

    python3 scripts/torch_host_costs.py [--device cpu|cuda] [--reps 20] [--root DIR]

On the device named, with the bundled two-camera calibration
(data/multicam/calibration.toml) as the emission h: (..., 3) -> (..., 4), it
times (median milliseconds over ``--reps`` calls, the card synchronized
inside each) one call of h and one of ``ops.kalman.emission_jacobian``
(one ``torch.func.jvp`` over the stacked unit tangents, what the port's EKF runs)
at 5 points (one sequential step of five lanes) and at 2 x 10,000 points
(one relinearization of two lanes). On the host it times a batched float64
Cholesky of five 6 x 6 matrices (one step of chip_smoke.py's float64
sequential oracle) with torch's default thread count and with one thread,
and holds chip_smoke.py's central-difference Jacobian against
``emission_jacobian`` in float64. Then it times one evaluation of the
calibrated optimizer's paired loss (``ops.filters.ekf_nll_paired_batched``,
three sweeps: a warm-started Adam iteration) on chip_smoke.py's calibrated
rig (5 keypoints x 10,000 frames x 3 cameras, O = 6, D = 3), and counts the
operations that took the host's slow forward-mode path (a tensor with a
tangent meeting a Python number or a tensor without one: calls of
``torch._refs._maybe_broadcast``). ``--root`` imports ``eks_tpu_torch`` and
``chip_smoke`` from another checkout, so one call can time a parent and a
change on the same host. Prints one JSON line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def median_ms(torch, fn, reps, sync):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def calibrated_loss(np, torch, chip_smoke, dev, reps, sync) -> dict:
    """Median milliseconds of one paired calibrated loss (three sweeps) on
    chip_smoke's calibrated rig, and its slow forward-mode operations."""
    import torch._refs as refs

    from eks_tpu_torch.geometry import make_projection_from_camgroup
    from eks_tpu_torch.ops.filters import ekf_nll_paired_batched

    group, arr = chip_smoke.calibrated_rig(np, np.random.default_rng(0))
    T, K = arr.shape[2], arr.shape[3]
    h = make_projection_from_camgroup(group, device=dev)[0]
    ys = torch.as_tensor(arr[..., :2].mean(0).transpose(2, 1, 0, 3).reshape(K, T, -1), device=dev)
    D = 3
    eye = torch.eye(D, device=dev).expand(K, D, D)
    m0 = torch.tensor([0.0, 0.0, 0.0], device=dev).expand(K, D).contiguous()
    S0, A, Q = (eye * 0.01).contiguous(), eye.contiguous(), (eye * 1e-5).contiguous()
    r = torch.ones(ys.shape[0], ys.shape[2], device=dev)
    x0 = m0[:, None].expand(K, T, D).contiguous()

    def loss():
        return ekf_nll_paired_batched(ys, m0, S0, A, Q, Q, h, r, x0, n_sweeps=3)

    slow = [0]
    inner = refs._maybe_broadcast

    def counted(*a, **k):
        slow[0] += 1
        return inner(*a, **k)

    loss()
    refs._maybe_broadcast = counted
    try:
        loss()
    finally:
        refs._maybe_broadcast = inner
    return {"calibrated_loss_shape": [K, T, ys.shape[2], D],
            "calibrated_loss_ms": median_ms(torch, loss, reps, sync),
            "calibrated_loss_slow_forward_ops": slow[0]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--root", default=REPO)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    import chip_smoke
    from eks_tpu_torch.geometry import CameraGroup, make_projection_from_camgroup
    from eks_tpu_torch.ops.kalman import emission_jacobian

    dev = torch.device(args.device)
    sync = dev.type == "cuda"
    group = CameraGroup.load(os.path.join(REPO, "data", "multicam", "calibration.toml"))
    h = make_projection_from_camgroup(group, device=dev)[0]
    gen = torch.Generator().manual_seed(0)
    out = {"root": os.path.abspath(args.root), "device": str(dev), "threads": torch.get_num_threads(),
           "reps": args.reps}
    for name, shape in (("5_points", (5, 3)), ("20000_points", (2, 10_000, 3))):
        x = (torch.randn(*shape, generator=gen) * 0.1).to(dev)
        out[f"h_ms_{name}"] = median_ms(torch, lambda: h(x), args.reps, sync)
        out[f"jacobian_ms_{name}"] = median_ms(torch, lambda: emission_jacobian(h, x), args.reps, sync)

    S = torch.eye(6, dtype=torch.float64).expand(5, 6, 6) * 2.0 + 0.1
    out["cholesky_ms_default_threads"] = median_ms(torch, lambda: torch.linalg.cholesky(S), args.reps, False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out["cholesky_ms_one_thread"] = median_ms(torch, lambda: torch.linalg.cholesky(S), args.reps, False)
    torch.set_num_threads(threads)

    h64 = make_projection_from_camgroup(group, device="cpu", dtype=torch.float64)[0]
    m = torch.randn(5, 3, generator=gen, dtype=torch.float64) * 0.1
    J, J_fd = emission_jacobian(h64, m), chip_smoke.fd_jacobian(torch, h64, m)
    out["fd_jacobian_max_abs_gap"] = float((J_fd - J).abs().max())
    out["fd_jacobian_max_rel_gap"] = float(((J_fd - J).abs() / J.abs().clamp(min=1.0)).max())
    out["jacobian_max_abs"] = float(J.abs().max())

    out.update(calibrated_loss(np, torch, chip_smoke, dev, max(3, args.reps // 4), sync))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
