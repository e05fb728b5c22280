"""Multi-device smoothing: the public façade over keypoint-axis and
time-axis sharding.

Counterpart of ``eks_tpu/parallel/mesh.py``. A mesh is a tuple of
``torch.device`` (``ops/shards.py::make_mesh``); it may name one device more
than once, which is how eight shards run on the CPU in the tests and four
shards on one card. Nothing inside the package imports this module: the
entry points reach the shards through ``core.run_kalman_smoother(devices=)``.

Keypoint axis (``partition="keypoint"``, the default): every keypoint's
optimizer and smoothing lane is independent, so ``core`` splits the block
axis over the mesh (``core.optimize_blocks_sharded`` and
``core.smooth_all_sharded``: ``ops/shards.py::split_leading``, uneven
shards, no padding lanes; a block of keypoints that share s is never split)
and each shard runs the single-device optimizer and final pass on its own
device, through the same kernels, with no communication. Each shard's
optimizer loop stops when its own lanes converge. ``pad_and_shard_leading``
keeps the JAX package's padding (lane 0 repeated) for callers that want
equal shards.

Time axis (``partition="time"``): the frame axis is split into nearly equal
chunks, one a shard (``ops/shards.py::TimeShards``), and every scan of the
loss and the final pass runs over them with carries across the chunks
(``ops/shards.py``'s sharded scans, which this package re-exports).
"""

from __future__ import annotations

import numpy as np
import torch

from eks_tpu_torch.core import _device_constant_r, optimize_blocks_sharded, smooth_all_sharded
from eks_tpu_torch.ops.filters import kalman_smoother_parallel
from eks_tpu_torch.ops.shards import Mesh, TimeShards, split_leading

__all__ = [
    "optimize_and_smooth_sharded",
    "pad_and_shard_leading",
    "shard_leading",
    "shard_time",
    "smooth_time_sharded",
]


# --------------------------------------------------------------------------- #
# keypoint axis
# --------------------------------------------------------------------------- #
def _pad_leading(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad axis 0 to a multiple by repeating the first element."""
    pad = -x.shape[0] % multiple
    return torch.cat([x, x[:1].expand(pad, *x.shape[1:])]) if pad else x


def shard_leading(mesh: Mesh, x: torch.Tensor) -> list:
    """``x`` cut into ``len(mesh)`` equal shards along its leading axis, shard
    i on ``mesh[i]``: ``split_leading`` under the JAX package's name, for a
    leading length that divides the mesh size (pad it with
    ``pad_and_shard_leading``)."""
    if x.shape[0] % len(mesh):
        raise ValueError(f"leading axis {x.shape[0]} is not divisible by the mesh size {len(mesh)}")
    return [ops[0] for ops in split_leading(mesh, [x])[1]]


def pad_and_shard_leading(mesh: Mesh, operands: list) -> tuple[list, int]:
    """Pad every operand's leading axis to a multiple of the mesh size,
    repeating element 0 (whose results callers slice away), and shard each
    over the mesh. Returns (per operand its list of shards, the original
    leading length)."""
    n_real = int(operands[0].shape[0])
    return [shard_leading(mesh, _pad_leading(torch.as_tensor(x), len(mesh))) for x in operands], n_real


def optimize_and_smooth_sharded(
    ys: np.ndarray,  # (K, T, O)
    m0s: np.ndarray,  # (K, D)
    S0s: np.ndarray,  # (K, D, D)
    As: np.ndarray,  # (K, D, D)
    Qs: np.ndarray,  # (K, D, D)
    Cs: np.ndarray,  # (K, O, D)
    ensemble_vars: np.ndarray,  # (K, T, O) per-step variances
    mesh: Mesh,
    s_log_init: np.ndarray | None = None,  # (K,)
    lr: float = 0.25,
    tol: float = 1e-2,
    safety_cap: int = 300,
    min_R_var: float = 1e-4,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The full smoothing step, per-keypoint s optimization then the final
    smoothing pass, with the keypoint axis sharded over the mesh; singleton
    blocks (one s per keypoint). Host arrays in, host arrays out:
    (s_finals (K,), ms (K, T, D), Vs (K, T, D, D))."""
    home = mesh[0]

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=home)

    ys_t, m0_t, S0_t, A_t, Q_t, C_t, ev_t = map(up, (ys, m0s, S0s, As, Qs, Cs, ensemble_vars))
    K = ys_t.shape[0]
    r_const = _device_constant_r(ev_t, float(min_R_var))
    s_log0 = up(np.zeros(K) if s_log_init is None else s_log_init)
    ones = torch.ones((K, 1), dtype=ys_t.dtype, device=home)
    s_log_f, _, _ = optimize_blocks_sharded(
        mesh, [x[:, None] for x in (ys_t, r_const, m0_t, S0_t, A_t, Q_t, C_t)] + [ones, s_log0, None],
        lr=float(lr), s_lo=-8.0, s_hi=8.0, tol=float(tol), safety_cap=int(safety_cap),
    )
    s_finals = torch.exp(torch.clamp(s_log_f, -8.0, 8.0))
    rs = torch.clamp(ev_t, min=1e-12)
    ms, Vs = smooth_all_sharded(mesh, [ys_t, m0_t, S0_t, A_t, Q_t, C_t, s_finals, rs])
    return s_finals.cpu().numpy(), ms.cpu().numpy(), Vs.cpu().numpy()


# --------------------------------------------------------------------------- #
# time axis
# --------------------------------------------------------------------------- #
def shard_time(mesh: Mesh, operands: list, time_axes: list) -> list:
    """Every operand cut along its time axis ``time_axes[i]`` into the mesh's
    chunks (None replicates it): per operand the list of its chunks, chunk
    j on ``mesh[j]``. A T that does not divide the mesh is split into nearly
    equal chunks (the JAX package replicates it instead)."""
    out = []
    for x, ax in zip(operands, time_axes):
        x = torch.as_tensor(x)
        out.append([x.to(d) for d in mesh] if ax is None else TimeShards(mesh, x.shape[ax]).split(x, ax))
    return out


def smooth_time_sharded(
    ys: np.ndarray,  # (T, O)
    m0: np.ndarray,
    S0: np.ndarray,
    A: np.ndarray,
    Q: np.ndarray,
    C: np.ndarray,
    r_diag: np.ndarray,  # (T, O)
    mesh: Mesh,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sequence-parallel smoothing of ONE keypoint with its time axis sharded
    over the mesh. T must be divisible by the mesh size, as in the JAX
    package. Returns host arrays (log-likelihood, smoothed means (T, D),
    covariances (T, D, D))."""
    T = ys.shape[0]
    if T % len(mesh):
        raise ValueError(f"T={T} must be divisible by the mesh size {len(mesh)}")

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=mesh[0])[None]

    r = torch.clamp(up(r_diag), min=1e-12)
    res = kalman_smoother_parallel(*map(up, (ys, m0, S0, A, Q, C)), r, TimeShards(mesh, T), compute_ll=True)
    return (res.log_likelihood[0].cpu().numpy(), res.smoothed_means[0].cpu().numpy(),
            res.smoothed_covs[0].cpu().numpy())
