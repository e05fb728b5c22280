"""Batched DLT triangulation.

Counterpart of ``eks_tpu/geometry/triangulate.py``: ONE vectorized pass over
all points. Each point's (2C, 4) DLT system is built from undistorted
normalized coordinates and the extrinsics, and its null direction is found
on the 4 x 4 normal matrix G = AᵀA by shifted inverse iteration with an
unrolled Cholesky factorization, every step one elementwise op over the
batch. Components orthogonal to the null direction are damped by ~(eps/λ_i)
per iteration (eps = 1e-6 · mean diag), so a handful of iterations reaches
working precision.

NaN observations are masked by zeroing their rows (a zero row contributes
nothing to AᵀA, which is exactly exclusion); points with fewer than 2 valid
views return NaN.
"""

from __future__ import annotations

import torch

from eks_tpu_torch.ops.linalg import _chol_solve_unrolled, _chol_unrolled

__all__ = ["triangulate_dlt"]

_INV_ITERS = 8


def triangulate_dlt(
    points: torch.Tensor,  # (C, N, 2) undistorted normalized coords
    extrinsics: torch.Tensor,  # (C, 3, 4) [R | t]
) -> torch.Tensor:
    """DLT: (C, N, 2) -> (N, 3), NaN-masked, batched over N."""
    x, y = points[..., 0], points[..., 1]  # (C, N)
    valid = torch.isfinite(x) & torch.isfinite(y)
    zero = torch.zeros_like(x)
    xs, ys = torch.where(valid, x, zero), torch.where(valid, y, zero)

    # rows: x * P[2] - P[0] and y * P[2] - P[1], per camera per point
    P0, P1, P2 = (extrinsics[:, i, None, :] for i in range(3))  # (C, 1, 4)
    w = valid[..., None].to(points.dtype)
    A = torch.cat([(xs[..., None] * P2 - P0) * w, (ys[..., None] * P2 - P1) * w], dim=0)  # (2C, N, 4)
    A = A.transpose(0, 1)  # (N, 2C, 4)

    # normal matrix + scale-invariant shift (the absolute floor keeps
    # all-zero systems factorizable; their output is masked to NaN below)
    G = torch.einsum("nri,nrj->nij", A, A)
    eps = 1e-6 * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / 4.0 + 1e-12
    Gs = G + eps[:, None, None] * torch.eye(4, dtype=G.dtype, device=G.device)

    # shifted inverse iteration from e4 (finite points have nonzero
    # homogeneous w, so the start is never orthogonal to the null direction)
    L = _chol_unrolled(Gs)
    v = torch.zeros((A.shape[0], 4), dtype=G.dtype, device=G.device)
    v[:, 3] = 1.0
    for _ in range(_INV_ITERS):
        v = _chol_solve_unrolled(L, v, vector=True)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    xyz = v[:, :3] / v[:, 3:4]

    enough = valid.sum(dim=0) >= 2
    return torch.where(enough[:, None], xyz, torch.full_like(xyz, float("nan")))
