"""Small-matrix linear algebra shared by the Kalman code.

Counterpart of ``eks_tpu/ops/linalg.py``: Cholesky-based PSD solves with
symmetrization and a 1e-9 diagonal boost, closed-form inverses for D <= 3,
and Cholesky-based Gaussian log-densities without jitter. Matrices are tiny
(2x2 .. 8x8) and batched over every leading dimension, so the Cholesky and
the triangular solves are unrolled over the matrix entries: each step is one
elementwise op over the whole batch, the same on the CPU and on the card.
"""

from __future__ import annotations

import functools
import math
import operator
import threading

import torch

__all__ = ["symmetrize", "psd_solve", "small_inv", "mvn_logpdf"]

_LOG_2PI = math.log(2.0 * math.pi)


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.transpose(-1, -2))


def _chol_unrolled(a: torch.Tensor) -> list[list]:
    """Lower Cholesky factor of (..., O, O) as a list-of-lists of (...,)
    tensors (entries above the diagonal are None)."""
    o = a.shape[-1]
    L: list[list] = [[None] * o for _ in range(o)]
    for i in range(o):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return L


def _chol_solve_unrolled(L: list[list], b: torch.Tensor, vector: bool) -> torch.Tensor:
    """Solve (L Lᵀ) x = b given the unrolled factor; b is (..., O) if
    ``vector`` else (..., O, M)."""
    o = len(L)
    if vector:
        bs = [b[..., i] for i in range(o)]
    else:
        bs = [b[..., i, :] for i in range(o)]
        L = [[e[..., None] if e is not None else None for e in row] for row in L]
    y: list = [None] * o
    for i in range(o):
        s = bs[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x: list = [None] * o
    for i in range(o - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, o):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1) if vector else torch.stack(x, dim=-2)


def psum(terms):
    """Sum of tensors without the leading Python 0 of ``sum``, which under
    forward mode takes the slow path ``one_plus`` describes."""
    return functools.reduce(operator.add, terms)


_JVP_LOCK = threading.RLock()


def jvp(fn, primals, tangents):
    """``torch.func.jvp`` under a process-wide lock. Forward-mode AD keeps
    its dual level per process, not per thread: one thread leaving its jvp
    ends the level another thread's jvp is inside ("no level exists"). A
    caller's threads take turns here; a jvp nested inside another in one
    thread re-enters."""
    with _JVP_LOCK:
        return torch.func.jvp(fn, primals, tangents)


def one_plus(x: torch.Tensor) -> torch.Tensor:
    """1 + x through the Scalar overload of add. Under forward mode
    (``torch.func.jvp``) an operation between a tensor with a tangent and a
    Python number, or a tensor without a tangent, takes a slow decomposed
    path on the host, hundreds of microseconds a call against tens; the
    Scalar overload does not."""
    return torch.ops.aten.add.Scalar(x, 1.0)


def psd_solve(a: torch.Tensor, b: torch.Tensor, diagonal_boost: float = 1e-9) -> torch.Tensor:
    """Solve ``a x = b`` for symmetric positive-definite ``a`` via Cholesky,
    after symmetrizing and adding ``diagonal_boost`` to the diagonal."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a = symmetrize(a) + diagonal_boost * eye
    return _chol_solve_unrolled(_chol_unrolled(a), b, vector=b.ndim == a.ndim - 1)


def small_inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a small (..., D, D) matrix; closed form (adjugate over
    determinant) for D <= 3, the library inverse above."""
    d = a.shape[-1]
    if d == 1:
        return 1.0 / a
    if d == 2:
        a00, a01 = a[..., 0, 0], a[..., 0, 1]
        a10, a11 = a[..., 1, 0], a[..., 1, 1]
        det = a00 * a11 - a01 * a10
        adj = torch.stack(
            [torch.stack([a11, -a01], dim=-1), torch.stack([-a10, a00], dim=-1)],
            dim=-2,
        )
        return adj / det[..., None, None]
    if d == 3:
        a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
        a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
        a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
        c00 = a11 * a22 - a12 * a21
        c01 = a12 * a20 - a10 * a22
        c02 = a10 * a21 - a11 * a20
        c10 = a02 * a21 - a01 * a22
        c11 = a00 * a22 - a02 * a20
        c12 = a01 * a20 - a00 * a21
        c20 = a01 * a12 - a02 * a11
        c21 = a02 * a10 - a00 * a12
        c22 = a00 * a11 - a01 * a10
        det = a00 * c00 + a01 * c01 + a02 * c02
        adj = torch.stack(
            [
                torch.stack([c00, c10, c20], dim=-1),
                torch.stack([c01, c11, c21], dim=-1),
                torch.stack([c02, c12, c22], dim=-1),
            ],
            dim=-2,
        )
        return adj / det[..., None, None]
    return torch.linalg.inv(a)


def mvn_logpdf(y: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """log N(y; mean, cov) via Cholesky, no jitter; batched over leading dims."""
    n = y.shape[-1]
    d = y - mean
    L = _chol_unrolled(cov)
    z: list = [None] * n
    for i in range(n):
        s = d[..., i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    logdet = psum(torch.log(L[i][i]) for i in range(n))
    quad = psum(zi * zi for zi in z)
    return -0.5 * quad - logdet - 0.5 * n * _LOG_2PI
