"""Sequential Kalman/extended-Kalman filter and RTS smoother, batched over
lanes.

Counterpart of ``eks_tpu/ops/kalman.py``: the carry
holds the one-step-ahead predictive distribution, initialised with the prior
``(m0, S0)`` (``y_0`` is assimilated against the prior with no transition),
the per-step marginal log-likelihood accumulates at the predictive stage, the
covariance update is the plain ``P - K S Kᵀ`` with a Cholesky PSD solve for
the gain, and the backward pass re-derives the one-step prediction from the
filtered moments.

The time loop is a Python loop over T steps: this is the port's parity
oracle (run in float64 on the CPU by the tests) and the ``sequential=True``
path, not a hot path. Every argument carries a leading lane dimension N.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from eks_tpu_torch.ops.linalg import jvp, mvn_logpdf, psd_solve

__all__ = ["FilterResult", "SmootherResult", "emission_jacobian", "emission_parts", "kalman_filter", "kalman_smoother"]


class FilterResult(NamedTuple):
    log_likelihood: Optional[torch.Tensor]  # (N,)
    filtered_means: torch.Tensor  # (N, T, D)
    filtered_covs: torch.Tensor  # (N, T, D, D)


class SmootherResult(NamedTuple):
    log_likelihood: Optional[torch.Tensor]
    filtered_means: torch.Tensor
    filtered_covs: torch.Tensor
    smoothed_means: torch.Tensor  # (N, T, D)
    smoothed_covs: torch.Tensor  # (N, T, D, D)


def _as_time_varying(r: torch.Tensor, T: int) -> torch.Tensor:
    """(N, O) constant or (N, T, O) diagonal noise -> (N, T, O)."""
    if r.ndim == 2:
        r = r[:, None, :].expand(r.shape[0], T, r.shape[1])
    return r


def _diag(v: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(v)


def emission_parts(h_fn: Callable) -> tuple[Callable, tuple]:
    """(fn, tensors) with ``h_fn(x) == fn(*tensors, x)``: a
    ``functools.partial`` over tensors (the camera projector) is taken apart,
    any other emission has no tensors. Under forward mode an operation
    between a tensor with a tangent and one without (a closed-over tensor or
    a Python number) takes a slow decomposed path on the host, hundreds of
    microseconds a call against tens; with its tensors apart, a caller gives
    them zero tangents."""
    if (isinstance(h_fn, functools.partial) and not h_fn.keywords
            and all(torch.is_tensor(a) for a in h_fn.args)):
        return h_fn.func, tuple(h_fn.args)
    return (lambda x: h_fn(x)), ()


def emission_jacobian(h_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Jacobians (..., O, D) of the emission ``h_fn: (..., D) -> (..., O)``
    at the points x (..., D): one ``torch.func.jvp`` with the D unit
    tangents stacked on a leading axis, what ``torch.func.jacfwd`` computes,
    and the emission's tensors (``emission_parts``) given zero tangents."""
    fn, consts = emission_parts(h_fn)
    D = x.shape[-1]
    flat = x.reshape(1, -1, D)
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    points = flat.expand(D, -1, -1).contiguous()
    units = eye[:, None, :].expand_as(points).contiguous()
    # c - c, not zeros_like: under an enclosing jvp the zeros then carry a
    # tangent of their own, and stay off the slow path there too
    zeros = tuple(c - c for c in consts)
    J = jvp(fn, (*consts, points), (*zeros, units))[1]  # (D, P, O)
    return J.permute(1, 2, 0).reshape(*x.shape[:-1], J.shape[-1], D)


def kalman_filter(
    ys: torch.Tensor,  # (N, T, O)
    m0: torch.Tensor,  # (N, D)
    S0: torch.Tensor,  # (N, D, D)
    A: torch.Tensor,  # (N, D, D)
    Q: torch.Tensor,  # (N, D, D)
    C: Optional[torch.Tensor],  # (N, O, D) linear emission
    r_diag: torch.Tensor,  # (N, T, O) or (N, O)
    h_fn: Optional[Callable] = None,  # nonlinear emission (..., D) -> (..., O)
) -> FilterResult:
    """Forward (extended) Kalman filter with per-step log-likelihood
    accumulation; with ``h_fn`` the emission is linearized at each step's
    predicted mean and ``C`` is not read."""
    T = ys.shape[1]
    r = _as_time_varying(r_diag, T)
    At = A.transpose(-1, -2)
    ll = torch.zeros(ys.shape[0], dtype=ys.dtype, device=ys.device)
    m_pred, P_pred = m0, S0
    ms, Ps = [], []
    for t in range(T):
        y_t = ys[:, t]
        if h_fn is None:
            H, hx = C, (C @ m_pred[..., None])[..., 0]
        else:
            H, hx = emission_jacobian(h_fn, m_pred), h_fn(m_pred)
        S = H @ P_pred @ H.transpose(-1, -2) + _diag(r[:, t])
        ll = ll + mvn_logpdf(y_t, hx, S)
        K = psd_solve(S, H @ P_pred).transpose(-1, -2)
        m_filt = m_pred + (K @ (y_t - hx)[..., None])[..., 0]
        P_filt = P_pred - K @ S @ K.transpose(-1, -2)
        ms.append(m_filt)
        Ps.append(P_filt)
        m_pred = (A @ m_filt[..., None])[..., 0]
        P_pred = A @ P_filt @ At + Q
    return FilterResult(ll, torch.stack(ms, dim=1), torch.stack(Ps, dim=1))


def kalman_smoother(
    ys: torch.Tensor,
    m0: torch.Tensor,
    S0: torch.Tensor,
    A: torch.Tensor,
    Q: torch.Tensor,
    C: Optional[torch.Tensor],
    r_diag: torch.Tensor,
    h_fn: Optional[Callable] = None,
) -> SmootherResult:
    """Forward (extended) filter + backward RTS smoothing pass."""
    fr = kalman_filter(ys, m0, S0, A, Q, C, r_diag, h_fn=h_fn)
    ms, Ps = fr.filtered_means, fr.filtered_covs
    T = ms.shape[1]
    At = A.transpose(-1, -2)
    m_s, P_s = ms[:, -1], Ps[:, -1]
    sm, sP = [m_s], [P_s]
    for t in range(T - 2, -1, -1):
        m_f, P_f = ms[:, t], Ps[:, t]
        m_pred = (A @ m_f[..., None])[..., 0]
        P_pred = Q + A @ P_f @ At
        G = psd_solve(P_pred, A @ P_f).transpose(-1, -2)
        m_s = m_f + (G @ (m_s - m_pred)[..., None])[..., 0]
        P_s = P_f + G @ (P_s - P_pred) @ G.transpose(-1, -2)
        sm.append(m_s)
        sP.append(P_s)
    sm = torch.stack(sm[::-1], dim=1)
    sP = torch.stack(sP[::-1], dim=1)
    return SmootherResult(fr.log_likelihood, ms, Ps, sm, sP)
