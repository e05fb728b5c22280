"""Sequential Kalman filter and RTS smoother over many lanes at once.

The model of every lane: ``x_0 ~ N(m0, S0)``, ``x_{t+1} = A x_t + w_t`` with
``w_t ~ N(0, Q)``, ``y_t = C x_t + v_t`` with ``v_t ~ N(0, diag(r_t))``;
``y_0`` is taken against the prior. The filter takes the O observations of
a step one at a time, which for a diagonal ``R`` gives the same posterior
and the same log-likelihood as the joint update, with no matrix inverse;
each update is in Joseph form, ``(I - k cᵀ) P (I - k cᵀ)ᵀ + r k kᵀ``, which
keeps the covariance positive where a lower precision would not.
Time runs in a Python loop; each step is a few batched operations over all
lanes, so the cost is set by the number of steps, not of lanes.
"""

from __future__ import annotations

import math

import torch

from reference.precision import Precision

_LOG_2PI = math.log(2.0 * math.pi)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def kalman_filter(ys, m0, S0, A, Q, C, r, p: Precision, keep: int = 0):
    """Log-likelihood (N,) of the observations ``ys`` (N, T, O) under each
    lane's model, with ``r`` (N, O) constant or (N, T, O) per step; with
    ``keep`` > 0 also the filtered means (T, keep, D) and covariances
    (T, keep, D, D) of the first ``keep`` lanes."""
    q = p.q
    N, T, O = ys.shape
    ys_t = q(ys).transpose(0, 1).contiguous()  # (T, N, O)
    r_t = q(r if r.dim() == 3 else r[:, None, :].expand(N, T, O)).transpose(0, 1).contiguous()
    A, Q, C = q(A), q(Q), q(C)
    At = A.transpose(-1, -2)
    m, P = q(m0), q(S0)
    ll = torch.zeros(N, dtype=p.dtype, device=ys.device)
    eye = torch.eye(A.shape[-1], dtype=p.dtype, device=ys.device)
    ms, Ps = [], []
    for t in range(T):
        for o in range(O):
            c = C[:, o, :]  # (N, D)
            Pc = q(_mv(P, c))
            s = q((c * Pc).sum(-1) + r_t[t, :, o])
            v = q(ys_t[t, :, o] - (c * m).sum(-1))
            ll = q(ll - 0.5 * q(_LOG_2PI + torch.log(s) + v * v / s))
            k = q(Pc / s[:, None])
            m = q(m + k * v[:, None])
            IKC = q(eye - k[:, :, None] * c[:, None, :])
            P = q(q(q(IKC @ P) @ IKC.transpose(-1, -2)) + q(r_t[t, :, o, None, None] * k[:, :, None] * k[:, None, :]))
        if keep:
            ms.append(m[:keep])
            Ps.append(P[:keep])
        m = q(_mv(A, m))
        P = q(q(A @ P) @ At + Q)
    if keep:
        return ll, torch.stack(ms), torch.stack(Ps)
    return ll


def rts_smoother(ms, Ps, A, Q, p: Precision):
    """Smoothed means (N, T, D) and covariances (N, T, D, D) from the
    filtered moments (T, N, D) and (T, N, D, D) of ``kalman_filter``."""
    q = p.q
    A, Q = q(A), q(Q)
    At = A.transpose(-1, -2)
    m_s, P_s = ms[-1], Ps[-1]
    out_m, out_P = [m_s], [P_s]
    for t in range(ms.shape[0] - 2, -1, -1):
        AP = q(A @ Ps[t])
        P_pred = q(AP @ At + Q)
        G = q(torch.linalg.solve_ex(P_pred, AP)[0].transpose(-1, -2))
        m_s = q(ms[t] + _mv(G, q(m_s - _mv(A, ms[t]))))
        P_s = q(Ps[t] + q(G @ q(P_s - P_pred)) @ G.transpose(-1, -2))
        out_m.append(m_s)
        out_P.append(P_s)
    return torch.stack(out_m[::-1], dim=1), torch.stack(out_P[::-1], dim=1)
