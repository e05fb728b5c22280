"""The Kalman filter's log-likelihood by a parallel prefix scan over time
(Särkkä and García-Fernández, 2021), differentiable by autograd.

The model is ``reference/kalman.py``'s with a constant diagonal ``R``; the
element of step 0 is the posterior of x_0 given y_0 under the prior, every
later element the affine map of one transition and update. A Hillis-Steele
scan (log2 T sweeps over all steps at once) gives every filtered moment,
from which the predictive moments and the log-likelihood follow step by
step. The same sums as the sequential filter in another order: float64
agrees with it to rounding (the benchmark's tests hold it to that).
"""

from __future__ import annotations

import math

import torch

from reference.precision import Precision


def _t(x):
    return x.transpose(-1, -2)


def small_inv(X: torch.Tensor) -> torch.Tensor:
    """Inverses of the D x D matrices X (..., D, D): for D <= 3 by the
    adjugate, elementwise (a batched inverse of millions of tiny matrices
    is slow on a GPU); else ``torch.linalg.inv_ex``."""
    D = X.shape[-1]
    if D == 1:
        return 1.0 / X
    if D == 2:
        a, b, c, d = X[..., 0, 0], X[..., 0, 1], X[..., 1, 0], X[..., 1, 1]
        det = a * d - b * c
        return torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) / det[..., None, None]
    if D == 3:
        x = [[X[..., i, j] for j in range(3)] for i in range(3)]
        cof = [[x[(i + 1) % 3][(j + 1) % 3] * x[(i + 2) % 3][(j + 2) % 3]
                - x[(i + 1) % 3][(j + 2) % 3] * x[(i + 2) % 3][(j + 1) % 3] for j in range(3)] for i in range(3)]
        det = x[0][0] * cof[0][0] + x[0][1] * cof[0][1] + x[0][2] * cof[0][2]
        adj = torch.stack([torch.stack([cof[j][i] for j in range(3)], -1) for i in range(3)], -2)
        return adj / det[..., None, None]
    return torch.linalg.inv_ex(X)[0]


def _combine(e, f, q):
    """The composition of element ``e`` (earlier) and ``f`` (later)."""
    Ae, be, Ce, he, Je = e
    Af, bf, Cf, hf, Jf = f
    eye = torch.eye(Ae.shape[-1], dtype=Ae.dtype, device=Ae.device)
    M = q(small_inv(eye + q(Ce @ Jf)))
    AfM = q(Af @ M)
    AeMt = q(_t(Ae) @ _t(M))
    return (
        q(AfM @ Ae),
        q((AfM @ q(be + (Ce @ hf[..., None])[..., 0])[..., None])[..., 0] + bf),
        q(q(q(AfM @ Ce) @ _t(Af)) + Cf),
        q((AeMt @ q(hf - (Jf @ be[..., None])[..., 0])[..., None])[..., 0] + he),
        q(q(q(AeMt @ Jf) @ Ae) + Je),
    )


def filter_loglik(ys, m0, S0, A, Q, C, r, p: Precision) -> torch.Tensor:
    """Log-likelihood (N,) of ys (N, T, O) under each lane's model, with a
    constant diagonal R given as r (N, O)."""
    q = p.q
    N, T, O = ys.shape
    D = m0.shape[-1]
    ys, m0, S0, A, Q, C, R = q(ys), q(m0), q(S0), q(A), q(Q), q(C), torch.diag_embed(q(r))
    eye = torch.eye(D, dtype=ys.dtype, device=ys.device)

    def gain(P):  # the update of a predictive covariance P: K, (I - K C), S⁻¹
        S = q(q(C @ P) @ _t(C) + R)
        Si = q(torch.linalg.inv_ex(S)[0])  # one O x O matrix a lane
        K = q(q(P @ _t(C)) @ Si)
        return K, q(eye - K @ C), Si

    K0, IKC0, _ = gain(S0)
    b0 = q(m0 + (K0 @ q(ys[:, 0] - (C @ m0[..., None])[..., 0])[..., None])[..., 0])
    C0 = q(IKC0 @ S0)
    K, IKC, Si = gain(Q)
    At_Ct_Si = q(q(_t(A) @ _t(C)) @ Si)  # (N, D, O)
    y1 = ys[:, 1:, :, None]  # (N, T-1, O, 1)
    ex = lambda x: x[:, None].expand(N, T - 1, *x.shape[1:])  # noqa: E731
    elems = [
        torch.cat([torch.zeros_like(A)[:, None], ex(q(IKC @ A))], 1),
        torch.cat([b0[:, None], q(ex(K) @ y1)[..., 0]], 1),
        torch.cat([C0[:, None], ex(q(IKC @ Q))], 1),
        torch.cat([torch.zeros_like(m0)[:, None], q(ex(At_Ct_Si) @ y1)[..., 0]], 1),
        torch.cat([torch.zeros_like(A)[:, None], ex(q(At_Ct_Si @ q(C @ A)))], 1),
    ]
    d = 1
    while d < T:  # inclusive scan: step t takes the composition of steps 0..t
        later = [x[:, d:] for x in elems]
        earlier = [x[:, :-d] for x in elems]
        done = _combine(earlier, later, q)
        elems = [torch.cat([x[:, :d], y], 1) for x, y in zip(elems, done)]
        d *= 2
    mf, Pf = elems[1], elems[2]  # filtered moments (N, T, D), (N, T, D, D)
    m = torch.cat([m0[:, None], q((A[:, None] @ mf[:, :-1, :, None])[..., 0])], 1)  # predictive
    P = torch.cat([S0[:, None], q(q(A[:, None] @ Pf[:, :-1]) @ _t(A)[:, None] + Q[:, None])], 1)
    # each step's log-density, its observations taken one at a time
    terms = torch.zeros(ys.shape[:2], dtype=ys.dtype, device=ys.device)
    for o in range(O):
        c = C[:, None, o, :]  # (N, 1, D)
        Pc = q((P * c[..., None, :]).sum(-1))
        s = q((c * Pc).sum(-1) + r[:, None, o])
        v = q(ys[..., o] - (c * m).sum(-1))
        terms = q(terms - 0.5 * q(math.log(2.0 * math.pi) + torch.log(s) + v * v / s))
        if o + 1 < O:
            k = q(Pc / s[..., None])
            m = q(m + k * v[..., None])
            P = q(P - k[..., :, None] * Pc[..., None, :])
    return terms.sum(1)
