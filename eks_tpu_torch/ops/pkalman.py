"""The plane algebra of the parallel-prefix (associative-scan) Kalman filter
and RTS smoother: the plain twin of every kernel, and the bottom of the
port's ops layer (it imports nothing of the kernels, the shards or the
filters).

Counterpart of ``eks_tpu/ops/pkalman.py``. The linear Gaussian filter and
smoother are associative operators (Särkkä & García-Fernández, *Temporal
Parallelization of Bayesian Smoothers*, IEEE TAC 2021), evaluated with a
log-depth scan over the time axis.

Layout: scan elements are carried as stacked scalar planes, one (..., T)
row per matrix entry, in a (..., P, T) tensor. The filtering element
``(A, b, C, eta, J)`` has P = 3D² + 2D planes (A row-major, then b, C, eta,
J); the smoothing element ``(E, g, L)`` has 2D² + D. Every combine is
elementwise work over the time axis with the D x D algebra unrolled in
Python, the same formulas the CUDA kernels unroll in registers
(``eks_tpu_torch/csrc/filter_algebra.cuh``); beyond D = 3, where no kernel
runs, the filter combine takes the matrix form (``_combine_filter_mats``).

Here: ``associative_scan`` and the combines, the scalar-table layouts and
packers of kernels A and C, the scan elements made from them and from the
covariance and information forms (filtering and smoothing), the epilogues
(predictive moments and log-densities), and the staged NLLs
(``_staged_nll``, ``_table_nll_tv``) with their scan passed in. The kernel
wrappers' plain versions (``ops/fused_filter.py``, ``ops/fused_nll.py``)
are built from these; the filters that run the kernels over time shards
are ``ops/filters.py``.
"""

from __future__ import annotations

import math

import torch

from eks_tpu_torch.ops.kalman import emission_jacobian
from eks_tpu_torch.ops.linalg import jvp, mvn_logpdf, one_plus, psd_solve, psum, small_inv

__all__ = [
    "associative_scan",
    "filter_state_dim",
    "paired_scaled_q",
    "smoother_state_dim",
]

_LOG_2PI = math.log(2.0 * math.pi)


# --------------------------------------------------------------------------- #
# log-depth associative scan over the last axis
# --------------------------------------------------------------------------- #
def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    n_odd = odd.shape[-1]
    both = torch.stack([even[..., :n_odd], odd], dim=-1).flatten(-2)
    if even.shape[-1] > n_odd:
        both = torch.cat([both, even[..., n_odd:]], dim=-1)
    return both


def _scan(fn, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n < 2:
        return x
    odd = _scan(fn, fn(x[..., 0:-1:2], x[..., 1::2]))
    if n % 2 == 0:
        even = fn(odd[..., :-1], x[..., 2::2])
    else:
        even = fn(odd, x[..., 2::2])
    return _interleave(torch.cat([x[..., :1], even], dim=-1), odd)


def associative_scan(fn, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of the associative ``fn`` over the last axis of ``x``
    in O(log T) depth, with the same association order as
    ``jax.lax.associative_scan``. ``reverse=True`` scans the flipped
    sequence, so ``fn``'s first argument is the element later in time."""
    if reverse:
        return _scan(fn, x.flip(-1)).flip(-1)
    return _scan(fn, x)


# --------------------------------------------------------------------------- #
# plane matrix algebra (nested lists of (..., T) tensors)
# --------------------------------------------------------------------------- #
def _mat_planes(x, off, d):
    return [[x[..., off + i * d + j, :] for j in range(d)] for i in range(d)]


def _vec_planes(x, off, d):
    return [x[..., off + i, :] for i in range(d)]


def _pmatmul(a, b):
    return [
        [psum(a[i][k] * b[k][j] for k in range(len(b))) for j in range(len(b[0]))]
        for i in range(len(a))
    ]


def _pmatvec(a, x):
    return [psum(a[i][k] * x[k] for k in range(len(x))) for i in range(len(a))]


def _pt(a):
    return [[a[j][i] for j in range(len(a))] for i in range(len(a[0]))]


def _padd(a, b):
    return [[a[i][j] + b[i][j] for j in range(len(a[0]))] for i in range(len(a))]


def _pvadd(x, y):
    return [x[i] + y[i] for i in range(len(x))]


def _pvsub(x, y):
    return [x[i] - y[i] for i in range(len(x))]


def _peye_plus(a):
    return [
        [one_plus(a[i][j]) if i == j else a[i][j] for j in range(len(a[0]))]
        for i in range(len(a))
    ]


def _pinv(a):
    """Closed-form inverse of a D <= 3 plane matrix (adjugate / det)."""
    d = len(a)
    if d == 1:
        return [[torch.reciprocal(a[0][0])]]
    if d == 2:
        (a00, a01), (a10, a11) = a
        inv = torch.reciprocal(a00 * a11 - a01 * a10)
        return [[a11 * inv, -a01 * inv], [-a10 * inv, a00 * inv]]
    if d == 3:
        (a00, a01, a02), (a10, a11, a12), (a20, a21, a22) = a
        c00 = a11 * a22 - a12 * a21
        c01 = a12 * a20 - a10 * a22
        c02 = a10 * a21 - a11 * a20
        inv = torch.reciprocal(a00 * c00 + a01 * c01 + a02 * c02)
        c10 = a02 * a21 - a01 * a22
        c11 = a00 * a22 - a02 * a20
        c12 = a01 * a20 - a00 * a21
        c20 = a01 * a12 - a02 * a11
        c21 = a02 * a10 - a00 * a12
        c22 = a00 * a11 - a01 * a10
        return [
            [c00 * inv, c10 * inv, c20 * inv],
            [c01 * inv, c11 * inv, c21 * inv],
            [c02 * inv, c12 * inv, c22 * inv],
        ]
    raise NotImplementedError(f"plane inverse only implemented for D<=3, got {d}")


def _flat(*blocks) -> torch.Tensor:
    """Nested plane lists -> one stacked (..., P, T) tensor, in order."""
    rows = []
    for blk in blocks:
        for entry in blk:
            rows.extend(entry if isinstance(entry, list) else [entry])
    return torch.stack(rows, dim=-2)


# --------------------------------------------------------------------------- #
# filtering elements
# --------------------------------------------------------------------------- #
_FILTER_D = {3 * d * d + 2 * d: d for d in range(1, 9)}


def filter_state_dim(n_planes: int) -> int:
    """State dimension D of a filtering-element table with ``n_planes``."""
    if n_planes not in _FILTER_D:
        raise ValueError(f"{n_planes} planes is not a filtering element (3D²+2D)")
    return _FILTER_D[n_planes]


def _filter_parts(x, D):
    dd = D * D
    return (
        _mat_planes(x, 0, D),
        _vec_planes(x, dd, D),
        _mat_planes(x, dd + D, D),
        _vec_planes(x, 2 * dd + D, D),
        _mat_planes(x, 2 * dd + 2 * D, D),
    )


def _combine_filter(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Associative combination of filtering elements; x1 precedes x2 in
    time. ``Zt = Zᵀ`` equals inv(I + J2 C1) because C1 and J2 are
    symmetric. Beyond D = 3 the same terms in matrix form
    (``_combine_filter_mats``)."""
    D = filter_state_dim(x1.shape[-2])
    if D > 3:
        return _combine_filter_mats(x1, x2, D)
    A1, b1, C1, n1, J1 = _filter_parts(x1, D)
    A2, b2, C2, n2, J2 = _filter_parts(x2, D)
    Z = _pinv(_peye_plus(_pmatmul(C1, J2)))
    Zt = _pt(Z)
    A2Z = _pmatmul(A2, Z)
    A = _pmatmul(A2Z, A1)
    b = _pvadd(_pmatvec(A2Z, _pvadd(b1, _pmatvec(C1, n2))), b2)
    C = _padd(_pmatmul(_pmatmul(A2Z, C1), _pt(A2)), C2)
    A1tZt = _pmatmul(_pt(A1), Zt)
    eta = _pvadd(_pmatvec(A1tZt, _pvsub(n2, _pmatvec(J2, b1))), n1)
    J = _padd(_pmatmul(_pmatmul(A1tZt, J2), A1), J1)
    return _flat(A, b, C, eta, J)


def _combine_filter_mats(x1: torch.Tensor, x2: torch.Tensor, D: int) -> torch.Tensor:
    """``_combine_filter`` on (..., T, D, D) matrices (``small_inv``: the
    closed form to D = 3, the library inverse above), as the JAX package's
    ``_combine_filter_aos`` runs every D that its Pallas scan does not take:
    at D > 3 an unrolled plane algebra is hundreds of small operations a
    combine. The carries of a time-sharded scan take it at every D."""
    dd = D * D

    def parts(x):
        t = x.transpose(-1, -2)
        mat = lambda lo: t[..., lo:lo + dd].unflatten(-1, (D, D))  # noqa: E731
        vec = lambda lo: t[..., lo:lo + D, None]  # noqa: E731
        return mat(0), vec(dd), mat(dd + D), vec(2 * dd + D), mat(2 * dd + 2 * D)

    A1, b1, C1, n1, J1 = parts(x1)
    A2, b2, C2, n2, J2 = parts(x2)
    Z = small_inv(torch.eye(D, dtype=x1.dtype, device=x1.device) + C1 @ J2)
    A2Z = A2 @ Z
    A1tZt = A1.transpose(-1, -2) @ Z.transpose(-1, -2)
    out = (A2Z @ A1, A2Z @ (b1 + C1 @ n2) + b2, A2Z @ C1 @ A2.transpose(-1, -2) + C2,
           A1tZt @ (n2 - J2 @ b1) + n1, A1tZt @ J2 @ A1 + J1)
    return torch.cat([x.flatten(-2) for x in out], dim=-1).transpose(-1, -2)


def _aos_planes(*leaves) -> torch.Tensor:
    """(N, T, D[, D]) leaves -> (N, P, T) planes, leaf entries row-major."""
    N, T = leaves[0].shape[:2]
    return torch.cat([x.reshape(N, T, -1) for x in leaves], dim=-1).transpose(1, 2).contiguous()


def _set_first(row: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Replace time step 0 of an (N, T) plane with the (N,) ``first``."""
    return torch.cat([first[:, None].to(row.dtype), row[:, 1:]], dim=1)


def _first_step_mask(T: int, device, first: bool = True) -> torch.Tensor:
    """(T,) booleans, true at step 0 of a sequence's first chunk only."""
    return torch.arange(T, device=device) == (0 if first else -1)


# --------------------------------------------------------------------------- #
# constant-R elements from a per-lane scalar table: every time-invariant
# quantity of the filter, the operand of kernel A (ops/fused_nll.py)
# --------------------------------------------------------------------------- #
def _scalar_offsets(D: int, O: int) -> tuple[dict, int]:
    """Layout of the flat per-lane scalar vector. Row-major blocks; the same
    layout as ``eks_tpu/ops/pallas_nll.py`` (46 floats at D = O = 2)."""
    dd = D * D
    offs, n = {}, 0
    for name, size in (
        ("A_el", dd),      # (I - K C) A
        ("K_c", D * O),    # steady gain: b_t = K_c y_t
        ("C_el", dd),      # (I - K C) Q
        ("M_cT", D * O),   # (S⁻¹ C A)ᵀ: eta_t = M_cᵀ y_t
        ("J_el", dd),      # (C A)ᵀ S⁻¹ C A
        ("b_first", D),    # t=0 posterior mean (assimilates y_0 vs the prior)
        ("C_first", dd),   # t=0 posterior covariance
        ("A", dd),         # epilogue: transition
        ("Q", dd),         # epilogue: process noise (already s-scaled)
        ("Cobs", O * D),   # epilogue: emission
        ("r", O),          # epilogue: constant diagonal observation noise
        ("m0", D),         # epilogue: prior mean (t=0 predictive)
        ("S0", dd),        # epilogue: prior covariance
    ):
        offs[name] = n
        n += size
    return offs, n


def _table_dims(n_scal: int, O: int, offsets=_scalar_offsets) -> int:
    """State dimension D of an (N, n_scal) table for O observations, in the
    layout ``offsets`` (the constant-R one, or ``_scalar_offsets_tv``)."""
    for D in range(1, 9):
        if offsets(D, O)[1] == n_scal:
            return D
    raise ValueError(f"a {n_scal}-entry scalar table fits no D for O={O}")


def _table_blocks(table: torch.Tensor, offs: dict, *named_shapes) -> tuple:
    """The (N, *shape) blocks of an (N, n_scal) table at ``offs[name]``, one
    per (name, shape) pair."""
    N = table.shape[0]
    return tuple(
        table[:, offs[name]:offs[name] + math.prod(shape)].reshape(N, *shape)
        for name, shape in named_shapes
    )


def _pack_scalars(y0, m0, S0, A, Q, C, r) -> torch.Tensor:
    """(N, n_scal) scalar tables, one row per lane: y0 (N, O), m0 (N, D),
    S0/A/Q (N, D, D), C (N, O, D), r (N, O)."""
    D = m0.shape[-1]
    eye = torch.eye(D, dtype=y0.dtype, device=y0.device)
    Ct = C.transpose(-1, -2)
    CQ = C @ Q
    CA = C @ A
    S_c = CQ @ Ct + torch.diag_embed(r)
    K_c = psd_solve(S_c, CQ).transpose(-1, -2)  # (N, D, O)
    IKC = eye - K_c @ C
    M_c = psd_solve(S_c, CA)  # (N, O, D)
    A_el = IKC @ A
    C_el = IKC @ Q
    J_el = CA.transpose(-1, -2) @ M_c
    S_0 = C @ S0 @ Ct + torch.diag_embed(r)
    K_0 = psd_solve(S_0, C @ S0).transpose(-1, -2)
    b_first = m0 + (K_0 @ (y0 - (C @ m0[..., None])[..., 0])[..., None])[..., 0]
    C_first = (eye - K_0 @ C) @ S0
    N = y0.shape[0]
    return torch.cat([
        x.reshape(N, -1) for x in (
            A_el, K_c, C_el, M_c.transpose(-1, -2), J_el, b_first, C_first,
            A, Q, C, r, m0, S0,
        )
    ], dim=-1)


def paired_scaled_q(s_log, Q, b_max: int, s_lo: float, s_hi: float):
    """(s Q, d(s Q)/d log s) of N = n_blocks * b_max lanes, s =
    exp(clamp(log s, s_lo, s_hi)) of the lane's block: s_log (n_blocks,),
    Q (N, D, D). Forward mode; the tangent is zero outside the bounds."""
    N, D = Q.shape[0], Q.shape[-1]
    QB = Q.reshape(s_log.shape[0], b_max, D, D)

    def scaled_q(sl):
        s = torch.exp(torch.clamp(sl, s_lo, s_hi))
        return (s[:, None, None, None] * QB).reshape(N, D, D)

    return jvp(scaled_q, (s_log,), (torch.ones_like(s_log),))


def _unpack_scalars(table: torch.Tensor, D: int, O: int):
    """The raw (m0, S0, A, Q, C, r) blocks of an (N, n_scal) table; they ride
    verbatim, so values and tangents both round-trip exactly."""
    return _table_blocks(
        table, _scalar_offsets(D, O)[0], ("m0", (D,)), ("S0", (D, D)), ("A", (D, D)),
        ("Q", (D, D)), ("Cobs", (O, D)), ("r", (O,)),
    )


def _table_planes(table: torch.Tensor, y: torch.Tensor, D: int, first: bool = True) -> torch.Tensor:
    """(N, P, T) filtering-element planes built from the scalar table and the
    observation planes y (N, O, T), row for row what kernel A builds: every
    element matrix is time-invariant, b and eta are O-term combinations of
    the observation columns, and t = 0 assimilates y_0 against the prior.
    Without ``first`` (a later chunk of a time-sharded sequence) step 0 is
    an ordinary step."""
    O = y.shape[1]
    offs, _ = _scalar_offsets(D, O)
    T = y.shape[-1]
    at_first = _set_first if first else (lambda row, _: row)

    def W(name, k):
        return table[:, offs[name] + k, None]

    def const(name, k, value):
        return at_first(W(name, k).expand(-1, T), value)

    zero = torch.zeros_like(table[:, 0])
    rows = [const("A_el", k, zero) for k in range(D * D)]
    for d in range(D):  # b = K_c y_t | b_first
        b = psum(W("K_c", d * O + o) * y[:, o] for o in range(O))
        rows.append(at_first(b, table[:, offs["b_first"] + d]))
    rows += [const("C_el", k, table[:, offs["C_first"] + k]) for k in range(D * D)]
    for d in range(D):  # eta = M_cᵀ y_t, zero at t=0
        e = psum(W("M_cT", d * O + o) * y[:, o] for o in range(O))
        rows.append(at_first(e, zero))
    rows += [const("J_el", k, zero) for k in range(D * D)]
    return torch.stack(rows, dim=1)


# --------------------------------------------------------------------------- #
# time-varying-R elements from a per-lane scalar table: the operand of
# kernel C (ops/fused_nll.py), the pupil optimizer's loss
# --------------------------------------------------------------------------- #
def _scalar_offsets_tv(D: int, O: int) -> tuple[dict, int]:
    """Layout of the time-varying-R scalar vector; the same layout as
    ``eks_tpu/ops/pallas_nll.py`` (84 floats at D = 3, O = 8). R_t changes
    every step, so the element matrices are built per step in the
    information form from these time-invariant pieces."""
    dd = D * D
    offs, n = {}, 0
    for name, size in (
        ("Qi", dd),       # Q⁻¹
        ("QiA", dd),      # Q⁻¹ A
        ("S0i", dd),      # S0⁻¹ (the t=0 element)
        ("S0i_m0", D),    # S0⁻¹ m0
        ("A", dd),        # element eta and J, epilogue transition
        ("Q", dd),        # epilogue: process noise (already s-scaled)
        ("Cobs", O * D),  # emission (element build and epilogue)
        ("m0", D),        # epilogue: prior mean
        ("S0", dd),       # epilogue: prior covariance
    ):
        offs[name] = n
        n += size
    return offs, n


def _prior_information(m0, S0):
    """(S0⁻¹, S0⁻¹ m0): the part of the table that depends on the prior only,
    so an optimizer over A and Q computes it once."""
    S0i = small_inv(S0)
    return S0i, (S0i @ m0[..., None])[..., 0]


def _pack_scalars_tv(m0, S0, A, Q, C, prior=None) -> torch.Tensor:
    """(N, n_scal) time-varying-R tables, one row per lane: m0 (N, D),
    S0/A/Q (N, D, D), C (N, O, D). ``prior`` is ``_prior_information(m0,
    S0)`` where the caller already holds it. Needs Q and S0 invertible."""
    S0i, S0i_m0 = _prior_information(m0, S0) if prior is None else prior
    Qi = small_inv(Q)
    N = m0.shape[0]
    return torch.cat([
        x.reshape(N, -1) for x in (Qi, Qi @ A, S0i, S0i_m0, A, Q, C, m0, S0)
    ], dim=-1)


def _unpack_scalars_tv(table: torch.Tensor, D: int, O: int):
    """The raw (m0, S0, A, Q, C) blocks of an (N, n_scal) time-varying-R
    table; they ride verbatim, so tangents round-trip exactly."""
    return _table_blocks(
        table, _scalar_offsets_tv(D, O)[0], ("m0", (D,)), ("S0", (D, D)), ("A", (D, D)),
        ("Q", (D, D)), ("Cobs", (O, D)),
    )


def _table_planes_tv(table: torch.Tensor, y: torch.Tensor, r: torch.Tensor, D: int) -> torch.Tensor:
    """(N, P, T) filtering-element planes from the time-varying-R table, the
    observation planes y and the noise planes r (both (N, O, T)), row for row
    what kernel C builds. With diagonal R the O x O innovation solve of the
    covariance form collapses to one D x D inverse per step:
        W_t = Cᵀ R_t⁻¹ C,  v_t = Cᵀ R_t⁻¹ y_t,  M_t = (Q⁻¹ + W_t)⁻¹,
        A_el = M_t Q⁻¹ A,  b = M_t v_t,  C_el = M_t,
        eta = Aᵀ (v_t - W_t M_t v_t),  J = Aᵀ (W_t - W_t M_t W_t) A.
    t = 0 assimilates y_0 against the prior: the same update with S0⁻¹ in
    the place of Q⁻¹ and S0⁻¹ m0 added to v, and A_el, eta and J zero; one
    inverse serves both cases by selecting the prior information there."""
    O = y.shape[1]
    offs, _ = _scalar_offsets_tv(D, O)
    t0 = torch.arange(y.shape[-1], device=y.device) == 0
    zero = torch.zeros((), dtype=table.dtype, device=table.device)

    def W(name, k):
        return table[:, offs[name] + k, None]

    def unless_t0(x):
        return torch.where(t0, zero, x)

    rng = range(D)
    Cm = [[W("Cobs", o * D + a) for a in rng] for o in range(O)]
    ri = [torch.reciprocal(r[:, o]) for o in range(O)]
    Wt = [[psum(Cm[o][a] * Cm[o][b] * ri[o] for o in range(O)) for b in rng] for a in rng]
    v = [psum(Cm[o][a] * ri[o] * y[:, o] for o in range(O)) for a in rng]
    M = _pinv([
        [Wt[a][b] + torch.where(t0, W("S0i", a * D + b), W("Qi", a * D + b)) for b in rng]
        for a in rng
    ])
    v_eff = [v[a] + torch.where(t0, W("S0i_m0", a), zero) for a in rng]
    b_el = _pmatvec(M, v_eff)
    w = _pvsub(v, _pmatvec(Wt, b_el))
    WMW = _pmatmul(Wt, _pmatmul(M, Wt))
    A = [[W("A", i * D + j) for j in rng] for i in rng]
    QiA = [[W("QiA", i * D + j) for j in rng] for i in rng]
    A_el = [[unless_t0(x) for x in row] for row in _pmatmul(M, QiA)]
    eta = [unless_t0(x) for x in _pmatvec(_pt(A), w)]
    J = [
        [
            unless_t0(psum(A[k][i] * (Wt[k][l] - WMW[k][l]) * A[l][j] for k in rng for l in rng))
            for j in rng
        ]
        for i in rng
    ]
    return _flat(A_el, b_el, M, eta, J)


def _plane_nll_pre_tv(ys, m0, S0, A, Q, C, r) -> torch.Tensor:
    """Time-varying-diagonal-R filtering elements as (N, P, T) planes, in
    the information form: the per-lane table expanded over time. ys and r
    are (N, T, O); C is the (N, O, D) emission."""
    table = _pack_scalars_tv(m0, S0, A, Q, C)
    return _table_planes_tv(table, ys.transpose(1, 2), r.transpose(1, 2), m0.shape[-1])


def _make_filter_elements(ys, m0, S0, A, Q, C, r, first: bool = True) -> torch.Tensor:
    """Per-step filtering elements as (N, P, T) planes. ``r`` is the
    diagonal observation noise, (N, O) constant (the per-lane scalar table
    expanded over time) or (N, T, O) time-varying (each step solves its
    innovation covariance). Without ``first`` (a later chunk of a
    time-sharded sequence) step 0 is an ordinary step."""
    if r.ndim == 2:
        return _table_planes(_pack_scalars(ys[:, 0], m0, S0, A, Q, C, r), ys.transpose(1, 2), m0.shape[-1], first)
    return _make_filter_elements_tv(ys, m0, S0, A, Q, C[:, None].expand(-1, ys.shape[1], -1, -1), r, first)


def _make_filter_elements_tv(ys, m0, S0, A, Q, Cs, r, first: bool = True) -> torch.Tensor:
    """Filtering elements (N, P, T) in the covariance form with a per-step
    emission Cs (N, T, O, D) and time-varying diagonal noise r (N, T, O):
    each step solves its O x O innovation covariance. The final pass's form,
    linear (Cs constant over time) or relinearized (the iterated EKF).
    Without ``first`` (a later chunk of a time-sharded sequence) step 0 is an
    ordinary step and the prior is not read."""
    D = m0.shape[-1]
    eye = torch.eye(D, dtype=ys.dtype, device=ys.device)
    Cst = Cs.transpose(-1, -2)
    CQ = Cs @ Q[:, None]  # (N, T, O, D)
    CA = Cs @ A[:, None]
    S = CQ @ Cst + torch.diag_embed(r)  # (N, T, O, O)
    K = psd_solve(S, CQ).transpose(-1, -2)
    IKC = eye - K @ Cs  # (N, T, D, D)
    A_el = IKC @ A[:, None]
    b_el = (K @ ys[..., None])[..., 0]
    C_el = IKC @ Q[:, None]
    CAt = CA.transpose(-1, -2)
    eta_el = (CAt @ psd_solve(S, ys)[..., None])[..., 0]
    J_el = CAt @ psd_solve(S, CA)
    if not first:
        return _aos_planes(A_el, b_el, C_el, eta_el, J_el)

    # first element: update the prior (m0, S0) with y_0, no transition
    C0 = Cs[:, 0]
    S_0 = C0 @ S0 @ C0.transpose(-1, -2) + torch.diag_embed(r[:, 0])
    K_0 = psd_solve(S_0, C0 @ S0).transpose(-1, -2)
    b_first = m0 + (K_0 @ (ys[:, 0] - (C0 @ m0[..., None])[..., 0])[..., None])[..., 0]
    C_first = (eye - K_0 @ C0) @ S0
    zero = torch.zeros_like
    A_el = torch.cat([zero(A_el[:, :1]), A_el[:, 1:]], dim=1)
    b_el = torch.cat([b_first[:, None], b_el[:, 1:]], dim=1)
    C_el = torch.cat([C_first[:, None], C_el[:, 1:]], dim=1)
    eta_el = torch.cat([zero(eta_el[:, :1]), eta_el[:, 1:]], dim=1)
    J_el = torch.cat([zero(J_el[:, :1]), J_el[:, 1:]], dim=1)
    return _aos_planes(A_el, b_el, C_el, eta_el, J_el)


def _predictive_moments(ms, Ps, m0, S0, A, Q, halo=None):
    """One-step-ahead predictive moments aligned with observations: t = 0
    uses the prior, t >= 1 predicts from the t-1 filtered moments. With
    ``halo``, the filtered (mean (N, D), covariance (N, D, D)) of the step
    before a later chunk of a time-sharded sequence, t = 0 predicts from it."""
    At = A.transpose(-1, -2)[:, None]
    if halo is not None:
        m_prev = torch.cat([halo[0][:, None], ms[:, :-1]], dim=1)
        P_prev = torch.cat([halo[1][:, None], Ps[:, :-1]], dim=1)
        return (m_prev[:, :, None, :] @ At)[:, :, 0], A[:, None] @ P_prev @ At + Q[:, None]
    pm = (ms[:, :-1, None, :] @ At)[:, :, 0]
    pP = A[:, None] @ Ps[:, :-1] @ At + Q[:, None]
    return (
        torch.cat([m0[:, None], pm], dim=1),
        torch.cat([S0[:, None], pP], dim=1),
    )


def _linear_ll(ms, Ps, m0, S0, A, Q, C, ys, r, halo=None) -> torch.Tensor:
    """The exact marginal log-likelihood (N,) of observations ys (N, T, O)
    with emission C (N, O, D) and diagonal noise r (N, T, O), summed over
    the steps, from the filtered moments (N, T, D), (N, T, D, D) (with
    ``halo``, of a later chunk of a time-sharded sequence)."""
    pred_m, pred_P = _predictive_moments(ms, Ps, m0, S0, A, Q, halo)
    Cb = C[:, None]
    S = Cb @ pred_P @ Cb.transpose(-1, -2) + torch.diag_embed(r)
    return mvn_logpdf(ys, (Cb @ pred_m[..., None])[..., 0], S).sum(dim=1)


# --------------------------------------------------------------------------- #
# plane-native filter NLL (the optimizers' losses)
# --------------------------------------------------------------------------- #
def _plane_split_moments(out: torch.Tensor, D: int):
    """Filtered-moment planes out of a scanned (N, P, T) table."""
    dd = D * D
    return _vec_planes(out, dd, D), _mat_planes(out, dd + D, D)


def _plane_pred_moments(m_pl, P_pl, m0, S0, A, Q, halo=None):
    """Predictive moments from filtered-moment planes: A m_{t-1} and
    A P_{t-1} Aᵀ + Q for t >= 1, the prior (m0, S0) at t = 0. Parameters are
    (N, ...) tensors; planes are (N, T). With ``halo``, the filtered (mean
    (N, D), covariance (N, D, D)) of the step before a later chunk of a
    time-sharded sequence, t = 0 predicts from it."""
    D = len(m_pl)
    m_before, P_before = (m0, S0) if halo is None else halo
    at_first = _set_first if halo is None else (lambda row, _: row)

    def col(x):
        return x[:, None]

    def shifted(p, first):
        return torch.cat([first[:, None], p[:, :-1]], dim=1)

    m_prev = [shifted(m_pl[i], m_before[:, i]) for i in range(D)]
    P_prev = [[shifted(P_pl[i][j], P_before[:, i, j]) for j in range(D)] for i in range(D)]
    pred_m = [
        at_first(psum(col(A[:, i, j]) * m_prev[j] for j in range(D)), m0[:, i])
        for i in range(D)
    ]
    pred_P = [
        [
            at_first(
                psum(
                    col(A[:, i, k]) * P_prev[k][l] * col(A[:, j, l])
                    for k in range(D)
                    for l in range(D)
                )
                + col(Q[:, i, j]),
                S0[:, i, j],
            )
            for j in range(D)
        ]
        for i in range(D)
    ]
    return pred_m, pred_P


def _plane_innovation_ll(pred_m, pred_P, ys, C, r) -> torch.Tensor:
    """Sum over time of the Gaussian log-density of the innovations, from
    predictive-moment planes; ys (N, T, O), C (N, O, D), r (N, O) constant
    or (N, T, O) time-varying."""
    O = ys.shape[-1]
    D = len(pred_m)

    def S(i, j):  # the lower triangle of C P Cᵀ + R, all the Cholesky reads
        cpc = psum(C[:, None, i, k] * pred_P[k][l] * C[:, None, j, l] for k in range(D) for l in range(D))
        return cpc + (r[:, None, i] if r.ndim == 2 else r[..., i]) if i == j else cpc

    d = [ys[..., i] - psum(C[:, None, i, j] * pred_m[j] for j in range(D)) for i in range(O)]
    L = [[None] * O for _ in range(O)]
    for i in range(O):
        for j in range(i + 1):
            s = S(i, j)
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    z = [None] * O
    for i in range(O):
        s = d[i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    logdet = psum(torch.log(L[i][i]) for i in range(O))
    quad = psum(zi * zi for zi in z)
    return (-0.5 * quad - logdet - 0.5 * O * _LOG_2PI).sum(dim=1)


def _plane_nll_post(m_pl, P_pl, ys, m0, S0, A, Q, C, r, halo=None) -> torch.Tensor:
    """Predictive moments + Gaussian log-density from filtered planes (with
    ``halo``, of a later chunk of a time-sharded sequence)."""
    pred_m, pred_P = _plane_pred_moments(m_pl, P_pl, m0, S0, A, Q, halo)
    return _plane_innovation_ll(pred_m, pred_P, ys, C, r)


def _staged_nll(table: torch.Tensor, y: torch.Tensor, prefix) -> torch.Tensor:
    """The staged constant-R plane NLL from a scalar table (N, n_scal) and
    observation planes y (N, O, T): element planes, the lane-batched prefix
    scan ``prefix`` over them, predictive moments and log-densities. (N,)."""
    O = y.shape[1]
    D = _table_dims(table.shape[1], O)
    out = prefix(_table_planes(table, y, D).contiguous())
    m_pl, P_pl = _plane_split_moments(out, D)
    return _plane_nll_post(m_pl, P_pl, y.transpose(1, 2), *_unpack_scalars(table, D, O))


def _table_nll_tv(table: torch.Tensor, yr: torch.Tensor, prefix) -> torch.Tensor:
    """The staged time-varying-R plane NLL from a table and the (N, 2O, T)
    planes yr (y rows, then r rows): element planes, the prefix scan
    ``prefix`` over them, predictive moments and log-densities. (N,)."""
    O = yr.shape[1] // 2
    D = _table_dims(table.shape[1], O, _scalar_offsets_tv)
    y, r = yr[:, :O], yr[:, O:]
    m_pl, P_pl = _plane_split_moments(prefix(_table_planes_tv(table, y, r, D)), D)
    m0, S0, A, Q, C = _unpack_scalars_tv(table, D, O)
    return _plane_nll_post(m_pl, P_pl, y.transpose(1, 2), m0, S0, A, Q, C, r.transpose(1, 2))


# --------------------------------------------------------------------------- #
# the iterated EKF's elements (the calibrated family) and forward mode
# around a stage
# --------------------------------------------------------------------------- #
def _relinearize(h_fn, ys, x_bar):
    """Per-step emission Jacobians H_t (N, T, O, D) at the trajectory x̄
    (N, T, D) and the affine surrogate observations y - h(x̄) + H x̄."""
    Hs = emission_jacobian(h_fn, x_bar)
    return Hs, ys - h_fn(x_bar) + torch.einsum("ntod,ntd->nto", Hs, x_bar)


def _jvp_or_call(fn, primals, tangents):
    """(fn(*primals), its tangent along ``tangents``), or (fn(*primals),
    None) when there are no tangents. A None tangent is a zero one: the
    function reads every tensor as a primal, since under forward mode an
    operation between a tensor with a tangent and one without takes a slow
    decomposed path on the host (``kalman.emission_parts``)."""
    if tangents is None:
        return fn(*primals), None
    tangents = tuple(torch.zeros_like(p) if t is None else t for p, t in zip(primals, tangents))
    return jvp(fn, tuple(primals), tangents)


def _ekf_info_elements(Hs, ys, r, A, prior_q, prior_0, first: bool = True):
    """Information-form filtering elements (N, P, T) of the relinearized
    surrogate: per-step emission Hs (N, T, O, D), observations ys and
    diagonal noise r (N, T, O), transition A (N, D, D), and the information
    pairs ``prior_q = (Q⁻¹, Q⁻¹ A)`` and ``prior_0 = (S0⁻¹, S0⁻¹ m0)``. The
    algebra of ``_table_planes_tv`` (kernel C's elements) in matrix form,
    batched over lanes and steps: tens of operations, not the thousands of
    the unrolled planes, since the optimizer runs it under ``torch.func.jvp``
    every sweep. Without ``first`` (a later chunk of a time-sharded
    sequence) step 0 is an ordinary step."""
    Qi, QiA = prior_q
    S0i, S0i_m0 = prior_0
    t0 = _first_step_mask(ys.shape[1], ys.device, first)[:, None, None]
    HtRi = (Hs * torch.reciprocal(r)[..., None]).transpose(-1, -2)  # (N, T, D, O)
    W = HtRi @ Hs
    v = HtRi @ ys[..., None]
    M = small_inv(W + torch.where(t0, S0i[:, None], Qi[:, None]))
    b = M @ (v + torch.where(t0, S0i_m0[:, None, :, None], 0.0))
    At = A.transpose(-1, -2)[:, None]
    A_el = torch.where(t0, 0.0, M @ QiA[:, None])
    eta = torch.where(t0, 0.0, At @ (v - W @ b))
    J = torch.where(t0, 0.0, At @ (W - W @ (M @ W)) @ A[:, None])
    return _aos_planes(A_el, b[..., 0], M, eta[..., 0], J)


def _filtered_moments(out: torch.Tensor, D: int):
    """Filtered means (N, T, D) and covariances (N, T, D, D) of a scanned
    (N, P, T) filtering table."""
    dd = D * D
    N, _, T = out.shape
    return out[:, dd:dd + D].transpose(1, 2), out[:, dd + D:2 * dd + D].transpose(1, 2).reshape(N, T, D, D)


# --------------------------------------------------------------------------- #
# RTS smoothing elements and their combine
# --------------------------------------------------------------------------- #
_SMOOTHER_D = {2 * d * d + d: d for d in range(1, 9)}


def smoother_state_dim(n_planes: int) -> int:
    """State dimension D of a smoothing-element table with ``n_planes``."""
    if n_planes not in _SMOOTHER_D:
        raise ValueError(f"{n_planes} planes is not a smoothing element (2D²+D)")
    return _SMOOTHER_D[n_planes]


def _combine_smoother(later: torch.Tensor, earlier: torch.Tensor) -> torch.Tensor:
    """Associative combination of smoothing elements under a reverse scan:
    the first argument is the element later in time; the earlier element's
    affine map ``x -> E_e x + g_e`` is applied to the later suffix."""
    D = smoother_state_dim(later.shape[-2])
    dd = D * D
    El, gl, Ll = _mat_planes(later, 0, D), _vec_planes(later, dd, D), _mat_planes(later, dd + D, D)
    Ee, ge, Le = _mat_planes(earlier, 0, D), _vec_planes(earlier, dd, D), _mat_planes(earlier, dd + D, D)
    E = _pmatmul(Ee, El)
    g = _pvadd(_pmatvec(Ee, gl), ge)
    L = _padd(_pmatmul(_pmatmul(Ee, Ll), _pt(Ee)), Le)
    return _flat(E, g, L)


def _make_smoother_elements(ms, Ps, A, Q, last: bool = True) -> torch.Tensor:
    """RTS smoothing elements (N, 2D²+D, T) from filtered moments; the final
    element carries the filtered terminal moments. Without ``last`` (an
    earlier chunk of a time-sharded sequence) the final step is an ordinary
    step."""
    Ab, At = A[:, None], A.transpose(-1, -2)[:, None]
    P_pred = Ab @ Ps @ At + Q[:, None]
    E = psd_solve(P_pred, Ab @ Ps).transpose(-1, -2)
    g = ms - (E @ (Ab @ ms[..., None]))[..., 0]
    L = Ps - E @ P_pred @ E.transpose(-1, -2)
    if not last:
        return _aos_planes(E, g, L)
    E = torch.cat([E[:, :-1], torch.zeros_like(E[:, -1:])], dim=1)
    g = torch.cat([g[:, :-1], ms[:, -1:]], dim=1)
    L = torch.cat([L[:, :-1], Ps[:, -1:]], dim=1)
    return _aos_planes(E, g, L)
