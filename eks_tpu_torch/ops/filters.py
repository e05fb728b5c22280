"""The filters and losses that run the kernels: the linear parallel filter
and smoother, the iterated parallel EKF, and the optimizers' losses, each
over time shards (``ops/shards.py``; one shard on one device unless a mesh
is given, so the single-device path is one shard of the same code).

Built from the plane algebra of ``ops/pkalman.py`` and the kernel wrappers
(``ops/fused_filter.py``, ``ops/fused_nll.py``), which are looked up at
call time. The forward filter's prefix scan and the reverse RTS scan are
the sharded scans of ``ops/shards.py``: on one shard the kernel's own scan
(the CUDA kernel on the card, the plain scan on the CPU).

The s-optimizer's linear loss is picked here, once per optimizer call
(``linear_member_lls``): kernel A where it takes the shapes and the time
axis is whole, else the staged plane NLL with its paired lane-batched scan.

Nonlinear emissions (the calibrated multi-camera projection) run as an
iterated parallel EKF: each sweep linearizes ``h`` at the current
predicted-mean trajectory x̄ and replays the linear sweep on the affine
surrogate ``ỹ_t = y_t - h(x̄_t) + H_t x̄_t``; the fixed point is the
sequential extended Kalman filter. The optimizer's EKF loss
(``ekf_nll_paired_batched``) carries (x̄, dx̄) pairs by hand through
``torch.func.jvp`` around one paired scan launch per sweep, so no kernel
runs under autograd.
"""

from __future__ import annotations

import functools

import torch

from eks_tpu_torch.ops import fused_filter, fused_nll
from eks_tpu_torch.ops.kalman import (
    FilterResult, SmootherResult, _as_time_varying, emission_jacobian, emission_parts,
)
from eks_tpu_torch.ops.linalg import mvn_logpdf, small_inv
from eks_tpu_torch.ops.pkalman import (
    _ekf_info_elements,
    _filtered_moments,
    _jvp_or_call,
    _linear_ll,
    _make_filter_elements,
    _make_filter_elements_tv,
    _make_smoother_elements,
    _pack_scalars_tv,
    _plane_nll_post,
    _plane_split_moments,
    _predictive_moments,
    _prior_information,
    _relinearize,
    _scalar_offsets_tv,
    _table_blocks,
    _table_dims,
    _table_nll_tv,
    _table_planes,
    _unpack_scalars,
    _unpack_scalars_tv,
    filter_state_dim,
)
from eks_tpu_torch.ops.shards import (
    TimeShards,
    emission_on,
    filter_prefix_paired_sharded,
    filter_prefix_sharded,
    smoother_suffix_sharded,
)

__all__ = [
    "ekf_nll_paired_batched",
    "ekf_nll_parallel_planes_batched",
    "ekf_parallel",
    "eks_parallel",
    "filter_nll_parallel_planes_tv",
    "kalman_filter_parallel",
    "kalman_smoother_parallel",
    "linear_member_lls",
    "table_nll_tv_paired_sharded",
]


# --------------------------------------------------------------------------- #
# the linear filter and smoother over time shards
# --------------------------------------------------------------------------- #
def _one_shard(x: torch.Tensor):
    """The whole sequence of ``x`` as one time shard on its device."""
    return TimeShards((x.device,), x.shape[1])


def _befores(fm: list, shards) -> list:
    """Per shard, from its filtered (means, covariances), the filtered
    (mean, covariance) of the step before its chunk on its device: None for
    the first shard."""
    return [None] + [tuple(x[:, -1].to(dev) for x in f) for f, dev in zip(fm[:-1], shards.devices[1:])]


def _run_filter_prefix(planes: torch.Tensor):
    """Prefix-combine (N, P, T) filtering elements -> filtered means
    (N, T, D) and covariances (N, T, D, D)."""
    return _filtered_moments(fused_filter.filter_prefix(planes), filter_state_dim(planes.shape[1]))


def _linear_filter(ys, m0, S0, A, Q, C, r_diag, shards, compute_ll: bool):
    """The linear parallel filter over time shards: per shard its filtered
    (means, covariances) and its (m0, S0, A, Q, C) on its device, and with
    ``compute_ll`` the log-likelihood (N,) summed in shard order on the
    device of ``ys``, else None."""
    D = m0.shape[-1]
    ys_c = shards.split(ys, 1)
    r_c = shards.replicate(r_diag) if r_diag.ndim == 2 else shards.split(r_diag, 1)
    prm = list(zip(*(shards.replicate(x) for x in (m0, S0, A, Q, C))))
    outs = filter_prefix_sharded(
        shards.map(lambda i, y_, r_: _make_filter_elements(y_, *prm[i], r_, first=i == 0), ys_c, r_c))
    fm = shards.map(lambda i, o: _filtered_moments(o, D), outs)
    if not compute_ll:
        return fm, prm, None

    def ll(i, f, before, y_, r_):
        return _linear_ll(*f, *prm[i], y_, _as_time_varying(r_, y_.shape[1]), halo=before)

    return fm, prm, shards.total(shards.map(ll, fm, _befores(fm, shards), ys_c, r_c), ys.device)


def kalman_filter_parallel(ys, m0, S0, A, Q, C, r_diag, compute_ll: bool = True, shards=None) -> FilterResult:
    """O(log T)-depth linear Kalman filter over N lanes: ys (N, T, O), every
    parameter with a leading N, ``r_diag`` (N, O) or (N, T, O). With
    ``compute_ll`` the exact per-step marginal log-likelihood is summed
    into (N,). ``shards`` (``ops.shards.TimeShards``, the whole sequence
    on the device of ``ys`` unless given) splits the time axis: each chunk's
    elements on its device (the prior in the first chunk only), the sharded
    filter scan, a chunk's first prediction from the filtered moments
    before it; the results are joined on the device of ``ys``."""
    shards = _one_shard(ys) if shards is None else shards
    fm, _, ll = _linear_filter(ys, m0, S0, A, Q, C, r_diag, shards, compute_ll)
    return FilterResult(ll, *(shards.gather([f[j] for f in fm], 1, ys.device) for j in range(2)))


def _rts_shards(fm: list, AQ: list, shards, device) -> SmootherResult:
    """The parallel RTS pass over time shards, from each shard's filtered
    (means, covariances) and (A, Q) on its device: smoothing elements per
    chunk (the terminal one in the last chunk only) and the reverse scan
    through ``fused_filter.smoother_suffix`` (the CUDA kernel on the card,
    the plain scan on the CPU), sharded when there are several chunks.
    Filtered and smoothed moments are joined on ``device``."""
    D = fm[0][0].shape[-1]
    dd = D * D
    last = len(shards) - 1
    outs = smoother_suffix_sharded(shards.map(lambda i, f, aq: _make_smoother_elements(*f, *aq, last=i == last),
                                              fm, AQ))

    def moments(i, out):
        N, _, T = out.shape
        return out[:, dd:dd + D].transpose(1, 2), out[:, dd + D:].transpose(1, 2).reshape(N, T, D, D)

    sm = shards.map(moments, outs)
    fm_s, sm_s = ([shards.gather([p[j] for p in parts], 1, device) for j in range(2)] for parts in (fm, sm))
    return SmootherResult(None, *fm_s, *sm_s)


def _rts_from_filtered(ms, Ps, A, Q):
    """The RTS pass over one device's filtered moments: smoothed means
    (N, T, D) and covariances (N, T, D, D)."""
    res = _rts_shards([(ms, Ps)], [(A, Q)], _one_shard(ms), ms.device)
    return res.smoothed_means, res.smoothed_covs


def kalman_smoother_parallel(ys, m0, S0, A, Q, C, r_diag, shards=None, compute_ll: bool = False) -> SmootherResult:
    """O(log T)-depth linear RTS smoother over N lanes (filter prefix scan +
    reverse associative scan); with ``compute_ll`` the filter
    log-likelihood (N,) too. ``shards`` splits the time axis as in
    ``kalman_filter_parallel``; the smoother's carries run from the last
    chunk back."""
    shards = _one_shard(ys) if shards is None else shards
    fm, prm, ll = _linear_filter(ys, m0, S0, A, Q, C, r_diag, shards, compute_ll)
    return _rts_shards(fm, [p[2:4] for p in prm], shards, ys.device)._replace(log_likelihood=ll)


# --------------------------------------------------------------------------- #
# the iterated parallel EKF over time shards (the calibrated family)
# --------------------------------------------------------------------------- #
def _ekf_filter_shards(ys, m0, S0, A, Q, h_fn, r, n_iters, x_init, shards):
    """The iterated parallel EKF on a time-sharded sequence: per shard its
    filtered (means, covariances) and its parameters (m0, S0, A, Q) on its
    device. Each relinearization takes x̄ from the predicted means, a
    chunk's first one from the filtered mean before it."""
    D = m0.shape[-1]
    ys_c, r_c = shards.split(ys, 1), shards.split(r, 1)
    prm = list(zip(*(shards.replicate(x) for x in (m0, S0, A, Q))))
    h_c = [emission_on(h_fn, dev) for dev in shards.devices]

    def elements(i, x_bar):
        m0_, S0_, A_, Q_ = prm[i]
        Hs, y_eff = _relinearize(h_c[i], ys_c[i], x_bar)
        return _make_filter_elements_tv(y_eff, m0_, S0_, A_, Q_, Hs, r_c[i], first=i == 0)

    def moments(x_c):
        outs = filter_prefix_sharded(shards.map(elements, x_c))
        return shards.map(lambda i, o: _filtered_moments(o, D), outs)

    def predicted_means(i, fm, before):
        m0_, At = prm[i][0], prm[i][2].transpose(-1, -2)[:, None]
        first = m0_[:, None] if before is None else (before[0][:, None, None, :] @ At)[:, :, 0]
        return torch.cat([first, (fm[0][:, :-1, None, :] @ At)[:, :, 0]], dim=1)

    x_c = shards.split(m0[:, None].expand(-1, ys.shape[1], -1) if x_init is None else x_init, 1)
    for _ in range(n_iters):
        fm = moments(x_c)
        x_c = shards.map(predicted_means, fm, _befores(fm, shards))
    return moments(x_c), prm


def ekf_parallel(ys, m0, S0, A, Q, h_fn, r_diag, n_iters: int = 12, x_init=None,
                 compute_ll: bool = True, shards=None) -> FilterResult:
    """Extended Kalman filter over N lanes via fixed-point relinearization
    over parallel linear sweeps: each iteration linearizes ``h`` at the
    predicted-mean trajectory x̄ (the broadcast prior mean unless
    ``x_init`` (N, T, D) is given) and replays the log-depth filter on the
    affine surrogate, in the covariance form (``_make_filter_elements_tv``);
    the predicted means become the next x̄. ``n_iters`` relinearizations
    then one more for the result: n_iters + 1 filter scans. With
    ``compute_ll`` the exact EKF log-likelihood at the final predicted
    trajectory is summed into (N,). With ``shards`` the time axis is split
    over them; the results are joined on the device of ``ys``."""
    shards = _one_shard(ys) if shards is None else shards
    r = _as_time_varying(r_diag, ys.shape[1])
    fm, prm = _ekf_filter_shards(ys, m0, S0, A, Q, h_fn, r, n_iters, x_init, shards)
    ms, Ps = (shards.gather([f[j] for f in fm], 1, ys.device) for j in range(2))
    if not compute_ll:
        return FilterResult(None, ms, Ps)
    ys_c, r_c = shards.split(ys, 1), shards.split(r, 1)

    def ll(i, f, before):
        h = emission_on(h_fn, shards.devices[i])
        pred_m, pred_P = _predictive_moments(*f, *prm[i], halo=before)
        H = emission_jacobian(h, pred_m)
        S = H @ pred_P @ H.transpose(-1, -2) + torch.diag_embed(r_c[i])
        return mvn_logpdf(ys_c[i], h(pred_m), S).sum(dim=1)

    return FilterResult(shards.total(shards.map(ll, fm, _befores(fm, shards)), ys.device), ms, Ps)


def eks_parallel(ys, m0, S0, A, Q, h_fn, r_diag, n_iters: int = 12, x_init=None,
                 shards=None) -> SmootherResult:
    """Iterated parallel EKF + the (emission-independent) parallel RTS pass
    over N lanes. The filter log-likelihood is not computed. With ``shards``
    the time axis is split over them."""
    shards = _one_shard(ys) if shards is None else shards
    r = _as_time_varying(r_diag, ys.shape[1])
    fm, prm = _ekf_filter_shards(ys, m0, S0, A, Q, h_fn, r, n_iters, x_init, shards)
    return _rts_shards(fm, [p[2:] for p in prm], shards, ys.device)


# --------------------------------------------------------------------------- #
# the optimizers' losses: every chunk's elements on its device, the paired
# sharded scan, and a chunk's first prediction from the filtered moments
# before it (its halo)
# --------------------------------------------------------------------------- #
def _last_filtered(out: torch.Tensor, D: int):
    """The filtered (mean (N, D), covariance (N, D, D)) at the last step of a
    scanned (N, P, T) filtering table."""
    dd = D * D
    return out[:, dd:dd + D, -1], out[:, dd + D:2 * dd + D, -1].reshape(out.shape[0], D, D)


def _halos(outs: list, D: int) -> list:
    """Per time shard, from its scanned (table, tangent or None) pairs, the
    filtered moments of the step before its chunk and their tangents, on the
    chunk's device: None for the first shard, else ((m, P), (dm, dP) or ())."""
    halos = [None]
    for (prev, dprev), (cur, _) in zip(outs[:-1], outs[1:]):
        h = tuple(x.to(cur.device) for x in _last_filtered(prev, D))
        dh = () if dprev is None else tuple(x.to(cur.device) for x in _last_filtered(dprev, D))
        halos.append((h, dh))
    return halos


def _paired_nll_shards(shards, D: int, build, post, device):
    """(ll (N,), d ll (N,)) of a staged loss over time shards: ``build(i)``
    gives chunk i's (element planes, tangents), one paired filter scan runs
    over them (sharded when there are several chunks), and ``post(i,
    (scanned, tangent), halo)`` gives the chunk's (ll, d ll), ``halo`` being
    the filtered moments before the chunk with their tangents (None for the
    first). The chunks' sums are added in shard order on ``device``."""
    el = shards.map(build)
    outs = filter_prefix_paired_sharded([e[0].contiguous() for e in el], [e[1].contiguous() for e in el])
    parts = shards.map(post, outs, _halos(outs, D))
    return tuple(shards.total([p[j] for p in parts], device) for j in range(2))


def _staged_nll_paired(table: torch.Tensor, dtable: torch.Tensor, y: torch.Tensor, shards=None):
    """(ll (N,), d ll (N,)) of the staged plane NLL along the table tangent
    ``dtable``: the element planes and their tangents from ``torch.func.jvp``,
    both through ONE paired lane-batched scan
    (``fused_filter.filter_prefix_paired``), and the epilogue under
    ``torch.func.jvp`` again. The forward-mode pairing of the JAX package's
    staged path. ``shards`` (``ops.shards.TimeShards``, the whole
    sequence on the device of ``y`` unless given) splits the time axis of
    the observation planes y (N, O, T): what the s-optimizer runs with the
    time axis sharded, where kernel A, which fuses one lane's whole T,
    cannot span the shards (as the JAX package turns its Pallas off
    there)."""
    O = y.shape[1]
    D = _table_dims(table.shape[1], O)
    shards = _one_shard(y.transpose(1, 2)) if shards is None else shards
    y_c = shards.split(y, 2)
    tab, dtab = shards.replicate(table), shards.replicate(dtable)

    def build(i):
        return _jvp_or_call(lambda t, y_: _table_planes(t, y_, D, first=i == 0),
                            (tab[i], y_c[i].contiguous()), (dtab[i], None))

    def post(i, scanned, halo):
        def fn(out, t, y_, *h):
            m_pl, P_pl = _plane_split_moments(out, D)
            return _plane_nll_post(m_pl, P_pl, y_, *_unpack_scalars(t, D, O), halo=h or None)

        h, dh = ((), ()) if halo is None else halo
        return _jvp_or_call(fn, (scanned[0], tab[i], y_c[i].transpose(1, 2).contiguous(), *h),
                            (scanned[1], dtab[i], None, *dh))

    return _paired_nll_shards(shards, D, build, post, table.device)


def linear_member_lls(yF, rF, m0F, S0F, AF, QF, CF, b_max: int, s_lo: float, s_hi: float, shards=None):
    """The s-optimizer's linear loss over N = n_blocks * b_max member
    filters: ``member_lls(s_log) -> (ll (N,), d ll / d log s (N,))`` at
    process noise s Q, s = exp(clamp(log s, s_lo, s_hi)) of each member's
    block (s_log (n_blocks,)), from the flattened operands yF (N, T, O),
    rF (N, O), m0F (N, D), S0F, AF and QF (N, D, D), CF (N, O, D). The one
    place that picks the loss route, once for the optimizer call, by kernel
    A's shapes (``fused_nll.kernel_a_takes``):

    * kernel A's (D, O) and the time axis whole: the table kernel
      (``fused_nll.table_paired``), then kernel A (``fused_nll_paired``);
    * kernel A's (D, O) over ``shards`` (``ops.shards.TimeShards``): the
      table kernel, then the staged loss over the shards, since kernel A
      fuses one lane's whole T;
    * beyond kernel A's shapes: the forward-mode table
      (``fused_nll.table_paired_plain``), then the staged loss.

    On CPU tensors every wrapper takes its plain version."""
    O, D = CF.shape[-2:]
    fused = fused_nll.kernel_a_takes(D, O)
    table_paired = fused_nll.table_paired if fused else fused_nll.table_paired_plain
    y_planes = yF.transpose(1, 2).contiguous()
    y0F = yF[:, 0].contiguous()

    def tables(s_log):
        return table_paired(s_log, y0F, m0F, S0F, AF, QF, CF, rF, b_max, s_lo, s_hi)

    if fused and shards is None:
        nll_paired = fused_nll.fused_nll_paired

        def member_lls(s_log):
            table, dtable = tables(s_log)
            return nll_paired(table.contiguous(), dtable.contiguous(), y_planes)
    else:
        def member_lls(s_log):
            return _staged_nll_paired(*tables(s_log), y_planes, shards)
    return member_lls


def table_nll_tv_paired_sharded(table: torch.Tensor, dtable: torch.Tensor, yr: torch.Tensor, shards):
    """The time-varying-R loss of the table (``_table_nll_tv``) and its
    derivative along ``dtable``, with the time axis of the planes yr
    (N, 2O, T) split over ``shards``: the pupil optimizer's loss with the
    frame axis sharded, where kernel C, which fuses one lane's whole T,
    cannot span the shards. The information-form elements
    (``_ekf_info_elements``) and the epilogue (``_linear_ll``) take the
    matrix form, batched over lanes and steps: tens of operations under
    ``torch.func.jvp`` where the unrolled planes take thousands."""
    O = yr.shape[1] // 2
    D = _table_dims(table.shape[1], O, _scalar_offsets_tv)
    offs = _scalar_offsets_tv(D, O)[0]
    yr_c = [c.transpose(1, 2).contiguous() for c in shards.split(yr, 2)]  # (N, T_i, 2O)
    tab, dtab = shards.replicate(table), shards.replicate(dtable)

    def build(i):
        def fn(t, y_, r_):
            Qi, QiA, S0i, S0i_m0, A, C = _table_blocks(t, offs, ("Qi", (D, D)), ("QiA", (D, D)), ("S0i", (D, D)),
                                                       ("S0i_m0", (D,)), ("A", (D, D)), ("Cobs", (O, D)))
            return _ekf_info_elements(C[:, None].expand(-1, y_.shape[1], -1, -1), y_, r_, A, (Qi, QiA),
                                      (S0i, S0i_m0), first=i == 0)

        return _jvp_or_call(fn, (tab[i], yr_c[i][..., :O].contiguous(), yr_c[i][..., O:].contiguous()),
                            (dtab[i], None, None))

    def post(i, scanned, halo):
        def fn(out, t, y_, r_, *h):
            return _linear_ll(*_filtered_moments(out, D), *_unpack_scalars_tv(t, D, O), y_, r_, halo=h or None)

        h, dh = ((), ()) if halo is None else halo
        return _jvp_or_call(fn, (scanned[0], tab[i], yr_c[i][..., :O].contiguous(), yr_c[i][..., O:].contiguous(),
                                 *h), (scanned[1], dtab[i], None, None, *dh))

    return _paired_nll_shards(shards, D, build, post, table.device)


def filter_nll_parallel_planes_tv(ys, m0, S0, A, Q, C, r) -> torch.Tensor:
    """Marginal log-likelihoods (N,) of N linear filters with time-varying
    diagonal R, staged in scalar planes: ys and r (N, T, O), parameters with
    a leading N. The elements are built in the information form
    (``_table_planes_tv``) and scanned by ``fused_filter.filter_prefix``
    (kernel B on the card, the plain scan on the CPU)."""
    yr = torch.cat([ys.transpose(1, 2), r.transpose(1, 2)], dim=1)
    table = _pack_scalars_tv(m0, S0, A, Q, C)
    return _table_nll_tv(table, yr, lambda planes: fused_filter.filter_prefix(planes.contiguous()))


def _ekf_nll(ys, m0, S0, A, Q, dQ, h_fn, r, x_init, n_sweeps, shards=None):
    """The iterated-EKF NLL (N,) and, with the tangent ``dQ`` of Q, its
    derivative (N,), else None. Each sweep builds the relinearized
    information-form elements at x̄ (``_ekf_info_elements``), scans them
    (one paired launch with tangents on the card), and takes the next x̄
    from the predicted means. x̄ depends on Q through every earlier sweep,
    so its tangent dx̄ rides along: the derivative is that of the whole
    loss, not of the last sweep alone. The epilogue is the exact EKF density
    at the last predicted trajectory. Every tensor a stage reads is one of
    its primals (``_jvp_or_call``). With ``shards`` (``ops.shards.
    TimeShards``) the time axis is split over them: each chunk's stages run
    on its device, the scans are the sharded ones, and a chunk's first
    prediction reads the filtered moments before it (its halo)."""
    T = ys.shape[1]
    D = m0.shape[-1]
    shards = _one_shard(ys) if shards is None else shards
    h_call, h_consts = emission_parts(h_fn)
    fixed = (m0, S0, A, *_prior_information(m0, S0), *h_consts)
    consts = [  # a primal may not be an expanded view
        tuple(k.contiguous() for k in (y_, r_, *(f.to(dev) for f in fixed)))
        for y_, r_, dev in zip(shards.split(ys, 1), shards.split(_as_time_varying(r, T), 1), shards.devices)
    ]
    Q_c, dQ_c = shards.replicate(Q), shards.replicate(dQ)
    paired = dQ is not None

    def parts(k):
        ys_, rt, m0_, S0_, A_, S0i, S0i_m0, *hc = k
        return ys_, rt, m0_, S0_, A_, (S0i, S0i_m0), functools.partial(h_call, *hc)

    def planes(first):
        def fn(Q_, x_, *k):
            ys_, rt, _, _, A_, prior_0, h = parts(k)
            Hs, y_eff = _relinearize(h, ys_, x_)
            Qi = small_inv(Q_)
            return _ekf_info_elements(Hs, y_eff, rt, A_, (Qi, Qi @ A_), prior_0, first=first)
        return fn

    def predicted(with_halo):
        def fn(out_, Q_, *rest):
            halo, k = (rest[:2], rest[2:]) if with_halo else (None, rest)
            _, _, m0_, S0_, A_, _, _ = parts(k)
            return _predictive_moments(*_filtered_moments(out_, D), m0_, S0_, A_, Q_, halo)
        return fn

    def epilogue(pm, pP, *k):
        ys_, rt, *_, h = parts(k)
        H = emission_jacobian(h, pm)
        return mvn_logpdf(ys_, h(pm), H @ pP @ H.transpose(-1, -2) + torch.diag_embed(rt)).sum(dim=1)

    def tangents(*t):
        return (*t, *(None,) * len(consts[0])) if paired else None

    def sweep_planes(i, x_, dx_):
        return _jvp_or_call(planes(i == 0), (Q_c[i], x_, *consts[i]), tangents(dQ_c[i], dx_))

    def sweep_predicted(i, scanned, halo):
        h, dh = ((), ()) if halo is None else halo
        pred, d_pred = _jvp_or_call(predicted(halo is not None), (scanned[0], Q_c[i], *h, *consts[i]),
                                    tangents(scanned[1], dQ_c[i], *dh))
        return pred, d_pred if paired else (None, None)

    x_c = [x.contiguous() for x in shards.split(x_init, 1)]
    pred = [(x, None) for x in x_c]
    d_pred = [(torch.zeros_like(x), None) if paired else (None, None) for x in x_c]
    for _ in range(n_sweeps):
        el = shards.map(lambda i, p, dp: sweep_planes(i, p[0], dp[0]), pred, d_pred)
        if paired:
            outs = filter_prefix_paired_sharded([e[0] for e in el], [e[1].contiguous() for e in el])
        else:
            outs = [(o, None) for o in filter_prefix_sharded([e[0] for e in el])]
        pred, d_pred = zip(*shards.map(sweep_predicted, outs, _halos(outs, D)))

    lls = shards.map(lambda i, p, dp: _jvp_or_call(epilogue, (*p, *consts[i]), tangents(*dp)), pred, d_pred)
    ll = shards.total([x[0] for x in lls], ys.device)
    return ll, shards.total([x[1] for x in lls], ys.device) if paired else None


def ekf_nll_parallel_planes_batched(ys, m0, S0, A, Q, h_fn, r, x_init, n_sweeps: int = 3,
                                    shards=None) -> torch.Tensor:
    """Iterated-EKF marginal log-likelihoods (N,) of N lanes, plane-native:
    ys (N, T, O), parameters with a leading N, ``h_fn: (..., D) -> (..., O)``, r
    (N, O) constant or (N, T, O), x_init (N, T, D) the first linearization
    trajectory. ``n_sweeps = k`` matches ``ekf_parallel`` with
    ``n_iters = k - 1`` (the same fixed point, the sequential EKF). With
    ``shards`` the time axis is split over them."""
    return _ekf_nll(ys, m0, S0, A, Q, None, h_fn, r, x_init, n_sweeps, shards)[0]


def ekf_nll_paired_batched(ys, m0, S0, A, Q, dQ, h_fn, r, x_init, n_sweeps: int = 3, shards=None):
    """(ll (N,), d ll (N,)) of ``ekf_nll_parallel_planes_batched`` along the
    tangent dQ of Q (the s-optimizer's: dQ = Q along log s), forward mode by
    hand: ``torch.func.jvp`` of the plain-PyTorch stages around one paired
    scan launch per sweep (per shard, with ``shards``)."""
    return _ekf_nll(ys, m0, S0, A, Q, dQ, h_fn, r, x_init, n_sweeps, shards)
