"""Ensemble statistics, smoothing-parameter optimization and the smoother
driver: the single-device part of ``eks_tpu/core.py``.

Semantics kept from the JAX package:
  * ensemble: median/mean consensus (the median through a compare-exchange
    network, bit-equal to ``jnp.nanmedian``), confidence-weighted variance
    ``nanvar/mean_conf`` with ddof = 0, the n_models == 1 fallback
    ``1/max(conf, 1e-5)``, NaN variance -> ``nan_replacement``.
  * s init: std of frame-to-frame ensemble-variance diffs over the first
    2000 frames, rounded to 5 dp, fallback 2.0.
  * optimizer: the loss uses frames cropped by ``s_frames`` and a CONSTANT
    diagonal R = time median of the ensemble variances floored at
    ``min_R_var = 1e-4``, while the final smoother uses full-length
    time-varying R.
  * Adam(1.0) on lr-scaled gradients of the NLL w.r.t. log s clipped to
    ±8, early stop when |loss - prev| < tol*|log(max(prev, 1e-12))| + 1e-6,
    hard cap 300 iterations, per-lane state that commits only while the lane
    is active. The block sums of the member NLLs, the update, the stop rule
    and the commits are one step (``ops/adam_step.py``): one kernel launch
    an iteration on the card. The pupil family runs the same loop on its
    two sigmoid-space parameters per session, as Adam(lr) on the raw
    gradient, in plain PyTorch.

The loss runs through the fused NLL (kernel A, paired form) on the card, or
at more than eight observations through the staged plane NLL and the paired
lane-batched scan; its derivative is forward-mode, from the scalar table's
tangent. At kernel A's shapes the table and its tangent are one launch of
the table kernel on the card; beyond them, forward mode through
``pkalman._pack_scalars`` (``filters.linear_member_lls`` chooses, once per
optimizer call). With a nonlinear emission ``h_fn`` (the calibrated
multi-camera family) the loss is
the iterated-EKF plane NLL, relinearized ``_EKF_OPT_SWEEPS_WARM + 1`` times
per evaluation from a given linearization trajectory ``x_init``
(``_EKF_OPT_SWEEPS_COLD + 1`` from the broadcast prior), each sweep one
paired lane-batched scan; the final pass is the iterated parallel EKF
smoother, started from the broadcast prior.

With ``devices`` > 1 the smoothing step is sharded over a mesh of that many
devices (``ops/shards.py``): the keypoint axis (``partition="keypoint"``,
each shard the whole single-device pipeline on its own lanes:
``optimize_blocks_sharded`` and ``smooth_all_sharded`` here) or the time
axis (``partition="time"``, every scan of the loss and the final pass split
into chunks with carries across them, in ``ops/filters.py``).
"""

from __future__ import annotations

import logging
from typing import Literal

import numpy as np
import torch

from eks_tpu_torch import tracing
from eks_tpu_torch.marker_array import MarkerArray
from eks_tpu_torch.ops import shards
from eks_tpu_torch.ops.adam_step import B1, B2, EPS, AdamState, AdamStep, MemberNLL, adam_state
from eks_tpu_torch.ops.filters import (
    ekf_nll_paired_batched,
    eks_parallel,
    kalman_smoother_parallel,
    linear_member_lls,
)
from eks_tpu_torch.ops.kalman import kalman_filter, kalman_smoother
from eks_tpu_torch.ops.linalg import jvp
from eks_tpu_torch.ops.pkalman import paired_scaled_q
from eks_tpu_torch.utils import crop_frames

logger = logging.getLogger(__name__)

__all__ = [
    "compute_initial_guesses",
    "constant_R_from_timevarying",
    "ensemble",
    "optimize_blocks_sharded",
    "optimize_smooth_param",
    "run_kalman_smoother",
    "smooth_all_sharded",
]

# --------------------------------------------------------------------------- #
# NaN-aware statistics with the JAX package's exact semantics
# --------------------------------------------------------------------------- #
def _nanmedian_small(a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.nanmedian`` over a SMALL axis through an unrolled odd-even
    transposition network: NaNs become +inf sentinels with an explicit
    non-NaN count, and the two middle values are averaged as
    ``0.5 * (lo + hi)`` (``torch.nanmedian`` returns the lower one)."""
    a = a.movedim(dim, 0)
    m = a.shape[0]
    isnan = torch.isnan(a)
    n = (~isnan).sum(dim=0)
    inf = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
    rows = [torch.where(isnan[i], inf, a[i]) for i in range(m)]
    for p in range(m):
        for i in range(p % 2, m - 1, 2):
            lo = torch.minimum(rows[i], rows[i + 1])
            rows[i + 1] = torch.maximum(rows[i], rows[i + 1])
            rows[i] = lo
    idx_lo = torch.clamp(n - 1, min=0) // 2
    idx_hi = torch.clamp(n // 2, max=m - 1)
    sel_lo = sel_hi = torch.zeros_like(rows[0])
    for i in range(m):
        sel_lo = torch.where(idx_lo == i, rows[i], sel_lo)
        sel_hi = torch.where(idx_hi == i, rows[i], sel_hi)
    med = 0.5 * (sel_lo + sel_hi)
    return torch.where(n == 0, torch.full_like(med, float("nan")), med)


def _nanmedian(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.nanmedian`` over any axis: sort with NaN last, then average the
    two middle values of the non-NaN ones (midpoint rule)."""
    isnan = torch.isnan(a)
    n = (~isnan).sum(dim=dim, keepdim=True)
    srt = torch.sort(torch.where(isnan, torch.full_like(a, float("inf")), a), dim=dim).values
    lo = torch.gather(srt, dim, torch.clamp(n - 1, min=0) // 2)
    hi = torch.gather(srt, dim, torch.clamp(n // 2, max=a.shape[dim] - 1))
    med = ((lo + hi) * 0.5).squeeze(dim)
    return torch.where(n.squeeze(dim) == 0, torch.full_like(med, float("nan")), med)


#: up to this size an axis counts as small (the ensemble's models): the
#: median takes the network, sums run one add at a time in index order
_SMALL_AXIS = 16


def _nanmedian_models(a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    if a.shape[dim] <= _SMALL_AXIS:
        return _nanmedian_small(a, dim=dim)
    return _nanmedian(a, dim=dim)


def _is_small(a: torch.Tensor, dim) -> bool:
    return isinstance(dim, int) and a.shape[dim] <= _SMALL_AXIS


def _sum(a: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """Sum over ``dim``. Over a small axis the rows are added one at a time
    in index order, the order of XLA's reduction loop, so sums are
    bit-equal to the JAX package's (``Tensor.sum`` vectorizes its own way)."""
    if not _is_small(a, dim):
        return a.sum(dim=dim, keepdim=keepdim)
    rows = a.movedim(dim, 0)
    total = rows[0]
    for row in rows[1:]:
        total = total + row
    return total.unsqueeze(dim) if keepdim else total


def _nanmean(a: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``jnp.nanmean``: NaN-zeroed sum over the non-NaN count."""
    isnan = torch.isnan(a)
    total = _sum(torch.where(isnan, torch.zeros_like(a), a), dim, keepdim)
    return total / (~isnan).sum(dim=dim, keepdim=keepdim).to(a.dtype)


def _nanvar(a: torch.Tensor, dim: int, scale: torch.Tensor | None = None) -> torch.Tensor:
    """``jnp.nanvar`` with ddof = 0 (torch has no nanvar, and ``torch.var``
    defaults to ddof = 1), divided by ``scale`` if one is given: XLA folds
    ``nanvar(a) / scale`` into one division by ``count * scale``, and so does
    this function. Over a small axis the squares are accumulated as
    XLA's reduction does, one fused multiply-add per row in index order (the
    float64 product of two float32 values is exact, so adding in float64 and
    rounding once to float32 reproduces the fused operation), so the result
    is bit-equal to the JAX package's."""
    isnan = torch.isnan(a)
    centered = torch.where(isnan, torch.zeros_like(a), a - _nanmean(a, dim, keepdim=True))
    count = (~isnan).sum(dim=dim)
    if _is_small(a, dim):
        result = torch.zeros_like(centered.select(dim, 0))
        for row in centered.movedim(dim, 0).double():
            result = (row * row + result.double()).to(a.dtype)
    else:
        result = (centered * centered).sum(dim=dim)
    empty = count <= 0
    result = torch.where(empty, torch.full_like(result, float("nan")), result)
    divisor = torch.where(empty, torch.ones_like(count), count).to(a.dtype)
    return result / (divisor if scale is None else divisor * scale)


def _ensemble_kernel(data_x, data_y, data_lh, n_models, avg_mode, var_mode, nan_rep):
    """(M, T, K) prediction planes -> (T, K, 5) stats
    [x, y, var_x, var_y, likelihood]. The mean confidence is the summed
    likelihood times ``1 / n_models``, the product XLA makes of a division
    by a constant."""
    avg_fn = _nanmedian_models if avg_mode == "median" else (lambda a, dim: _nanmean(a, dim))
    avg_x = avg_fn(data_x, dim=0)
    avg_y = avg_fn(data_y, dim=0)
    mean_conf = _sum(data_lh, 0) * (1.0 / n_models)
    if n_models == 1:
        single_var = 1.0 / torch.clamp(mean_conf, min=1e-5)
        var_x = var_y = single_var
    elif var_mode in ("conf_weighted_var", "confidence_weighted_var"):
        var_x = _nanvar(data_x, 0, mean_conf)
        var_y = _nanvar(data_y, 0, mean_conf)
    else:
        var_x = _nanvar(data_x, 0)
        var_y = _nanvar(data_y, 0)
    var_x = torch.nan_to_num(var_x, nan=nan_rep)
    var_y = torch.nan_to_num(var_y, nan=nan_rep)
    return torch.stack([avg_x, avg_y, var_x, var_y, mean_conf], dim=-1)


def ensemble(
    marker_array: MarkerArray,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    nan_replacement: float = 1000.0,
) -> MarkerArray:
    """Ensemble consensus and variance over the models axis, on the host.

    Input fields ``[x, y, likelihood]`` with shape (M, C, T, K, 3); output is
    a (1, C, T, K, 5) float32 MarkerArray with fields
    ``[x, y, var_x, var_y, likelihood]``, likelihood being the mean model
    confidence. For the families whose prep stays in host numpy."""
    planes = torch.as_tensor(np.ascontiguousarray(
        marker_array.slice_fields("x", "y", "likelihood").array, dtype=np.float32
    ))
    stats = _ensemble_kernel(
        planes[..., 0], planes[..., 1], planes[..., 2], marker_array.shape[0],
        avg_mode, var_mode, float(nan_replacement),
    )
    return MarkerArray(
        stats.numpy()[None, ...], data_fields=["x", "y", "var_x", "var_y", "likelihood"]
    )


def compute_initial_guesses(ensemble_vars: np.ndarray | list) -> float:
    """Initial guess for ``s`` on the host: std of frame-to-frame
    ensemble-variance changes over the first 2000 frames, rounded to 5 dp."""
    ev = np.asarray(ensemble_vars)[:2000]
    if ev.shape[0] < 2:
        raise ValueError("Initial-s heuristic needs at least two frames of ensemble variance.")
    diffs = ev[1:] - ev[:-1]
    return float(round(np.nanstd(diffs), 5))


def constant_R_from_timevarying(R_t_np: np.ndarray, min_var: float = 1e-4) -> np.ndarray:
    """(T, O, O) time-varying R -> constant diagonal R on the host: the time
    median of the per-step diagonals, floored at ``min_var``."""
    diag_ts = np.diagonal(R_t_np, axis1=-2, axis2=-1)
    med = np.clip(np.nanmedian(diag_ts, axis=0), min_var, np.inf)
    return np.diag(med).astype(R_t_np.dtype)


def _device_constant_r(ev_kto: torch.Tensor, min_var: float) -> torch.Tensor:
    """(K, T, O) variances -> (K, O) constant diagonal R: the time median of
    the variances floored at 1e-12, floored again at ``min_var``."""
    floored = torch.clamp(ev_kto, min=1e-12)
    return torch.clamp(_nanmedian(floored, dim=1), min=min_var)


def _device_s_guesses(ev_tko: torch.Tensor) -> torch.Tensor:
    """Initial s per keypoint from (T, K, O) variances: std of frame-to-frame
    diffs over the first 2000 frames, rounded to 5 dp."""
    ev = ev_tko[:2000]
    diffs = ev[1:] - ev[:-1]
    dev = diffs - _nanmean(diffs, dim=(0, 2), keepdim=True)
    std = torch.sqrt(_nanmean(dev * dev, dim=(0, 2)))
    return torch.round(std * 1e5) / 1e5


# --------------------------------------------------------------------------- #
# the optimizer
# --------------------------------------------------------------------------- #
class _RawGradientAdam:
    """The pupil optimizer's Adam state over a parameter of shape (n_lanes,)
    or (n_lanes, n_params), and its step in plain PyTorch: optax's
    ``adam(lr)`` on the raw gradient, b1 = 0.9, b2 = 0.999, eps = 1e-8,
    eps_root = 0, count incremented before the bias correction; a lane's
    state commits only while it is active. The interface of
    ``ops.adam_step.AdamStep``: ``running()``, ``step(loss, grad)``,
    ``state``."""

    def __init__(self, init: torch.Tensor, lr: float, tol: float, safety_cap: int):
        self.lr, self.tol, self.safety_cap = lr, tol, safety_cap
        dev, dt = init.device, init.dtype
        self.per_lane = (init.shape[0],) + (1,) * (init.ndim - 1)  # lane vectors against the parameter
        self.state = adam_state(init)
        self.floor = torch.tensor(1e-12, dtype=dt, device=dev)
        self.b1_t = torch.tensor(B1, dtype=dt, device=dev)
        self.b2_t = torch.tensor(B2, dtype=dt, device=dev)

    def running(self) -> bool:
        self.active = ~self.state.done & (self.state.iters < self.safety_cap)
        return bool(self.active.any())

    def step(self, loss: torch.Tensor, grad: torch.Tensor) -> None:
        s_log, mu, nu, count, prev_loss, iters, done = self.state
        active = self.active
        mu_new = (1 - B1) * grad + B1 * mu
        nu_new = (1 - B2) * (grad * grad) + B2 * nu
        count_new = count + 1
        cf = count_new.to(s_log.dtype).reshape(self.per_lane)
        mu_hat = mu_new / (1 - torch.pow(self.b1_t, cf))
        nu_hat = nu_new / (1 - torch.pow(self.b2_t, cf))
        s_new = s_log + -self.lr * (mu_hat / (torch.sqrt(nu_hat + 0.0) + EPS))
        rel_tol = self.tol * torch.abs(torch.log(torch.maximum(prev_loss, self.floor)))
        stop = torch.isfinite(prev_loss) & (torch.abs(loss - prev_loss) < rel_tol + 1e-6)
        active_p = active.reshape(self.per_lane)
        self.state = AdamState(
            torch.where(active_p, s_new, s_log),
            torch.where(active_p, mu_new, mu),
            torch.where(active_p, nu_new, nu),
            torch.where(active, count_new, count),
            torch.where(active, loss, prev_loss),
            torch.where(active, iters + 1, iters),
            torch.where(active, stop, done),
        )


def _joint_masked_adam(loss_and_grad, init: torch.Tensor, lr: float, tol: float,
                       safety_cap: int, timings: dict | None = None,
                       scale_gradient: bool = True):
    """Per-lane Adam with masked carries and the reference stop rule, from
    ``init`` (n_lanes,) or (n_lanes, n_params). The update is optax's Adam:
    b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0, count incremented
    before the bias correction. With ``scale_gradient`` (the s-optimizer)
    it is ``adam(1.0)`` fed ``grad * lr``, ``loss_and_grad`` is an
    ``adam_step.MemberNLL`` whose members' NLLs each block sums, and the
    step is ``adam_step.AdamStep`` (one kernel launch an iteration on the
    card); without it (the pupil optimizer) it is ``adam(lr)`` on the raw
    gradient of ``loss_and_grad(param) -> (loss (n_lanes,), grad like
    param)``, in plain PyTorch (``_RawGradientAdam``). The two differ
    through eps. A lane stops when |loss - prev| < tol * |log(max(prev,
    1e-12))| + 1e-6 or at ``safety_cap`` iterations; its state commits only
    while it is active, and the loop ends when no lane is (one host sync per
    iteration). With ``timings`` each iteration records its spans
    "adam.stop_test", "adam.loss" and "adam.update" (``tracing``). Returns
    (param, last_loss (n_lanes,), iters (n_lanes,))."""
    if scale_gradient:
        evaluate = loss_and_grad.member_lls
        adam = AdamStep(init, loss_and_grad.mask, loss_and_grad.b_max, lr, tol, safety_cap)
    else:
        evaluate, adam = loss_and_grad, _RawGradientAdam(init, lr, tol, safety_cap)
    n_iter = 0
    sp = tracing.adam_spans(timings)
    while True:
        if sp is not None:
            i = sp.begin("adam.stop_test")
        running = adam.running()
        if sp is not None:
            sp.end(i)
        if not running:
            break
        n_iter += 1
        if sp is not None:
            i = sp.begin("adam.loss")
        out = evaluate(adam.state.s_log)
        if sp is not None:
            sp.end(i)
            i = sp.begin("adam.update")
        adam.step(*out)
        if sp is not None:
            sp.end(i)
    if sp is not None:
        tracing.first_loss(sp)
    if timings is not None:
        timings["adam_iters"] = n_iter
    return adam.state.s_log, adam.state.prev_loss, adam.state.iters


# relinearization sweeps of the EKF loss: from a good linearization
# trajectory (the calibrated family's triangulated 3-D points) 2 warm sweeps
# sit at the sequential-EKF fixed point that 12 cold sweeps reach from the
# broadcast prior; each evaluation runs one sweep more than these
_EKF_OPT_SWEEPS_WARM = 2
_EKF_OPT_SWEEPS_COLD = 12


def _optimize_blocks_joint(yB, rB, m0B, S0B, AB, QB, CB, maskB, s_log_init,
                           lr, s_lo, s_hi, tol, safety_cap, sequential=False,
                           timings=None, h_fn=None, xB=None, time_mesh=None):
    """Tune one log s per block: every iteration evaluates all
    n_blocks * B_max member filters at once, and the Adam step
    (``adam_step.AdamStep``, one launch on the card) sums the masked member
    NLLs per block. On the card the loss is one launch of the table kernel
    (the scalar table and its tangent from log s) and one paired kernel A launch
    at kernel A's (D, O) instances, and beyond (five cameras or more) the
    forward-mode table and the staged plane NLL with one paired lane-batched
    scan launch. With a nonlinear
    emission ``h_fn`` (``CB`` is not read) it is the iterated-EKF NLL
    (``filters.ekf_nll_paired_batched``: one paired lane-batched scan per
    sweep), relinearized from ``xB`` (n_blocks, B_max, T, D), or from the
    broadcast prior where that is None. ``sequential`` takes the
    float64-oracle sequential filter instead. Non-finite member NLLs count
    as 1e12 with a zero gradient. With ``time_mesh`` the loss's time axis is
    split over its devices (the staged loss over the sharded paired scan in
    the place of kernel A, or the time-sharded EKF loss); the sequential
    oracle runs unsharded. The linear loss's route is
    ``filters.linear_member_lls``'s."""
    n_blocks, b_max = yB.shape[:2]
    n_flat = n_blocks * b_max
    T, D = yB.shape[2], m0B.shape[-1]
    time_shards = None if time_mesh is None or sequential else shards.TimeShards(time_mesh, T)

    def flat(x):
        return x.reshape((n_flat,) + tuple(x.shape[2:]))

    yF, rF, m0F, S0F, AF, QF = map(flat, (yB, rB, m0B, S0B, AB, QB))
    CF = None if h_fn is not None else flat(CB)
    maskF = flat(maskB)

    # the members' (ll, d ll / d log s) at log s
    if sequential:
        def member_lls(s_log):
            sQ, dsQ = paired_scaled_q(s_log, QF, b_max, s_lo, s_hi)
            return jvp(
                lambda q: kalman_filter(yF, m0F, S0F, AF, q, CF, rF, h_fn=h_fn).log_likelihood, (sQ,), (dsQ,))
    elif h_fn is not None:
        if xB is None:
            xF, n_sweeps = m0F[:, None].expand(n_flat, T, D), _EKF_OPT_SWEEPS_COLD + 1
        else:
            xF, n_sweeps = flat(xB), _EKF_OPT_SWEEPS_WARM + 1

        def member_lls(s_log):
            sQ, dsQ = paired_scaled_q(s_log, QF, b_max, s_lo, s_hi)
            return ekf_nll_paired_batched(yF, m0F, S0F, AF, sQ, dsQ, h_fn, rF, xF, n_sweeps=n_sweeps,
                                          shards=time_shards)
    else:
        member_lls = linear_member_lls(yF, rF, m0F, S0F, AF, QF, CF, b_max, s_lo, s_hi, time_shards)

    return _joint_masked_adam(MemberNLL(member_lls, maskF.contiguous(), b_max), s_log_init, lr, tol, safety_cap,
                              timings)


def optimize_blocks_sharded(mesh: tuple, operands: list, timings: dict | None = None, **opts):
    """``_optimize_blocks_joint`` with the block axis of ``operands`` (yB,
    rB, m0B, S0B, AB, QB, CB, maskB, s_log_init, xB (or None)) split over
    the mesh (``shards.split_leading``): every shard's Adam loop runs on its
    device and stops when its own blocks converge. Returns (log s, last
    loss, iterations) per block on the device of ``operands[0]``; with
    ``timings``, "adam_iters_per_shard" and "adam_iters" (their maximum)."""
    home = operands[0].device
    devices, parts = shards.split_leading(mesh, operands)
    h_fn = opts.pop("h_fn", None)
    shard_timings = [{} for _ in devices]

    def run(i, ops, tm):
        *arrays, s_log_init, xB = ops
        return _optimize_blocks_joint(*arrays, s_log_init, h_fn=shards.emission_on(h_fn, devices[i]), xB=xB,
                                      timings=tm, **opts)

    results = shards.map_shards(run, devices, parts, shard_timings)
    if timings is not None:
        timings["adam_iters_per_shard"] = [tm.get("adam_iters", 0) for tm in shard_timings]
        timings["adam_iters"] = max(timings["adam_iters_per_shard"])
    return tuple(torch.cat([r[j].to(home) for r in results]) for j in range(3))


def optimize_smooth_param(
    ys: torch.Tensor,  # (K, T, O)
    m0s: torch.Tensor,  # (K, D)
    S0s: torch.Tensor,  # (K, D, D)
    As: torch.Tensor,  # (K, D, D)
    Cs: torch.Tensor,  # (K, O, D)
    Qs: torch.Tensor,  # (K, D, D)
    ensemble_vars: torch.Tensor,  # (T, K, O)
    blocks: list | None,
    s_frames: list | None,
    s_guess_per_k: torch.Tensor,  # (K,)
    lr: float = 0.25,
    s_bounds_log: tuple = (-8.0, 8.0),
    tol: float = 1e-2,
    safety_cap: int = 300,
    min_R_var: float = 1e-4,
    h_fn=None,
    sequential: bool = False,
    x_init: torch.Tensor | None = None,  # (K, T, D) EKF linearization init
    timings: dict | None = None,
    mesh: tuple | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
) -> torch.Tensor:
    """Optimize ``s`` per block; returns per-keypoint s (K,) on the device
    of ``ys``. Keypoints missing from a partial ``blocks`` list become
    singleton blocks. With ``h_fn`` (a nonlinear emission) the loss is the
    iterated EKF's, relinearized from ``x_init`` (the calibrated family's
    triangulated trajectories, cropped with ``ys``) when given. With
    ``mesh`` (``ops.shards.make_mesh``) the block axis (``partition=
    "keypoint"``: each shard's Adam loop on its device; no block is split)
    or the loss's time axis (``"time"``) is sharded over it; ``timings``
    then gets the per-shard Adam iterations ("adam_iters_per_shard")."""
    K = ys.shape[0]
    dev = ys.device
    if not blocks:
        blocks = [[k] for k in range(K)]
    else:
        listed = {k for b in blocks for k in b}
        blocks = list(blocks) + [[k] for k in range(K) if k not in listed]
    logger.debug(f"keypoint block structure for shared s: {blocks}")

    # loss-frame crop, then the time median of the floored variances
    y_cropped = crop_frames(ys, s_frames, dim=1)
    r_const = _device_constant_r(
        crop_frames(ensemble_vars, s_frames, dim=0).transpose(0, 1), float(min_R_var)
    )

    # pad blocks to a rectangle; padding lanes reuse member 0 with zero mask
    b_max = max(len(b) for b in blocks)
    n_blocks = len(blocks)
    idx = np.zeros((n_blocks, b_max), dtype=np.int64)
    mask = np.zeros((n_blocks, b_max), dtype=np.float32)
    for i, b in enumerate(blocks):
        idx[i, : len(b)] = b
        idx[i, len(b):] = b[0]
        mask[i, : len(b)] = 1.0
    idx_t = torch.as_tensor(idx, device=dev)
    mask_t = torch.as_tensor(mask, dtype=ys.dtype, device=dev)

    gB = s_guess_per_k.to(ys.dtype)[idx_t]
    s0 = (gB * mask_t).sum(dim=1) / mask_t.sum(dim=1)
    s_log_init = torch.log(torch.clamp(s0, 1e-6, 1e3))

    s_lo, s_hi = s_bounds_log
    opts = dict(lr=float(lr), s_lo=float(s_lo), s_hi=float(s_hi), tol=float(tol),
                safety_cap=int(safety_cap), sequential=sequential)
    xB = None if x_init is None else crop_frames(x_init, s_frames, dim=1)[idx_t]
    operands = [y_cropped[idx_t], r_const[idx_t], m0s[idx_t], S0s[idx_t], As[idx_t],
                Qs[idx_t], Cs[idx_t], mask_t, s_log_init]
    if mesh is not None and partition == "keypoint":
        s_log_f, last_loss, iters = optimize_blocks_sharded(
            mesh, operands + [xB], h_fn=h_fn, timings=timings, **opts)
    else:
        s_log_f, last_loss, iters = _optimize_blocks_joint(
            *operands, h_fn=h_fn, xB=xB, timings=timings,
            time_mesh=mesh if partition == "time" else None, **opts,
        )
    if logger.isEnabledFor(logging.DEBUG):
        s_host, ll_host, it_host = (x.cpu().numpy() for x in (s_log_f, last_loss, iters))
        for i, b in enumerate(blocks):
            logger.debug(
                f"s-opt block {list(b)}: converged to "
                f"s={float(np.exp(np.clip(s_host[i], s_lo, s_hi))):.6g} "
                f"after {int(it_host[i])} iters (NLL {float(ll_host[i]):.6f})"
            )
    block_of_k = np.empty(K, dtype=np.int64)
    for i, b in enumerate(blocks):
        for k in b:
            block_of_k[k] = i
    s_star = torch.exp(torch.clamp(s_log_f, s_lo, s_hi))
    return s_star[torch.as_tensor(block_of_k, device=dev)]


# --------------------------------------------------------------------------- #
# final smoothing pass
# --------------------------------------------------------------------------- #
def _smooth_all(ys, m0s, S0s, As, Qs, Cs, s_finals, rs, h_fn=None, sequential=False, time_mesh=None):
    """Smoothed means (K, T, D) and covariances (K, T, D, D) of every lane
    with process noise ``s_k * Q_k`` and time-varying diagonal R ``rs``.
    With ``h_fn`` the iterated parallel EKF smoother, from the broadcast
    prior (12 relinearizations, then the last). With ``time_mesh`` the time
    axis is split over its devices (the sequential oracle runs unsharded)."""
    sQ = s_finals[:, None, None] * Qs
    time_shards = None if time_mesh is None else shards.TimeShards(time_mesh, ys.shape[1])
    if sequential:
        res = kalman_smoother(ys, m0s, S0s, As, sQ, Cs, rs, h_fn=h_fn)
    elif h_fn is not None:
        res = eks_parallel(ys, m0s, S0s, As, sQ, h_fn, rs, shards=time_shards)
    else:
        res = kalman_smoother_parallel(ys, m0s, S0s, As, sQ, Cs, rs, time_shards)
    return res.smoothed_means, res.smoothed_covs


def smooth_all_sharded(mesh: tuple, operands: list, h_fn=None, sequential: bool = False):
    """``_smooth_all`` with the lane axis of ``operands`` (ys, m0s, S0s, As,
    Qs, Cs, s_finals, rs) split over the mesh (``shards.split_leading``),
    each shard on its device. Returns smoothed means and covariances on the
    device of ``operands[0]``."""
    home = operands[0].device
    devices, parts = shards.split_leading(mesh, operands)
    results = shards.map_shards(
        lambda i, ops: _smooth_all(*ops, h_fn=shards.emission_on(h_fn, devices[i]), sequential=sequential),
        devices, parts)
    return tuple(torch.cat([r[j].to(home) for r in results]) for j in range(2))


@tracing.entry_point
def run_kalman_smoother(
    ys: torch.Tensor,  # (K, T, O)
    m0s: torch.Tensor,  # (K, D)
    S0s: torch.Tensor,  # (K, D, D)
    As: torch.Tensor,  # (K, D, D)
    Cs: torch.Tensor,  # (K, O, D)
    Qs: torch.Tensor,  # (K, D, D)
    ensemble_vars: torch.Tensor,  # (T, K, O)
    s_frames: list | None = None,
    smooth_param: float | list | None = None,
    blocks: list | None = None,
    lr: float = 0.25,
    s_bounds_log: tuple = (-8.0, 8.0),
    tol: float = 1e-2,
    safety_cap: int = 300,
    h_fn=None,
    sequential: bool = False,
    x_init: torch.Tensor | None = None,  # (K, T, D) EKF linearization init
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    timings: dict | None = None,
) -> tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """Tune ``s`` (unless given) and run the final smoother for K keypoints.

    Linear model per keypoint unless ``h_fn`` is given: ``x_{t+1} = A x_t +
    w_t``, ``y_t = C x_t + v_t``, ``w ~ N(0, s Q)``, ``v_t ~ N(0,
    diag(ensemble_vars[t]))``; with ``h_fn`` (..., D) -> (..., O) the emission is
    ``h(x_t)`` and ``Cs`` is not read, and ``x_init`` (the optimizer's
    linearization trajectories) is optional. Every tensor lies on one
    device. With ``timings`` (a dict) the devices are synchronized between
    the stages and their seconds are recorded ("optimizer", "final_pass")
    with the Adam iteration count, their spans and the Adam iterations'
    (``eks_tpu_torch.tracing``), and this call's kernel launches.

    ``devices`` > 1 shards the work over a mesh of that many devices of the
    type of ``ys``'s (``ops.shards.make_mesh``: it raises when the host has
    fewer cards, and never puts work on the CPU when a card was asked for);
    ``partition`` picks the axis: ``"keypoint"`` (data parallelism over the
    independent lanes, the default, right whenever K >= devices) or
    ``"time"`` (sequence parallelism: the scans split the frame axis, with
    carries across the chunks). Without a mesh ``partition`` is not read.

    Returns:
        s_finals (K,) host array; smoothed means (K, T, D) and covs
        (K, T, D, D) on the device of ``ys``.
    """
    if partition not in ("keypoint", "time"):
        raise ValueError(f"unknown partition {partition!r}: use 'keypoint' or 'time'")
    K = ys.shape[0]
    dev, dt = ys.device, ys.dtype
    mesh = None
    if devices is not None and devices > 1:
        mesh = shards.make_mesh(devices, dev)
        logger.info(f"{partition}-axis sharding over {devices} devices: {[str(d) for d in mesh]}")
    synced = (dev,) + (mesh or ())
    if ensemble_vars.shape[0] < 2:
        raise ValueError("Initial-s heuristic needs at least two frames of ensemble variance.")

    span = tracing.begin(timings, "optimizer")
    if smooth_param is not None:
        s_finals = torch.as_tensor(
            np.broadcast_to(np.asarray(smooth_param, dtype=np.float64), (K,)).copy(),
            dtype=dt, device=dev,
        )
    else:
        g = _device_s_guesses(ensemble_vars)
        s_guess = torch.where(torch.isfinite(g) & (g > 0.0), g, torch.full_like(g, 2.0))
        s_finals = optimize_smooth_param(
            ys, m0s, S0s, As, Cs, Qs, ensemble_vars, blocks, s_frames, s_guess,
            lr=lr, s_bounds_log=s_bounds_log, tol=tol, safety_cap=safety_cap,
            h_fn=h_fn, sequential=sequential, x_init=x_init, timings=timings,
            mesh=mesh, partition=partition,
        )
    tracing.end(timings, span, *synced, stage=True)

    span = tracing.begin(timings, "final_pass")
    rs = torch.clamp(ensemble_vars.transpose(0, 1), min=1e-12).contiguous()  # (K, T, O)
    if mesh is not None and partition == "keypoint":
        ms, Vs = smooth_all_sharded(mesh, [ys, m0s, S0s, As, Qs, Cs, s_finals, rs], h_fn=h_fn,
                                    sequential=sequential)
    else:
        ms, Vs = _smooth_all(ys, m0s, S0s, As, Qs, Cs, s_finals, rs, h_fn=h_fn, sequential=sequential,
                             time_mesh=mesh)
    tracing.end(timings, span, *synced, stage=True)
    return s_finals.cpu().numpy().astype(np.float64), ms, Vs
