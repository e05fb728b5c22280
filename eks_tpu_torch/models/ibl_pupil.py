"""IBL pupil smoother: 3-state AR(1) latent model (diameter + center of mass).

Counterpart of ``eks_tpu/models/ibl_pupil.py``. Model: latent
``x = [diameter, com_x, com_y]`` with AR(1) dynamics ``A = diag(s_d, s_c,
s_c)`` and stationary process noise ``Q = diag(var * (1 - s^2))``; a fixed
8x3 emission matrix encodes pupil geometry (top_y = com_y - d/2, right_x =
com_x + d/2, ...). The two smoothing parameters live in (0, 1) and are
optimized in sigmoid-unconstrained space against the filter NLL with
time-varying R (Adam lr=5e-3, tol=1e-6, cap=5000).

The prep (ensemble statistics, diameter and centre-of-mass estimators, KF
init) and the output packaging are host numpy, as in the JAX package. The
optimizer and the final smoother run on one device. The loss is the fused
time-varying-R NLL (kernel C, ``ops/fused_nll.py``) in its paired form: each
session rides two kernel lanes, one per parameter, with unit tangents, so one
launch returns the loss and both partial derivatives of every session. The
final pass's forward filter is the prefix-scan kernel at D = 3 (kernel B,
``ops/fused_filter.py``). Several sessions of equal length share one Adam
loop, each stopping by its own rule. With ``devices`` > 1 the frame axis,
the model's only shardable axis, is split over a mesh of that many devices
(``ops/shards.py``) for both stages: the loss is then the staged
time-varying-R NLL over the sharded paired scan (kernel C, which fuses a
lane's whole T, cannot span the shards), and the final pass the time-sharded
smoother.

Output parity quirks preserved deliberately (they are what the reference's
golden files contain):
  * data blocks are packed in [top, right, bottom, left] order while columns
    are labeled in the [top, bottom, right, left] keypoint order;
  * block i's likelihood column is ``ensemble_likes[:, i]`` — the i-th
    keypoint's likelihood, not the block's;
  * posterior variances are read at indices (i, i) and (i+1, i+1) instead of
    (2i, 2i+1).
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Literal

import numpy as np
import pandas as pd
import torch

from eks_tpu_torch import tracing
from eks_tpu_torch.core import _joint_masked_adam, ensemble
from eks_tpu_torch.marker_array import MarkerArray, input_dfs_to_markerArray
from eks_tpu_torch.ops import shards
from eks_tpu_torch.ops.filters import kalman_smoother_parallel, table_nll_tv_paired_sharded
from eks_tpu_torch.ops.fused_nll import fused_nll_tv_paired
from eks_tpu_torch.ops.kalman import kalman_smoother
from eks_tpu_torch.ops.linalg import jvp
from eks_tpu_torch.ops.pkalman import _pack_scalars_tv, _prior_information
from eks_tpu_torch.utils import (
    crop_frames,
    dlc_frame,
    format_data,
    pull_outputs,
    resolve_device,
    save_dlc_csv,
)

logger = logging.getLogger(__name__)

__all__ = [
    "fit_eks_pupil",
    "fit_eks_pupil_sessions",
    "ensemble_kalman_smoother_ibl_pupil",
    "ensemble_kalman_smoother_ibl_pupil_sessions",
    "get_pupil_location",
    "get_pupil_diameter",
    "add_mean_to_array",
    "run_pupil_kalman_smoother",
    "pupil_optimize_smooth",
]

# the pupil smoother requires this exact keypoint set and order
BODYPART_LIST = ["pupil_top_r", "pupil_bottom_r", "pupil_right_r", "pupil_left_r"]

# emission matrix: rows are (top_x, top_y, bottom_x, bottom_y, right_x,
# right_y, left_x, left_y), state is [diameter, com_x, com_y]
PUPIL_C = np.asarray(
    [
        [0, 1, 0],
        [-0.5, 0, 1],
        [0, 1, 0],
        [0.5, 0, 1],
        [0.5, 1, 0],
        [0, 0, 1],
        [-0.5, 1, 0],
        [0, 0, 1],
    ]
)

# the parameters stay inside (_S_EPS, 1 - _S_EPS)
_S_EPS = 1e-3


def get_pupil_location(dlc: dict) -> np.ndarray:
    """Pupil center-of-mass per frame from the four edge keypoints.

    x: median of (top/bottom nanmedian, left/right median); y: median of
    (top/bottom median, left/right nanmedian): the reference's exact
    NaN-tolerance pattern.
    """
    t = np.vstack((dlc["pupil_top_r_x"], dlc["pupil_top_r_y"])).T
    b = np.vstack((dlc["pupil_bottom_r_x"], dlc["pupil_bottom_r_y"])).T
    le = np.vstack((dlc["pupil_left_r_x"], dlc["pupil_left_r_y"])).T
    r = np.vstack((dlc["pupil_right_r_x"], dlc["pupil_right_r_y"])).T

    center = np.zeros(t.shape)
    tmp_x1 = np.nanmedian(np.hstack([t[:, 0, None], b[:, 0, None]]), axis=1)
    tmp_x2 = np.median(np.hstack([r[:, 0, None], le[:, 0, None]]), axis=1)
    center[:, 0] = np.nanmedian(np.hstack([tmp_x1[:, None], tmp_x2[:, None]]), axis=1)
    tmp_y1 = np.median(np.hstack([t[:, 1, None], b[:, 1, None]]), axis=1)
    tmp_y2 = np.nanmedian(np.hstack([r[:, 1, None], le[:, 1, None]]), axis=1)
    center[:, 1] = np.nanmedian(np.hstack([tmp_y1[:, None], tmp_y2[:, None]]), axis=1)
    return center


def get_pupil_diameter(dlc: dict) -> np.ndarray:
    """Pupil diameter per frame: median of two direct spans and four
    circle-assumption estimates from non-crossing pairs."""
    top, bottom, left, right = [
        np.vstack((dlc[f"pupil_{p}_r_x"], dlc[f"pupil_{p}_r_y"]))
        for p in ["top", "bottom", "left", "right"]
    ]
    diameters = [
        np.linalg.norm(top - bottom, axis=0),
        np.linalg.norm(left - right, axis=0),
    ]
    for a, b in [(top, left), (top, right), (bottom, left), (bottom, right)]:
        diameters.append(np.linalg.norm(a - b, axis=0) * 2**0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        return np.nanmedian(diameters, axis=0)


def add_mean_to_array(
    pred_arr: np.ndarray, keys: list[str], mean_x: float, mean_y: float
) -> dict[str, np.ndarray]:
    """Re-add COM means: keys containing 'x' get mean_x, others mean_y."""
    out = {}
    for i, key in enumerate(keys):
        out[key] = pred_arr[:, i] + (mean_x if "x" in key else mean_y)
    return out


@tracing.entry_point
def fit_eks_pupil(
    input_source: str | list,
    save_file: str,
    smooth_params: list | None = None,
    s_frames: list | None = None,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    device: str | torch.device = "cuda",
) -> tuple:
    """Load ensemble CSVs and run the pupil smoother.

    ``devices`` > 1 shards the frame axis over that many devices;
    ``partition`` is accepted for interface uniformity with the other
    families and not read (the pupil model is one joint 8-observation
    sequence with no keypoint lanes, so time is its only shardable axis).
    ``device`` is where the optimizer and the smoother run; "cuda" (the
    default) raises when no card is visible.

    Returns:
        (df_smoothed, smooth_params_final, input_dfs_list, bodypart_list)
    """
    input_dfs_list, _ = format_data(input_source)
    logger.info(f"input data loaded for keypoints: {BODYPART_LIST}")
    marker_array = input_dfs_to_markerArray([input_dfs_list], BODYPART_LIST, [""])

    df_smoothed, smooth_params_final = ensemble_kalman_smoother_ibl_pupil(
        marker_array=marker_array,
        keypoint_names=BODYPART_LIST,
        smooth_params=smooth_params,
        s_frames=s_frames,
        avg_mode=avg_mode,
        var_mode=var_mode,
        devices=devices,
        partition=partition,
        device=device,
    )

    save_dir = os.path.dirname(save_file)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    save_dlc_csv(df_smoothed, save_file)
    logger.info("results packaged into output CSV frames")
    return df_smoothed, smooth_params_final, input_dfs_list, BODYPART_LIST


@tracing.entry_point
def ensemble_kalman_smoother_ibl_pupil(
    marker_array: MarkerArray,
    keypoint_names: list,
    smooth_params: list | None = None,
    s_frames: list | None = None,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    lr: float = 5e-3,
    tol: float = 1e-6,
    safety_cap: int = 5000,
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> tuple:
    """Array-level pupil smoother; returns (markers_df, [s_diam, s_com]).

    With ``timings`` (a dict) the device is synchronized between the stages
    and their seconds are recorded ("prep", "optimizer", "final_pass",
    "package"), with the optimizer's Adam iteration count, the spans of the
    stages, of the Adam iterations and of the pandas table ("table") and
    this call's kernel launches (``eks_tpu_torch.tracing``)."""
    resolve_device(device)
    span = tracing.begin(timings, "prep")
    prep = _pupil_prep(marker_array, keypoint_names, avg_mode, var_mode)
    (ensemble_preds, ensemble_vars, ensemble_likes, y_obs, m0, S0,
     mean_x_obs, mean_y_obs, diameters_var, x_var, y_var) = prep
    tracing.end(timings, span, stage=True)

    s_finals, ms, Vs = run_pupil_kalman_smoother(
        ys=y_obs,
        m0=m0,
        S0=S0,
        C=PUPIL_C,
        ensemble_vars=ensemble_vars,
        diameters_var=diameters_var,
        x_var=x_var,
        y_var=y_var,
        s_frames=s_frames,
        smooth_params=smooth_params,
        lr=lr,
        tol=tol,
        safety_cap=safety_cap,
        devices=devices,
        device=device,
        timings=timings,
    )
    logger.debug(f"tuned pupil params: diameter_s={s_finals[0]}, com_s={s_finals[1]}")

    span = tracing.begin(timings, "package")
    block = _pupil_block(
        keypoint_names, ms, Vs, ensemble_preds, ensemble_vars, ensemble_likes,
        mean_x_obs, mean_y_obs,
    )
    tracing.end(timings, span, stage=True)
    span = tracing.begin(timings, "table")
    markers_df = _pupil_table(keypoint_names, block)
    tracing.end(timings, span)
    return markers_df, s_finals


def _pupil_prep(
    marker_array: MarkerArray,
    keypoint_names: list,
    avg_mode: str,
    var_mode: str,
) -> tuple:
    """Host-side prep shared by the single-session and sessions-batched
    paths: ensemble stats, diameter/COM estimators, KF init, COM-centered
    observations. Returns (ensemble_preds, ensemble_vars, ensemble_likes,
    y_obs, m0, S0, mean_x_obs, mean_y_obs, diameters_var, x_var, y_var)."""
    _, _, n_frames, _, _ = marker_array.shape
    keys = [f"{kp}_{coord}" for kp in keypoint_names for coord in ["x", "y"]]

    emA = ensemble(marker_array, avg_mode=avg_mode, var_mode=var_mode)
    ensemble_preds = emA.slice_fields("x", "y").array[0, 0].reshape(n_frames, -1)
    ensemble_vars = emA.slice_fields("var_x", "var_y").array[0, 0].reshape(n_frames, -1)
    ensemble_likes = emA.slice_fields("likelihood").array[0, 0, :, :, 0]  # (T, K)

    named = {key: ensemble_preds[:, i] for i, key in enumerate(keys)}
    pupil_diameters = get_pupil_diameter(named)
    pupil_locations = get_pupil_location(named)
    mean_x_obs = float(np.mean(pupil_locations[:, 0]))
    mean_y_obs = float(np.mean(pupil_locations[:, 1]))
    x_t_obs = pupil_locations[:, 0] - mean_x_obs
    y_t_obs = pupil_locations[:, 1] - mean_y_obs

    m0 = np.asarray([np.mean(pupil_diameters), 0.0, 0.0])
    S0 = np.diag(
        [np.nanvar(pupil_diameters), np.nanvar(x_t_obs), np.nanvar(y_t_obs)]
    )

    # center observations by the COM means (x columns even, y columns odd)
    y_obs = ensemble_preds.copy()
    y_obs[:, 0::2] -= mean_x_obs
    y_obs[:, 1::2] -= mean_y_obs

    return (
        ensemble_preds, ensemble_vars, ensemble_likes, y_obs, m0, S0,
        mean_x_obs, mean_y_obs,
        float(np.var(pupil_diameters)), float(np.var(x_t_obs)),
        float(np.var(y_t_obs)),
    )


_PUPIL_LABELS = [
    "x",
    "y",
    "likelihood",
    "x_ens_median",
    "y_ens_median",
    "x_ens_var",
    "y_ens_var",
    "x_posterior_var",
    "y_posterior_var",
]


def _pupil_package(
    keypoint_names: list,
    ms: np.ndarray,
    Vs: np.ndarray,
    ensemble_preds: np.ndarray,
    ensemble_vars: np.ndarray,
    ensemble_likes: np.ndarray,
    mean_x_obs: float,
    mean_y_obs: float,
) -> pd.DataFrame:
    """Host-side output packaging (all reference quirks preserved: see the
    module docstring): the table of :func:`_pupil_block`."""
    return _pupil_table(keypoint_names, _pupil_block(
        keypoint_names, ms, Vs, ensemble_preds, ensemble_vars, ensemble_likes, mean_x_obs, mean_y_obs))


def _pupil_table(keypoint_names: list, block: np.ndarray) -> pd.DataFrame:
    return dlc_frame(block, keypoint_names, _PUPIL_LABELS)


def _pupil_block(
    keypoint_names: list,
    ms: np.ndarray,
    Vs: np.ndarray,
    ensemble_preds: np.ndarray,
    ensemble_vars: np.ndarray,
    ensemble_likes: np.ndarray,
    mean_x_obs: float,
    mean_y_obs: float,
) -> np.ndarray:
    """The (T, 9 * 4) columns of the output table, in its order."""
    keys = [f"{kp}_{coord}" for kp in keypoint_names for coord in ["x", "y"]]
    y_m_smooth = ms @ PUPIL_C.T  # (T, 8)
    y_v_smooth = np.einsum("ij,tjl,ml->tim", PUPIL_C, Vs, PUPIL_C)  # (T, 8, 8)

    processed = add_mean_to_array(y_m_smooth, keys, mean_x_obs, mean_y_obs)
    key_pair_list = [
        ["pupil_top_r_x", "pupil_top_r_y"],
        ["pupil_right_r_x", "pupil_right_r_y"],
        ["pupil_bottom_r_x", "pupil_bottom_r_y"],
        ["pupil_left_r_x", "pupil_left_r_y"],
    ]
    ensemble_indices = [(0, 1), (4, 5), (2, 3), (6, 7)]

    data_arr = []
    for i, key_pair in enumerate(key_pair_list):
        data_arr.extend(
            [
                processed[key_pair[0]],
                processed[key_pair[1]],
                ensemble_likes[:, i],
                ensemble_preds[:, ensemble_indices[i][0]],
                ensemble_preds[:, ensemble_indices[i][1]],
                ensemble_vars[:, ensemble_indices[i][0]],
                ensemble_vars[:, ensemble_indices[i][1]],
                y_v_smooth[:, i, i],
                y_v_smooth[:, i + 1, i + 1],
            ]
        )

    return np.asarray(data_arr).T


# --------------------------------------------------------------------------- #
# optimizer + smoother
# --------------------------------------------------------------------------- #
def _pupil_model(s_d, s_c, diameters_var, x_var, y_var):
    """(A, Q), each (L, 3, 3), of L lanes from their (L,) parameters and
    variance scales."""
    A = torch.diag_embed(torch.stack([s_d, s_c, s_c], dim=-1))
    Q = torch.diag_embed(torch.stack([
        diameters_var * (1.0 - s_d**2),
        x_var * (1.0 - s_c**2),
        y_var * (1.0 - s_c**2),
    ], dim=-1))
    return A, Q


def _to_s(u: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(u) * (1.0 - 2 * _S_EPS) + _S_EPS


def _fixed_params(smooth_params) -> np.ndarray:
    """A caller's fixed [s_diam, s_com], clipped into the model's range."""
    return np.clip(np.asarray(smooth_params, dtype=np.float32), _S_EPS, 1 - _S_EPS)


def _tensors(dev, *arrays):
    return tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev) for a in arrays)


def _crop(x: np.ndarray, s_frames) -> np.ndarray:
    return crop_frames(torch.as_tensor(x), s_frames).numpy()


def _pupil_lanes(y_loss, r_loss, m0, S0, C, diameters_var, x_var, y_var):
    """The fused NLL's operands for N sessions, two kernel lanes each: lanes
    2i and 2i+1 carry session i's data and parameters with the unit tangents
    d/du_0 and d/du_1. Returns (yr (2N, 16, T), the y-then-r planes;
    ``tables``, mapping (2N, 2) sigmoid-space parameters to the (2N, n_scal)
    time-varying-R tables; tangents (2N, 2))."""
    N = y_loss.shape[0]
    yr2 = _rep2(torch.cat([y_loss.transpose(1, 2), r_loss.transpose(1, 2)], dim=1)).contiguous()
    m02, S02 = _rep2(m0), _rep2(S0)
    C2 = C.expand(2 * N, *C.shape)
    dv2, xv2, yv2 = _rep2(diameters_var), _rep2(x_var), _rep2(y_var)
    prior2 = _prior_information(m02, S02)  # does not depend on the parameters

    def tables(U):
        s2 = _to_s(U)
        A2, Q2 = _pupil_model(s2[:, 0], s2[:, 1], dv2, xv2, yv2)
        return _pack_scalars_tv(m02, S02, A2, Q2, C2, prior=prior2)

    return yr2, tables, torch.eye(2, dtype=m0.dtype, device=m0.device).repeat(N, 1)


def _rep2(a: torch.Tensor) -> torch.Tensor:
    """(N, ...) -> (2N, ...), each row twice in a row."""
    return a.repeat_interleave(2, dim=0)


def _pupil_optimize(y_loss, r_loss, m0, S0, C, u0, diameters_var, x_var, y_var,
                    lr: float, tol: float, safety_cap: int, timings: dict | None = None,
                    time_mesh: tuple | None = None):
    """Joint Adam loop over N sessions' 2-parameter pupil optimizers.

    Every tensor carries a leading session axis (y/r: (N, T, 8); m0: (N, 3);
    S0: (N, 3, 3); u0: (N, 2); the variance scales: (N,)); ``C`` is the
    shared 8x3 geometry. One paired launch of the fused time-varying-R NLL
    over the 2N lanes of ``_pupil_lanes`` gives every session's loss and
    gradient (forward mode; nothing is differentiated through the kernel).
    A non-finite NLL counts as 1e12 with a zero gradient. A session whose
    stop rule fires freezes while the others continue. With ``time_mesh``
    the loss is the staged time-varying-R NLL with the frame axis split over
    its devices. Returns (s (N, 2), last_loss (N,), iters (N,))."""
    N = y_loss.shape[0]
    yr2, tables, tangents = _pupil_lanes(y_loss, r_loss, m0, S0, C, diameters_var, x_var, y_var)
    time_shards = None if time_mesh is None else shards.TimeShards(time_mesh, yr2.shape[-1])

    def loss_and_grad(u):  # (N, 2) -> losses (N,), grads (N, 2)
        table, dtable = jvp(tables, (_rep2(u),), (tangents,))
        if time_shards is None:
            lls, dlls = fused_nll_tv_paired(table.contiguous(), dtable.contiguous(), yr2)
        else:
            lls, dlls = table_nll_tv_paired_sharded(table, dtable, yr2, time_shards)
        finite = torch.isfinite(lls)
        losses = torch.where(finite, -lls, torch.full_like(lls, 1e12))
        dirs = torch.where(finite, -dlls, torch.zeros_like(dlls))
        return losses[0::2], dirs.reshape(N, 2)

    u_f, last_loss, iters = _joint_masked_adam(
        loss_and_grad, u0, lr, tol, safety_cap, timings, scale_gradient=False
    )
    return _to_s(u_f), last_loss, iters


def _initial_u(n_sessions: int, dev) -> torch.Tensor:
    """The optimizer's start, [0.99, 0.98] in sigmoid space, per session:
    the logit is taken in float64 on the host and rounded to float32."""
    s0 = np.array([0.99, 0.98], dtype=np.float64)
    return _tensors(dev, np.tile(np.log(s0 / (1.0 - s0)), (n_sessions, 1)))[0]


def pupil_optimize_smooth(
    ys: np.ndarray,  # (T, 8) centered observations
    m0: np.ndarray,
    S0: np.ndarray,
    C: np.ndarray,
    ensemble_vars: np.ndarray,  # (T, 8)
    diameters_var: float,
    x_var: float,
    y_var: float,
    s_frames: list | None = None,
    smooth_params: list | None = None,
    lr: float = 5e-3,
    tol: float = 1e-6,
    safety_cap: int = 5000,
    devices: int | None = None,
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> tuple[float, float]:
    """Tune ``[s_diam, s_com]`` by filter NLL on (optionally cropped) frames,
    in sigmoid-unconstrained space starting from [0.99, 0.98]. Fixed
    ``smooth_params`` are returned clipped to [1e-3, 1 - 1e-3]. ``devices``
    > 1 shards the loss's frame axis over that many devices."""
    if smooth_params is not None and all(v is not None for v in smooth_params):
        s = _fixed_params(smooth_params)
        return float(s[0]), float(s[1])

    dev = resolve_device(device)
    ys_np = np.asarray(ys)
    vars_np = np.clip(np.asarray(ensemble_vars), 1e-12, None)
    if s_frames and len(s_frames) > 0:
        y_loss, r_loss = _crop(ys_np, s_frames), _crop(vars_np, s_frames)
    else:
        y_loss, r_loss = ys_np, vars_np

    y_t, r_t, m0_t, S0_t, dv, xv, yv = _tensors(
        dev, y_loss[None], r_loss[None], np.asarray(m0)[None], np.asarray(S0)[None],
        [diameters_var], [x_var], [y_var],
    )
    s_opt, last_loss, iters = _pupil_optimize(
        y_t, r_t, m0_t, S0_t, _tensors(dev, C)[0], _initial_u(1, dev), dv, xv, yv,
        lr=float(lr), tol=float(tol), safety_cap=int(safety_cap), timings=timings,
        time_mesh=_time_mesh(devices, dev),
    )
    s_opt = s_opt[0].cpu().numpy()
    logger.debug(
        f"[pupil] iters={int(iters[0])}  s_diam={float(s_opt[0]):.6f}  "
        f"s_com={float(s_opt[1]):.6f}  NLL={float(last_loss[0]):.6f}"
    )
    return float(s_opt[0]), float(s_opt[1])


def _time_mesh(devices: int | None, dev: torch.device) -> tuple | None:
    """The mesh that shards the frame axis for ``devices`` > 1, else None."""
    if devices is None or devices <= 1:
        return None
    logger.info(f"pupil: frame axis sharded over {devices} devices")
    return shards.make_mesh(devices, dev)


def _pupil_smooth(ys, m0, S0, C, r, s_d, s_c, diameters_var, x_var, y_var,
                  sequential: bool = False, time_mesh: tuple | None = None):
    """Final smoothing of N sessions at their tuned parameters: smoothed
    means (N, T, 3) and covariances (N, T, 3, 3). Every tensor carries the
    leading session axis but the shared (8, 3) ``C``. With ``time_mesh``
    the frame axis is split over its devices (the sequential oracle runs
    unsharded)."""
    A, Q = _pupil_model(s_d, s_c, diameters_var, x_var, y_var)
    Cs = C.expand(ys.shape[0], *C.shape)
    if sequential:
        res = kalman_smoother(ys, m0, S0, A, Q, Cs, r)
    else:
        time_shards = None if time_mesh is None else shards.TimeShards(time_mesh, ys.shape[1])
        res = kalman_smoother_parallel(ys, m0, S0, A, Q, Cs, r, time_shards)
    return res.smoothed_means, res.smoothed_covs


def run_pupil_kalman_smoother(
    ys: np.ndarray,  # (T, 8)
    m0: np.ndarray,
    S0: np.ndarray,
    C: np.ndarray,
    ensemble_vars: np.ndarray,
    diameters_var: float,
    x_var: float,
    y_var: float,
    s_frames: list | None = None,
    smooth_params: list | None = None,
    lr: float = 5e-3,
    tol: float = 1e-6,
    safety_cap: int = 5000,
    sequential: bool = False,
    devices: int | None = None,
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> tuple[list[float], np.ndarray, np.ndarray]:
    """Optimize [s_diam, s_com], then smooth the full sequence with
    time-varying R. Returns ([s_diam, s_com], ms (T,3), Vs (T,3,3)), the
    moments as host arrays. ``sequential`` runs the final pass through the
    sequential filter and smoother instead of the parallel ones. ``devices``
    > 1 shards the frame axis of both stages over that many devices."""
    dev = resolve_device(device)
    span = tracing.begin(timings, "optimizer")
    s_d, s_c = pupil_optimize_smooth(
        ys=ys, m0=m0, S0=S0, C=C, ensemble_vars=ensemble_vars,
        diameters_var=diameters_var, x_var=x_var, y_var=y_var,
        s_frames=s_frames, smooth_params=smooth_params,
        lr=lr, tol=tol, safety_cap=safety_cap, devices=devices, device=dev,
        timings=timings,
    )
    tracing.end(timings, span, dev, stage=True)

    span = tracing.begin(timings, "final_pass")
    r_np = np.clip(np.asarray(ensemble_vars), 1e-12, None)
    ms, Vs = _pupil_smooth(
        *_tensors(dev, np.asarray(ys)[None], np.asarray(m0)[None], np.asarray(S0)[None], C,
                  r_np[None], [s_d], [s_c], [diameters_var], [x_var], [y_var]),
        sequential=sequential, time_mesh=_time_mesh(devices, dev),
    )
    ms, Vs = pull_outputs(ms[0], Vs[0])
    tracing.end(timings, span, stage=True)
    return [float(s_d), float(s_c)], ms, Vs


# --------------------------------------------------------------------------- #
# multi-session batching: N sessions as lanes of one device program
# --------------------------------------------------------------------------- #
@tracing.entry_point
def ensemble_kalman_smoother_ibl_pupil_sessions(
    marker_arrays: list,
    keypoint_names: list | None = None,
    smooth_params: list | None = None,
    s_frames: list | None = None,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    lr: float = 5e-3,
    tol: float = 1e-6,
    safety_cap: int = 5000,
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> list[tuple]:
    """Smooth N pupil sessions in one batched run.

    The pupil model is a single 3-state lane per session, so one session
    leaves a card almost idle and the optimizer's thousands of Adam
    iterations are bound by dispatch latency; stacking sessions as lanes
    shares the whole loop between them. Host prep and output packaging stay
    per session and identical to :func:`ensemble_kalman_smoother_ibl_pupil`;
    sessions with unequal frame counts, a single session, and a mix of fixed
    and tuned sessions fall back to one run per session.

    Args:
        marker_arrays: one (M, 1, T, 4, 3) MarkerArray per session.
        smooth_params: None (tune every session), a single [s_diam, s_com]
            applied to all sessions, or a per-session list of such pairs.
        timings: if a dict, stage seconds of the batched run ("prep",
            "optimizer", "final_pass", "package") and its Adam iterations,
            with the spans and launch counts of
            :func:`ensemble_kalman_smoother_ibl_pupil`.

    Returns:
        list of (markers_df, [s_diam, s_com]) per session.
    """
    if not marker_arrays:
        return []  # nothing to smooth
    dev = resolve_device(device)
    n_sessions = len(marker_arrays)
    names = keypoint_names if keypoint_names is not None else BODYPART_LIST

    per_session_params = (
        isinstance(smooth_params, (list, tuple))
        and len(smooth_params) > 0
        and isinstance(smooth_params[0], (list, tuple))
    )
    if per_session_params and len(smooth_params) != n_sessions:
        raise ValueError("per-session smooth_params list must match the session count")

    t_counts = {ma.shape[2] for ma in marker_arrays}
    fixed_flags = (
        [all(v is not None for v in p) for p in smooth_params]
        if per_session_params
        else None
    )
    mixed = fixed_flags is not None and len(set(fixed_flags)) > 1
    if len(t_counts) > 1 or n_sessions == 1 or mixed:
        if len(t_counts) > 1:
            logger.info(
                "pupil sessions differ in frame count; falling back to "
                "sequential per-session smoothing"
            )
        return [
            ensemble_kalman_smoother_ibl_pupil(
                marker_array=ma,
                keypoint_names=names,
                smooth_params=(
                    list(smooth_params[i]) if per_session_params
                    else smooth_params
                ),
                s_frames=s_frames,
                avg_mode=avg_mode,
                var_mode=var_mode,
                lr=lr,
                tol=tol,
                safety_cap=safety_cap,
                device=dev,
            )
            for i, ma in enumerate(marker_arrays)
        ]

    span = tracing.begin(timings, "prep")
    preps = [_pupil_prep(ma, names, avg_mode, var_mode) for ma in marker_arrays]
    (preds_l, vars_l, likes_l, yobs_l, m0_l, S0_l, mx_l, my_l,
     dv_l, xv_l, yv_l) = map(list, zip(*preps))
    ys_np = np.stack(yobs_l)  # (N, T, 8)
    r_np = np.clip(np.stack(vars_l), 1e-12, None)
    m0_t, S0_t, C_t, dv, xv, yv = _tensors(
        dev, np.stack(m0_l), np.stack(S0_l), PUPIL_C, dv_l, xv_l, yv_l
    )
    tracing.end(timings, span, stage=True)

    span = tracing.begin(timings, "optimizer")
    all_fixed = (
        fixed_flags is not None and all(fixed_flags)
    ) or (
        not per_session_params
        and smooth_params is not None
        and all(v is not None for v in smooth_params)
    )
    if all_fixed:
        if per_session_params:
            s_pairs = [_fixed_params(p) for p in smooth_params]
        else:
            s_pairs = [_fixed_params(smooth_params)] * n_sessions
        s_opt = np.stack(s_pairs)
    else:
        # joint optimization across sessions (loss frames optionally cropped)
        if s_frames and len(s_frames) > 0:
            y_loss = np.stack([_crop(y, s_frames) for y in ys_np])
            r_loss = np.stack([_crop(r, s_frames) for r in r_np])
        else:
            y_loss, r_loss = ys_np, r_np
        s_opt, last_loss, iters = _pupil_optimize(
            *_tensors(dev, y_loss, r_loss), m0_t, S0_t, C_t, _initial_u(n_sessions, dev),
            dv, xv, yv, lr=float(lr), tol=float(tol), safety_cap=int(safety_cap),
            timings=timings,
        )
        s_opt = s_opt.cpu().numpy()
        logger.debug(
            f"[pupil sessions] joint iters={int(iters.max())} "
            f"s_diam={s_opt[:, 0]} s_com={s_opt[:, 1]}"
        )
    tracing.end(timings, span, dev, stage=True)

    span = tracing.begin(timings, "final_pass")
    ms, Vs = _pupil_smooth(
        *_tensors(dev, ys_np), m0_t, S0_t, C_t,
        *_tensors(dev, r_np, s_opt[:, 0], s_opt[:, 1]), dv, xv, yv,
    )
    ms, Vs = pull_outputs(ms, Vs)  # one copy for every session
    tracing.end(timings, span, stage=True)

    span = tracing.begin(timings, "package")
    blocks = [
        _pupil_block(names, ms[i], Vs[i], preds_l[i], vars_l[i], likes_l[i], mx_l[i], my_l[i])
        for i in range(n_sessions)
    ]
    tracing.end(timings, span, stage=True)
    span = tracing.begin(timings, "table")
    results = [(_pupil_table(names, blocks[i]), [float(s_opt[i, 0]), float(s_opt[i, 1])])
               for i in range(n_sessions)]
    tracing.end(timings, span)
    return results


@tracing.entry_point
def fit_eks_pupil_sessions(
    input_sources: list,
    save_files: list,
    smooth_params: list | None = None,
    s_frames: list | None = None,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    device: str | torch.device = "cuda",
) -> list[tuple]:
    """File-level wrapper over
    :func:`ensemble_kalman_smoother_ibl_pupil_sessions`: one input source
    and one output CSV per session, all sessions smoothed in one batched
    run.

    Returns:
        list of (df_smoothed, [s_diam, s_com], input_dfs_list,
        bodypart_list) per session.
    """
    if len(save_files) != len(input_sources):
        raise ValueError("one save_file per session")
    resolve_device(device)

    marker_arrays, dfs_per_session = [], []
    for src in input_sources:
        input_dfs_list, _ = format_data(src)
        marker_arrays.append(
            input_dfs_to_markerArray([input_dfs_list], BODYPART_LIST, [""])
        )
        dfs_per_session.append(input_dfs_list)

    results = ensemble_kalman_smoother_ibl_pupil_sessions(
        marker_arrays=marker_arrays,
        smooth_params=smooth_params,
        s_frames=s_frames,
        avg_mode=avg_mode,
        var_mode=var_mode,
        device=device,
    )

    out = []
    for (df_smoothed, s_final), save_file, dfs in zip(
        results, save_files, dfs_per_session
    ):
        save_dir = os.path.dirname(save_file)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        save_dlc_csv(df_smoothed, save_file)
        out.append((df_smoothed, s_final, dfs, BODYPART_LIST))
    return out
