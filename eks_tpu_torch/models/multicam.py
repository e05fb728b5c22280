"""Multi-camera EKS: PCA-latent (linear) and calibrated-projection
(nonlinear) observation models.

Counterpart of ``eks_tpu/models/multicam.py``. Two observation models,
selected by the presence of a calibration:

  * linear: per keypoint, a PCA of the centered (T, 2C) multi-view stack
    builds the emission matrix ``C = components.T``; the latent is a random
    walk with Q from the normalized covariance of PC lag-1 diffs;
  * calibrated: each model's 2-D predictions are triangulated to 3-D
    (undistortion and a batched DLT), averaged over models, and a 3-D
    random-walk latent is smoothed with the calibrated multi-view projection
    as the emission: the s-optimizer's loss is the iterated-EKF plane NLL,
    relinearized from the triangulated trajectory, and the final pass the
    iterated parallel EKF smoother.

Two routes for each, as in the JAX package:

  * the fused route (no inflation, no ``s_frames``; for the linear model no
    injected PCA either): the raw (M, C, T, K) prediction planes are uploaded
    once, the prep (ensemble statistics; frame filter, centering, PCA and KF
    init, or undistortion, triangulation and the geometric KF init), the
    s-optimizer, the final smoother and the packaging all run on the device,
    and the output tables come back in one copy;
  * the general route: ensemble, centering, optional Mahalanobis variance
    inflation, the sklearn-exact PCA or the triangulation, and the KF init
    run on the host, the smoother on the device, the packaging on the host
    again.

Variance inflation: per keypoint, a Factor-Analysis/Mahalanobis screen
multiplies ensemble variances by 10 wherever the distance exceeds 5, repeated
to a fixed point.

Output parity quirks preserved deliberately: the linear per-camera outputs
ADD the ensemble variance to the posterior variance, and the calibrated ones
add camera 0's x/y ensemble variance to EVERY camera's projected variance.
"""

from __future__ import annotations

import logging
import os
from typing import Literal, Optional

import numpy as np
import pandas as pd
import torch

from eks_tpu_torch import tracing
from eks_tpu_torch.core import (
    _ensemble_kernel,
    _nanmedian,
    _nanvar,
    ensemble,
    run_kalman_smoother,
)
from eks_tpu_torch.geometry import (
    CameraGroup,
    make_projection_from_camgroup,
    stack_camera_params,
    triangulate_dlt,
    undistort_points,
)
from eks_tpu_torch.geometry.camera import multiview_projection
from eks_tpu_torch.ops.kalman import emission_jacobian
from eks_tpu_torch.marker_array import (
    MarkerArray,
    input_dfs_to_markerArray,
    mA_to_stacked_array,
    stacked_array_to_mA,
)
from eks_tpu_torch.stats import PCA, _svd_flip_rows, compute_mahalanobis, compute_pca
from eks_tpu_torch.utils import (
    center_predictions,
    format_data,
    make_dlc_pandas_index,
    resolve_device,
    save_dlc_csv,
)

logger = logging.getLogger(__name__)

__all__ = [
    "fit_eks_multicam",
    "fit_eks_mirrored_multicam",
    "ensemble_kalman_smoother_multicam",
    "initialize_kalman_filter_pca",
    "initialize_kalman_filter_geometric",
    "inflate_variance",
    "mA_compute_maha",
    "triangulate_3d_models",
    "project_3d_covariance_to_2d",
]

OUTPUT_LABELS = [
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

_LABELS_3D = ["x", "y", "z", "x_posterior_var", "y_posterior_var", "z_posterior_var"]



# --------------------------------------------------------------------------- #
# public fit wrappers
# --------------------------------------------------------------------------- #
@tracing.entry_point
def fit_eks_mirrored_multicam(
    input_source: str | list,
    save_file: str,
    bodypart_list: list | None = None,
    smooth_param: float | list | None = None,
    s_frames: list | None = None,
    camera_names: list = [],
    quantile_keep_pca: float = 50.0,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    inflate_vars: bool = False,
    n_latent: int = 3,
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    device: str | torch.device = "cuda",
) -> tuple:
    """Mirrored multi-camera fit: one CSV per seed holds all views as
    ``{kp}_{camera}`` columns; views are split out, smoothed jointly, and the
    per-camera outputs merged back into a single CSV. ``device`` is where the
    pipeline runs ("cuda" by default); ``devices``/``partition`` shard the
    smoothing step over that many devices along the keypoint or the time
    axis.

    Returns:
        (final_df, s_finals, input_dfs_list, bodypart_list)
    """
    input_dfs_list, keypoint_names = format_data(input_source)
    if bodypart_list is None:
        # deduped prefix before the first underscore
        seen: set = set()
        bodypart_list = []
        for name in keypoint_names:
            base = name.split("_")[0]
            if base not in seen:
                seen.add(base)
                bodypart_list.append(base)

    n_models = len(input_dfs_list)
    n_cameras = len(camera_names)

    camera_model_dfs = [[None] * n_models for _ in range(n_cameras)]
    for m, df in enumerate(input_dfs_list):
        for c, camera in enumerate(camera_names):
            # replace-ALL is deliberate: it is the reference's own column
            # transform, including its behavior on bodyparts whose names
            # contain the camera substring ('nose_top' + camera 'top' ->
            # 'nose'); the goldens pin it
            cols = {
                col: col.replace(f"_{camera}", "")
                for col in df.columns
                if f"_{camera}_" in col
            }
            camera_model_dfs[c][m] = df[list(cols.keys())].rename(columns=cols)

    marker_array = input_dfs_to_markerArray(
        camera_model_dfs, bodypart_list, camera_names
    )
    camera_dfs, s_finals, _df_3d = ensemble_kalman_smoother_multicam(
        marker_array=marker_array,
        keypoint_names=bodypart_list,
        camera_names=camera_names,
        smooth_param=smooth_param,
        quantile_keep_pca=quantile_keep_pca,
        s_frames=s_frames,
        avg_mode=avg_mode,
        var_mode=var_mode,
        inflate_vars=inflate_vars,
        n_latent=n_latent,
        devices=devices,
        partition=partition,
        device=device,
    )

    # merge per-camera frames back into one mirrored CSV
    final_df = None
    for c, camera_df in enumerate(camera_dfs):
        renamed = [
            (scorer, f"{kp}_{camera_names[c]}", attr)
            for scorer, kp, attr in camera_df.columns
        ]
        camera_df.columns = pd.MultiIndex.from_tuples(
            renamed, names=camera_df.columns.names
        )
        final_df = camera_df if final_df is None else pd.concat(
            [final_df, camera_df], axis=1
        )

    assert final_df is not None
    save_dir = os.path.dirname(save_file)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    save_dlc_csv(final_df, save_file)
    return final_df, s_finals, input_dfs_list, bodypart_list


@tracing.entry_point
def fit_eks_multicam(
    input_source: str | list | dict,
    save_dir: str,
    bodypart_list: list | None = None,
    smooth_param: float | list | None = None,
    s_frames: list | None = None,
    camera_names: list | None = None,
    quantile_keep_pca: float = 50.0,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    inflate_vars: bool = False,
    n_latent: int = 3,
    calibration: str | None = None,
    save_3d_outputs: bool = True,
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    device: str | torch.device = "cuda",
) -> tuple:
    """Un-mirrored multi-camera fit: one CSV per (camera, seed), matched to
    cameras by filename. With ``calibration`` (an Anipose TOML) the
    calibrated-projection path runs, the camera names come from the file,
    and with ``save_3d_outputs`` the 3-D latents are saved beside the
    per-camera CSVs. ``device`` is where the pipeline runs ("cuda" by
    default).

    Returns:
        (camera_dfs, s_finals, input_dfs_list, bodypart_list, df_3d)
    """
    camgroup = None
    if calibration is not None:
        camgroup = CameraGroup.load(calibration)
        if camera_names is not None:
            logger.warning(
                "calibration file supplies its own camera names; the camera_names argument is dropped"
            )
        camera_names = [cam.name for cam in camgroup.cameras]
    elif camera_names is None:
        raise ValueError("without a calibration file, pass camera_names explicitly")

    input_dfs_list, keypoint_names = format_data(input_source, camera_names=camera_names)
    if bodypart_list is None:
        bodypart_list = keypoint_names
    marker_array = input_dfs_to_markerArray(input_dfs_list, bodypart_list, camera_names)

    camera_dfs, s_finals, df_3d = ensemble_kalman_smoother_multicam(
        marker_array=marker_array,
        keypoint_names=bodypart_list,
        camera_names=camera_names,
        smooth_param=smooth_param,
        quantile_keep_pca=quantile_keep_pca,
        s_frames=s_frames,
        avg_mode=avg_mode,
        var_mode=var_mode,
        inflate_vars=inflate_vars,
        n_latent=n_latent,
        camgroup=camgroup,
        devices=devices,
        partition=partition,
        device=device,
    )

    os.makedirs(save_dir, exist_ok=True)
    for c, camera in enumerate(camera_names):
        save_dlc_csv(
            camera_dfs[c], os.path.join(save_dir, f"multicam_{camera}_results.csv")
        )
    if save_3d_outputs and calibration is not None:
        save_dlc_csv(df_3d, os.path.join(save_dir, "multicam_3d_results.csv"))
    return camera_dfs, s_finals, input_dfs_list, bodypart_list, df_3d


# --------------------------------------------------------------------------- #
# array-level smoother
# --------------------------------------------------------------------------- #
@tracing.entry_point
def ensemble_kalman_smoother_multicam(
    marker_array: MarkerArray,
    keypoint_names: list,
    camera_names: list,
    smooth_param: float | list | None = None,
    quantile_keep_pca: float = 50.0,
    s_frames: list | None = None,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    inflate_vars: bool = False,
    inflate_vars_kwargs: dict = {},
    pca_object: Optional[PCA] = None,
    n_latent: int = 3,
    camgroup: Optional[CameraGroup] = None,
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> tuple:
    """Multi-view smoother over a (M, C, T, K, 3) MarkerArray.

    Args:
        camgroup: the calibration; with it the calibrated-projection model
            runs (3-D latent, the cameras' projection as the emission) and
            ``n_latent`` and ``pca_object`` are not read.
        device: where the pipeline runs ("cuda" by default).
        timings: if a dict, the device is synchronized between stages and
            their seconds are recorded ("prep", "optimizer", "final_pass",
            "package"), with the optimizer's Adam iteration count, the
            spans of the stages, of the Adam iterations and of the pandas
            tables ("table") and this call's kernel launches
            (``eks_tpu_torch.tracing``).

    Returns:
        (camera_dfs, s_finals, df_3d)
    """
    if camera_names is None or len(camera_names) == 0:
        raise ValueError("camera_names must be provided")
    dev = resolve_device(device)

    # without inflation and loss-frame cropping (and, for the linear model,
    # an injected PCA) prep, smoothing and packaging run on the device with
    # one upload (raw predictions) and one download (the packaged tables)
    if not inflate_vars and not s_frames:
        if camgroup is not None:
            return _smoother_multicam_nonlinear_fused(
                marker_array, keypoint_names, camgroup, smooth_param=smooth_param,
                avg_mode=avg_mode, var_mode=var_mode, dev=dev,
                devices=devices, partition=partition, timings=timings,
            )
        if pca_object is None:
            return _smoother_multicam_linear_fused(
                marker_array, keypoint_names, smooth_param=smooth_param,
                quantile_keep_pca=quantile_keep_pca, avg_mode=avg_mode,
                var_mode=var_mode, n_latent=n_latent, dev=dev,
                devices=devices, partition=partition, timings=timings,
            )

    M, V, T, K, _ = marker_array.shape

    # ensemble + centering, on the host: the general path consumes their
    # outputs host-side (centering, inflation, PCA)
    span = tracing.begin(timings, "prep")
    emA = ensemble(marker_array, avg_mode=avg_mode, var_mode=var_mode)
    emA_unsm = emA.slice_fields("x", "y")
    emA_vars = emA.slice_fields("var_x", "var_y")
    emA_likes = emA.slice_fields("likelihood")
    valid_mask, emA_centered, emA_good_centered, emA_means = center_predictions(
        emA, quantile_keep_pca
    )

    # optional Mahalanobis variance inflation
    if inflate_vars:
        # never mutate the caller's kwargs dict (a reused dict would find
        # its fitted 'mean' silently zeroed on the next call)
        inflate_vars_kwargs = dict(inflate_vars_kwargs)
        if inflate_vars_kwargs.get("mean", None) is not None:
            # centered predictions are passed in, so the latent mean is zero
            inflate_vars_kwargs["mean"] = np.zeros_like(inflate_vars_kwargs["mean"])
        emA_inflated_vars = mA_compute_maha(
            emA_centered, emA_vars, emA_likes, n_latent,
            inflate_vars_kwargs=inflate_vars_kwargs,
        )
    else:
        emA_inflated_vars = emA_vars

    def upload(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=dev)

    if camgroup is not None:
        # triangulated 3-D trajectories: the KF init and the optimizer's
        # linearization trajectory; raw (uncentered) 2-D observations
        ys_3d = triangulate_3d_models(marker_array, camgroup, device=dev).mean(axis=0)  # (K, T, 3)
        m0s, S0s, As, Qs, Cs = initialize_kalman_filter_geometric(ys_3d, device=dev)
        h_fn, _ = make_projection_from_camgroup(camgroup, device=dev)
        x_init = upload(ys_3d)
        obs = emA_unsm.array[0]  # (C, T, K, 2)
    else:
        ensemble_pca, good_pcs_list = compute_pca(
            valid_mask, emA_centered, emA_good_centered,
            n_components=n_latent, pca_object=pca_object,
        )
        m0s, S0s, As, Qs, Cs = initialize_kalman_filter_pca(
            good_pcs_list=good_pcs_list, ensemble_pca=ensemble_pca, n_latent=n_latent,
            device=dev,
        )
        h_fn = x_init = None
        obs = emA_centered.array[0]  # (C, T, K, 2)

    infl = emA_inflated_vars.array[0]
    ys = np.moveaxis(obs, 2, 0).transpose(0, 2, 1, 3).reshape(K, T, 2 * V)
    ensemble_vars = np.moveaxis(infl, 2, 0).transpose(0, 2, 1, 3).reshape(K, T, 2 * V)
    tracing.end(timings, span, stage=True)

    s_finals, ms, Vs = run_kalman_smoother(
        ys=upload(ys),
        m0s=m0s, S0s=S0s, As=As, Qs=Qs, Cs=Cs,
        ensemble_vars=upload(np.swapaxes(ensemble_vars, 0, 1)),  # (T, K, 2C)
        s_frames=s_frames,
        smooth_param=smooth_param,
        h_fn=h_fn,
        x_init=x_init,
        devices=devices,
        partition=partition,
        timings=timings,
    )
    # one batched pull of the device-resident results
    span = tracing.begin(timings, "package")
    ms_dev, Vs_dev = ms, Vs
    ms, Vs = ms.cpu().numpy(), Vs.cpu().numpy()

    # reprojection + packaging
    likes = emA_likes.array[0, :, :, :, 0]  # (C, T, K)
    unsm = emA_unsm.array[0]  # (C, T, K, 2)
    if camgroup is not None:
        # every camera's projection of the smoothed latents and its projected
        # covariance, on the device; the variance columns are the uninflated
        # ones
        var_cols = emA_vars.array[0]
        sm4 = _package_multicam_nonlinear(
            ms_dev, Vs_dev, upload(ensemble_vars), *(upload(a) for a in stack_camera_params(camgroup)),
        ).cpu().numpy()  # (C, T, K, 4)
        xy_cols, post_cols = sm4[..., :2], sm4[..., 2:]
    else:
        var_cols = infl
        means = emA_means.array[0, :, 0, :, :]  # (C, K, 2)
        Cs_np = Cs.cpu().numpy()  # (K, 2C, L)
        y_m = np.einsum("koj,ktj->kto", Cs_np, ms)  # (K, T, 2C)
        y_v_diag = np.einsum("koj,ktjl,kol->kto", Cs_np, Vs, Cs_np)  # (K, T, 2C)
        # posterior var + ensemble var (deliberate quirk)
        post = y_v_diag + ensemble_vars
        xy_cols = [(y_m[..., 2 * c:2 * c + 2] + means[c][:, None]).transpose(1, 0, 2) for c in range(V)]
        post_cols = [post[..., 2 * c:2 * c + 2].transpose(1, 0, 2) for c in range(V)]

    blocks = [
        np.concatenate([xy_cols[c], likes[c][..., None], unsm[c], var_cols[c], post_cols[c]], axis=-1)
        for c in range(V)
    ]  # (T, K, 9) each

    # the 3-D latents' columns
    arr_3d = np.concatenate(
        [
            np.concatenate(
                [ms[k], np.stack([Vs[k, :, i, i] for i in range(3)], axis=-1)],
                axis=-1,
            )
            for k in range(K)
        ],
        axis=-1,
    ) if ms.shape[-1] == 3 else np.zeros((T, K * 6))
    tracing.end(timings, span, stage=True)
    camera_dfs, df_3d = _tables(blocks, arr_3d, keypoint_names, timings)
    return camera_dfs, s_finals, df_3d


# --------------------------------------------------------------------------- #
# Kalman initialisation
# --------------------------------------------------------------------------- #
def initialize_kalman_filter_pca(
    good_pcs_list: list[np.ndarray],
    ensemble_pca: list,
    n_latent: int,
    device: str | torch.device = "cuda",
) -> tuple:
    """PCA-latent init: C = componentsᵀ, Q = normalized covariance of PC
    lag-1 diffs, S0 = diag(var of good PCs). Computed on the host in numpy
    (float64 where numpy promotes) and handed over as float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    K = len(good_pcs_list)
    m0s = np.zeros((K, n_latent))
    # per-column np.var calls, not an axis-reduction: the reference computes
    # each diagonal with its own 1-D np.var and the f32 summation order
    # differs enough to show up in the parity goldens
    S0s = np.stack(
        [
            np.diag(
                [np.var(good_pcs_list[k][:, i]) for i in range(n_latent)]
            )
            for k in range(K)
        ]
    )
    As = np.tile(np.eye(n_latent), (K, 1, 1))
    Cs = np.stack([pca.components_.T for pca in ensemble_pca])  # (K, 2C, L)

    Qs = []
    for k in range(K):
        d = np.diff(good_pcs_list[k], axis=0)
        cov = np.atleast_2d(np.cov(d.T))  # np.cov of 1-D diffs is a scalar
        peak = np.max(np.abs(cov))
        Qs.append(cov / peak if peak > 0 else cov)
    Qs = np.stack(Qs)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=dev)

    return t(m0s), t(S0s), t(As), t(Qs), t(Cs)


def initialize_kalman_filter_geometric(ys: np.ndarray, device: str | torch.device = "cuda") -> tuple:
    """3-D geometric init from triangulated trajectories (K, T, 3) on the
    host: m0 = mean of the first 10 frames, S0 = diag(nanvar) + 1e-4, Q =
    diag of the squared scaled MAD of lag-1 diffs (floored at 1e-8), A and
    the emission placeholder = I. Handed over as float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    K, T, D = ys.shape
    m0s = ys[:, :10].mean(axis=1)  # (K, 3)
    var = np.nanvar(ys, axis=1) + 1e-4  # (K, 3)
    dx = np.diff(ys, axis=1)  # (K, T-1, 3)
    med = np.median(dx, axis=1, keepdims=True)
    mad = np.median(np.abs(dx - med), axis=1) + 1e-12  # (K, 3)
    qvar = np.maximum((1.4826 * mad) ** 2, 1e-8)
    eye = np.tile(np.eye(D), (K, 1, 1))
    S0s, Qs = np.zeros((K, D, D)), np.zeros((K, D, D))
    for d in range(D):
        S0s[:, d, d] = var[:, d]
        Qs[:, d, d] = qvar[:, d]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=dev)

    return t(m0s), t(S0s), t(eye), t(Qs), t(eye)


# --------------------------------------------------------------------------- #
# fused linear path (device-resident prep + packaging)
# --------------------------------------------------------------------------- #
def _percentile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q, axis=0)`` (linear interpolation) in its own
    float32 formula: position q/100 * (n - 1), weights from its fractional
    part, ``low * (1 - w) + high * w``. Bit-equal to it where the weights are
    0, 1/2 or 1 (the default q = 50 always), within one ulp of its compiled
    evaluation elsewhere. ``torch.quantile`` interpolates with another
    formula (``low + w * (high - low)``), and the frame filter compares
    variances with this threshold."""
    n = x.shape[0]
    pos = np.float32(q) / np.float32(100.0) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    w_high = np.float32(pos - low)
    w_low = np.float32(np.float32(1.0) - w_high)
    lo_i = int(np.clip(low, 0, n - 1))
    hi_i = int(np.clip(high, 0, n - 1))
    srt = torch.sort(x, dim=0).values
    return srt[lo_i] * float(w_low) + srt[hi_i] * float(w_high)


def _prep_multicam_linear(
    data_x, data_y, data_lh, n_models, avg_mode, var_mode, n_latent, quantile
):
    """Device twin of ensemble() + center_predictions + compute_pca +
    initialize_kalman_filter_pca for the linear multicam family, with no
    intermediate host transfer and no host synchronization.

    The variance-quantile frame filter has data-dependent good-frame counts;
    the good-row selection is a {0,1} weight plane and the counts stay device
    scalars. The PCA fit stays exact because rows zeroed AFTER centering
    contribute nothing to XᵀX: the eigenvectors match those of the gathered
    submatrix.

    Inputs (M, C, T, K) prediction planes; returns
    (stats (C,T,K,5), ys (K,T,2C), evars (K,T,2C), m0s, S0s, As, Qs,
    Cs (K,2C,L), means (C,K,2)).
    """
    stats = _ensemble_kernel(
        data_x, data_y, data_lh, n_models, avg_mode, var_mode, 1000.0
    )  # (C, T, K, 5)
    preds = stats[..., :2]
    variances = stats[..., 2:4]
    C, T, K, _ = stats.shape
    dt, dev = preds.dtype, preds.device

    # frame filter: per-keypoint variance-quantile threshold on the max over
    # cameras and x/y
    max_vars = variances.amax(dim=(0, 3))  # (T, K)
    thresholds = _percentile_linear(max_vars, quantile)  # (K,)
    mask = max_vars <= thresholds  # (T, K)
    counts = mask.sum(dim=0)  # (K,)
    n_good = counts.min()
    # every keypoint keeps its FIRST n_good valid frames (min-count
    # truncation quirk); the cumsum rank reproduces the stable-argsort
    # selection
    rank = torch.cumsum(mask, dim=0)
    w = (mask & (rank <= n_good)).to(dt)  # (T, K)
    denom = n_good.to(dt)

    means = torch.einsum("tk,ctko->cko", w, preds) / denom  # (C, K, 2)
    centered = preds - means[:, None]  # (C, T, K, 2)
    X = centered.permute(2, 1, 0, 3).reshape(K, T, 2 * C)  # ys
    evars = variances.permute(2, 1, 0, 3).reshape(K, T, 2 * C)

    # PCA on the truncated good rows (sklearn PCA re-centers internally, so
    # subtract the good-row column mean before masking), by the
    # covariance-eigh route
    wK = w.T[:, :, None]  # (K, T, 1)
    col_mean = (X * wK).sum(dim=1) / denom  # (K, 2C)
    Xg_c = (X - col_mean[:, None, :]) * wK
    cov = torch.einsum("ktf,ktg->kfg", Xg_c, Xg_c)  # (K, 2C, 2C)
    _, V = torch.linalg.eigh(cov)  # ascending eigenvalues
    vt = _svd_flip_rows(V.flip(-1).transpose(-1, -2))  # rows = descending components
    comps = vt[:, :n_latent, :]  # (K, L, 2C)
    pcs_all = torch.einsum("ktf,klf->ktl", X - col_mean[:, None, :], comps)

    # KF init from each keypoint's own UNtruncated valid set
    # (initialize_kalman_filter_pca semantics)
    fmask = mask.T.to(dt)  # (K, T)
    cnt = counts.to(dt)
    mean_pc = torch.einsum("kt,ktl->kl", fmask, pcs_all) / cnt[:, None]
    dev_pc = (pcs_all - mean_pc[:, None, :]) * fmask[:, :, None]
    var_pc = torch.einsum("ktl,ktl->kl", dev_pc, dev_pc) / cnt[:, None]  # ddof=0
    S0s = torch.diag_embed(var_pc)

    # Q: np.cov (ddof=1) of lag-1 diffs over the COMPACTED good sequence; a
    # stable argsort pulls the valid rows to the front in time order
    perm = torch.argsort((~mask.T).to(torch.int8), dim=1, stable=True)  # (K, T)
    ps = torch.take_along_dim(pcs_all, perm[:, :, None], dim=1)
    d = ps[:, 1:] - ps[:, :-1]  # (K, T-1, L)
    n_d = cnt - 1.0
    wd = (torch.arange(T - 1, dtype=dt, device=dev)[None, :] < n_d[:, None]).to(dt)[:, :, None]
    mu = (d * wd).sum(dim=1) / n_d[:, None]
    dc = (d - mu[:, None, :]) * wd
    qcov = dc.transpose(1, 2) @ dc / (n_d - 1.0)[:, None, None]
    peak = qcov.abs().amax(dim=(1, 2))[:, None, None]
    Qs = torch.where(peak > 0, qcov / peak, qcov)

    m0s = torch.zeros((K, n_latent), dtype=dt, device=dev)
    As = torch.eye(n_latent, dtype=dt, device=dev).expand(K, n_latent, n_latent).contiguous()
    Cs = comps.transpose(1, 2).contiguous()  # (K, 2C, L)
    return stats, X.contiguous(), evars.contiguous(), m0s, S0s, As, Qs, Cs, means


def _package_multicam_smoothed(means, Cs, ms, Vs, evars) -> torch.Tensor:
    """Device packaging of the smoother-dependent per-camera block:
    reproject the latent through C, re-add centering means, and apply the
    posterior-var + ensemble-var quirk. Returns (C, T, K, 4) as
    [x, y, x_posterior_var, y_posterior_var]."""
    y_m = torch.einsum("koj,ktj->kto", Cs, ms)  # (K, T, 2C)
    y_v = torch.einsum("koj,ktjl,kol->kto", Cs, Vs, Cs)
    post = y_v + evars  # posterior var + ensemble var (reference quirk)
    K, T, F = y_m.shape
    xy = y_m.reshape(K, T, F // 2, 2).permute(2, 1, 0, 3) + means[:, None]  # (C, T, K, 2)
    pv = post.reshape(K, T, F // 2, 2).permute(2, 1, 0, 3)
    return torch.cat([xy, pv], dim=-1)


def _package_3d(ms, Vs) -> torch.Tensor:
    """(K, T, L) latents + (K, T, L, L) covs -> (T, K*(2L)) layout of the
    3-D output dataframe: per keypoint [x, y, z, *_posterior_var]."""
    diag = torch.diagonal(Vs, dim1=-2, dim2=-1)  # (K, T, L)
    arr = torch.cat([ms, diag], dim=-1)  # (K, T, 2L)
    K, T, F = arr.shape
    return arr.transpose(0, 1).reshape(T, K * F)


def _smoother_multicam_linear_fused(
    marker_array, keypoint_names, smooth_param, quantile_keep_pca,
    avg_mode, var_mode, n_latent, dev,
    devices=None, partition="keypoint", timings=None,
):
    """Linear multicam smoother with prep and packaging on the device.
    Output contract identical to the general path (same columns, quirks)."""
    M, V, T, K, _ = marker_array.shape

    span = tracing.begin(timings, "prep")
    arr = torch.as_tensor(
        np.ascontiguousarray(marker_array.array, dtype=np.float32), device=dev
    )  # (M, C, T, K, 3)
    stats, ys, evars, m0s, S0s, As, Qs, Cs, means = _prep_multicam_linear(
        arr[..., 0], arr[..., 1], arr[..., 2],
        M, avg_mode, var_mode, int(n_latent), float(quantile_keep_pca),
    )
    tracing.end(timings, span, dev, stage=True)

    s_finals, ms, Vs = run_kalman_smoother(
        ys=ys, m0s=m0s, S0s=S0s, As=As, Qs=Qs, Cs=Cs,
        ensemble_vars=evars.transpose(0, 1),  # (T, K, 2C)
        smooth_param=smooth_param,
        devices=devices, partition=partition, timings=timings,
    )

    span = tracing.begin(timings, "package")
    sm4 = _package_multicam_smoothed(means, Cs, ms, Vs, evars)
    if n_latent == 3:
        arr_3d = _package_3d(ms, Vs)
    else:
        arr_3d = torch.zeros((T, K * 6), dtype=sm4.dtype, device=dev)
    sm4_np, stats_np, arr_3d_np = (x.cpu().numpy() for x in (sm4, stats, arr_3d))
    blocks = _camera_blocks(sm4_np, stats_np)
    tracing.end(timings, span, stage=True)
    camera_dfs, df_3d = _tables(blocks, arr_3d_np, keypoint_names, timings)
    return camera_dfs, s_finals, df_3d


# --------------------------------------------------------------------------- #
# fused calibrated path (device-resident prep + packaging)
# --------------------------------------------------------------------------- #
def _median(a: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """``jnp.median``: the midpoint of the two middle values (``torch.median``
    takes the lower one), NaN wherever the axis holds one."""
    med = _nanmedian(a, dim)
    med = torch.where(torch.isnan(a).any(dim=dim), torch.full_like(med, float("nan")), med)
    return med.unsqueeze(dim) if keepdim else med


def _prep_multicam_nonlinear(data_x, data_y, data_lh, n_models, avg_mode, var_mode, Ks, dists, extr):
    """Device twin of ensemble() + triangulate_3d_models +
    initialize_kalman_filter_geometric for the calibrated family, with no
    intermediate host transfer.

    Inputs: (M, C, T, K) prediction planes and the stacked camera parameters
    (Ks (C, 3, 3), dists (C, 14), extr (C, 3, 4)). Returns (stats (C, T, K,
    5), ys (K, T, 2C) raw pixel observations, evars (K, T, 2C), m0s, S0s,
    As, Qs, ys_3d (K, T, 3)); the emission placeholder is As, the identity.
    ``ys_3d``, the triangulated trajectory, is the s-optimizer's EKF
    linearization trajectory."""
    stats = _ensemble_kernel(data_x, data_y, data_lh, n_models, avg_mode, var_mode, 1000.0)
    C, T, K, _ = stats.shape
    M = data_x.shape[0]
    ys = stats[..., :2].permute(2, 1, 0, 3).reshape(K, T, 2 * C)
    evars = stats[..., 2:4].permute(2, 1, 0, 3).reshape(K, T, 2 * C)

    # undistort and triangulate every (model, keypoint, frame) in one batched
    # DLT; the flat point index is (m, k, t), as in triangulate_3d_models
    pts = torch.stack([data_x, data_y], dim=-1).permute(1, 0, 3, 2, 4).reshape(C, M * K * T, 2)
    und = torch.stack([undistort_points(pts[c], Ks[c], dists[c]) for c in range(C)])
    ys_3d = triangulate_dlt(und, extr).reshape(M, K, T, 3).mean(dim=0)  # (K, T, 3)

    # geometric init (initialize_kalman_filter_geometric semantics)
    eye3 = torch.eye(3, dtype=ys.dtype, device=ys.device)
    m0s = ys_3d[:, :10].mean(dim=1)
    S0s = (_nanvar(ys_3d, 1) + 1e-4)[:, :, None] * eye3
    dxs = ys_3d[:, 1:] - ys_3d[:, :-1]
    mad = _median((dxs - _median(dxs, 1, keepdim=True)).abs(), 1) + 1e-12
    Qs = torch.clamp((1.4826 * mad) ** 2, min=1e-8)[:, :, None] * eye3
    As = eye3.expand(K, 3, 3).contiguous()
    return stats, ys.contiguous(), evars.contiguous(), m0s, S0s, As, Qs, ys_3d.contiguous()


def _package_multicam_nonlinear(ms, Vs, evars, Ks, dists, extr) -> torch.Tensor:
    """Device reprojection epilogue of the calibrated family: the smoothed
    3-D latents and their covariances through every camera at once. Returns
    (C, T, K, 4) as [x, y, x_posterior_var, y_posterior_var]; every camera's
    variance gets camera 0's x/y ensemble variance added (the reference's
    quirk: it reads columns 0 and 1 of the full (T, 2C) slab)."""
    K, T, _ = ms.shape
    C = Ks.shape[0]
    views = multiview_projection(extr[:, :, :3], extr[:, :, 3], Ks, dists)
    flat = ms.reshape(-1, 3)  # flat index (k, t)
    proj = views(flat).reshape(-1, C, 2)
    J = emission_jacobian(views, flat).reshape(-1, C, 2, 3)
    pvar = torch.einsum("ncij,njl,ncil->nci", J, Vs.reshape(-1, 3, 3), J)
    post = pvar + evars[..., :2].reshape(-1, 1, 2)
    return torch.cat([proj, post], dim=-1).reshape(K, T, C, 4).permute(2, 1, 0, 3)


def _smoother_multicam_nonlinear_fused(
    marker_array, keypoint_names, camgroup, smooth_param, avg_mode, var_mode, dev,
    devices=None, partition="keypoint", timings=None,
):
    """Calibrated multicam smoother with prep and packaging on the device.
    Output contract identical to the general route (same columns, same
    camera-0 variance quirk)."""
    M = marker_array.shape[0]

    span = tracing.begin(timings, "prep")
    arr = torch.as_tensor(
        np.ascontiguousarray(marker_array.array, dtype=np.float32), device=dev
    )  # (M, C, T, K, 3)
    Ks, dists, extr = (
        torch.as_tensor(a, dtype=torch.float32, device=dev) for a in stack_camera_params(camgroup)
    )
    stats, ys, evars, m0s, S0s, As, Qs, ys_3d = _prep_multicam_nonlinear(
        arr[..., 0], arr[..., 1], arr[..., 2], M, avg_mode, var_mode, Ks, dists, extr,
    )
    h_fn, _ = make_projection_from_camgroup(camgroup, device=dev)
    tracing.end(timings, span, dev, stage=True)

    s_finals, ms, Vs = run_kalman_smoother(
        ys=ys, m0s=m0s, S0s=S0s, As=As, Qs=Qs, Cs=As,
        ensemble_vars=evars.transpose(0, 1),  # (T, K, 2C)
        smooth_param=smooth_param, h_fn=h_fn, x_init=ys_3d,
        devices=devices, partition=partition, timings=timings,
    )

    span = tracing.begin(timings, "package")
    sm4 = _package_multicam_nonlinear(ms, Vs, evars, Ks, dists, extr)
    sm4_np, stats_np, arr_3d_np = (x.cpu().numpy() for x in (sm4, stats, _package_3d(ms, Vs)))
    blocks = _camera_blocks(sm4_np, stats_np)
    tracing.end(timings, span, stage=True)
    camera_dfs, df_3d = _tables(blocks, arr_3d_np, keypoint_names, timings)
    return camera_dfs, s_finals, df_3d


def _camera_blocks(sm4_np, stats_np) -> list:
    """Interleave the smoother-dependent block (C, T, K, 4) with the ensemble
    stats (C, T, K, 5) into one (T, K, 9) block per camera."""
    return [
        np.concatenate(
            [
                sm4_np[c][..., :2],  # x, y
                stats_np[c][..., 4:5],  # likelihood
                stats_np[c][..., 0:2],  # x_ens_median, y_ens_median
                stats_np[c][..., 2:4],  # x_ens_var, y_ens_var
                sm4_np[c][..., 2:4],  # x/y posterior var
            ],
            axis=-1,
        )
        for c in range(sm4_np.shape[0])
    ]


def _tables(blocks, arr_3d, keypoint_names, timings) -> tuple:
    """The pandas tables of the outputs, in the span "table": one
    9-column-per-keypoint DataFrame per camera from its (T, K, 9) block, and
    the 3-D latents' from ``arr_3d`` (T, 6K)."""
    span = tracing.begin(timings, "table")
    cols = make_dlc_pandas_index(keypoint_names, OUTPUT_LABELS)
    camera_dfs = [pd.DataFrame(b.reshape(b.shape[0], -1), columns=cols) for b in blocks]
    df_3d = pd.DataFrame(arr_3d, columns=make_dlc_pandas_index(keypoint_names, _LABELS_3D))
    tracing.end(timings, span)
    return camera_dfs, df_3d


# --------------------------------------------------------------------------- #
# variance inflation
# --------------------------------------------------------------------------- #
def mA_compute_maha(
    centered_emA_preds: MarkerArray,
    emA_vars: MarkerArray,
    emA_likes: MarkerArray,
    n_latent: int,
    inflate_vars_kwargs: dict | None = None,
    threshold: float = 5.0,
    scalar: float = 10.0,
) -> MarkerArray:
    """Fixed-point variance inflation: per keypoint, compute Mahalanobis
    distances and multiply variances by ``scalar`` where the distance exceeds
    ``threshold``; repeat until nothing inflates."""
    _, n_cameras, _, n_keypoints, _ = centered_emA_preds.shape

    # copy so neither a shared default nor the caller's dict is mutated
    inflate_vars_kwargs = dict(inflate_vars_kwargs or {})
    inflate_vars_kwargs.setdefault("likelihood_threshold", 0.9)
    inflate_vars_kwargs.setdefault("v_quantile_threshold", 50.0)

    out_list = []
    for k in range(n_keypoints):
        preds = mA_to_stacked_array(centered_emA_preds, k)
        variances = mA_to_stacked_array(emA_vars, k)
        likes = mA_to_stacked_array(emA_likes, k)

        logger.info(f"variance-inflation pass for keypoint {k}")
        inflated = True
        tmp = variances
        while inflated:
            if inflate_vars_kwargs.get("likelihoods", None) is None:
                maha = compute_mahalanobis(
                    preds, tmp, n_latent=n_latent, **inflate_vars_kwargs
                )
            else:
                maha = compute_mahalanobis(
                    preds, tmp, n_latent=n_latent, likelihoods=likes,
                    **inflate_vars_kwargs,
                )
            tmp, inflated = inflate_variance(
                tmp, maha["mahalanobis"], threshold, scalar
            )

        out_list.append(
            stacked_array_to_mA(tmp, n_cameras, data_fields=["var_x", "var_y"])
        )
    return MarkerArray.stack(out_list, "keypoints")


def inflate_variance(
    v: np.ndarray,
    maha_dict: dict,
    threshold: float = 5.0,
    scalar: float = 10.0,
) -> tuple:
    """Multiply variances by ``scalar`` for (frame, view) cells whose
    Mahalanobis distance exceeds ``threshold``. With exactly 2 views, any
    flagged view inflates the whole row.

    Returns (updated_v, anything_inflated).
    """
    assert len(maha_dict) >= 2, "variance inflation needs at least two camera views"
    updated = v.copy()
    N, _ = v.shape
    C = len(maha_dict)

    mask = np.zeros((N, C), dtype=bool)
    for view, dist in maha_dict.items():
        mask[:, view] = dist[:, 0] > threshold

    full = np.repeat(mask, 2, axis=1)
    if C == 2:
        full |= full.any(axis=1, keepdims=True)

    updated[full] *= scalar
    return updated, bool(full.any())


# --------------------------------------------------------------------------- #
# calibrated-path helpers (the general route)
# --------------------------------------------------------------------------- #
def triangulate_3d_models(marker_array: MarkerArray, camgroup: CameraGroup,
                          device: str | torch.device = "cuda") -> np.ndarray:
    """Triangulate every (model, keypoint, frame) in one batched undistort +
    DLT in float32 on ``device``: (M, C, T, K, >=2) marker array ->
    (M, K, T, 3) host array."""
    M, C, T, K, _ = marker_array.shape
    raw = np.asarray(marker_array.get_array()[..., :2], dtype=np.float64)
    # (C, M*K*T, 2) with flat index (m, k, t)
    pts = raw.transpose(1, 0, 3, 2, 4).reshape(C, M * K * T, 2)
    return camgroup.triangulate(pts, device=resolve_device(device)).reshape(M, K, T, 3)


def project_3d_covariance_to_2d(
    ms: np.ndarray,  # (K, T, 3) or (T, 3)
    Vs: np.ndarray,  # (K, T, 3, 3) or (T, 3, 3)
    h_cam,
    ensemble_vars: np.ndarray,  # (K, T, 2C) or (T, 2C): x/y of camera 0 first
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Project the 3-D posterior covariance to a camera's 2-D pixel
    variances through the projection Jacobian, ``cov2d = J V Jᵀ``, and add
    the first two columns of ``ensemble_vars`` (camera 0's x/y ensemble
    variance, whichever camera ``h_cam`` is: the reference's quirk). The
    Jacobian is taken in float32 on ``device``, where ``h_cam`` holds its
    parameters.

    Returns (var_x, var_y) with the leading shape of ``ms`` minus the state
    axis."""
    squeeze = ms.ndim == 2
    ms_b = ms[None] if squeeze else ms  # (K, T, 3)
    Vs_b = Vs[None] if squeeze else Vs
    ev_b = ensemble_vars[None] if squeeze else ensemble_vars

    x = torch.as_tensor(np.ascontiguousarray(ms_b, dtype=np.float32), device=resolve_device(device))
    J = emission_jacobian(h_cam, x).cpu().numpy()  # (K, T, 2, 3)
    cov2d = np.einsum("ktij,ktjl,ktml->ktim", J, Vs_b, J)  # (K, T, 2, 2)
    var_x = cov2d[..., 0, 0] + ev_b[..., 0]
    var_y = cov2d[..., 1, 1] + ev_b[..., 1]
    if squeeze:
        return var_x[0], var_y[0]
    return var_x, var_y
