"""Single-camera EKS: per-keypoint 2-D random-walk smoothing.

Counterpart of ``eks_tpu/models/singlecam.py``. Model: state = (x, y) with
``A = C = Q = I_2``, initial covariance from the variance of the centered
ensemble trajectory, observation noise = per-frame ensemble variance, one
smoothing scale ``s`` per keypoint (or per block of keypoints).

The whole pipeline runs on one device: the raw (M, T, K) prediction planes
are uploaded once, the prep (ensemble statistics, centering, KF init), the
s-optimizer, the final smoother and the output packaging run there, and the
(T, K, 9) table comes back in one copy. Several sessions of equal shape
stack along the keypoint axis into one such run (every stage is
independent per keypoint lane).

Output CSV carries 9 labels per keypoint:
``x, y, likelihood, x_ens_median, y_ens_median, x_ens_var, y_ens_var,
x_posterior_var, y_posterior_var``.
"""

from __future__ import annotations

import logging
import os
from typing import Literal

import numpy as np
import torch

from eks_tpu_torch import tracing
from eks_tpu_torch.core import _ensemble_kernel, _nanvar, run_kalman_smoother
from eks_tpu_torch.marker_array import MarkerArray, input_dfs_to_markerArray
from eks_tpu_torch.utils import dlc_frame, format_data, pull_outputs, resolve_device, save_dlc_csv

logger = logging.getLogger(__name__)

__all__ = [
    "fit_eks_singlecam",
    "fit_eks_singlecam_sessions",
    "ensemble_kalman_smoother_singlecam",
    "ensemble_kalman_smoother_singlecam_sessions",
    "initialize_kalman_filter",
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


@tracing.entry_point
def fit_eks_singlecam(
    input_source: str | list,
    save_file: str,
    bodypart_list: list | None = None,
    smooth_param: float | list | None = None,
    s_frames: list | None = None,
    blocks: list = [],
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> tuple:
    """Load ensemble CSVs, run the single-camera smoother, save the result.

    Args:
        input_source: directory or list of prediction CSV paths (one per
            ensemble seed).
        save_file: output CSV path.
        bodypart_list: keypoints to smooth; default = all found in the files.
        smooth_param: fixed ``s`` (scalar or per-keypoint list) to bypass
            optimization.
        s_frames: (start, end) 0-based half-open spans used for the NLL loss
            only; final smoothing always covers all frames.
        blocks: groups of keypoint indices sharing one ``s``.
        avg_mode / var_mode: ensemble consensus and variance modes.
        devices / partition: shard the smoothing step over ``devices``
            devices of ``device``'s type, along the keypoint axis (the
            default) or the time axis (``ops/shards.py``).
        device: where the pipeline runs; "cuda" (the default) raises when
            no card is visible.
        timings: if a dict, the seconds of reading the CSVs into the marker
            array ("read") and of writing the output CSV ("write"), beside
            the stages :func:`ensemble_kalman_smoother_singlecam` records.

    Returns:
        (df_smoothed, s_finals, input_dfs_list, bodypart_list)
    """
    span = tracing.begin(timings, "read")
    input_dfs_list, keypoint_names = format_data(input_source)
    if bodypart_list is None:
        bodypart_list = keypoint_names
        logger.info(f"ensemble predictions loaded; keypoints: {bodypart_list}")

    marker_array = input_dfs_to_markerArray([input_dfs_list], bodypart_list, [""])
    tracing.end(timings, span, stage=True)
    df_smoothed, s_finals = ensemble_kalman_smoother_singlecam(
        marker_array=marker_array,
        keypoint_names=bodypart_list,
        smooth_param=smooth_param,
        s_frames=s_frames,
        blocks=blocks,
        avg_mode=avg_mode,
        var_mode=var_mode,
        devices=devices,
        partition=partition,
        device=device,
        timings=timings,
    )

    span = tracing.begin(timings, "write")
    save_dir = os.path.dirname(save_file)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    save_dlc_csv(df_smoothed, save_file)
    tracing.end(timings, span, stage=True)
    return df_smoothed, s_finals, input_dfs_list, bodypart_list


@tracing.entry_point
def fit_eks_singlecam_sessions(
    input_sources: list,
    save_files: list,
    bodypart_list: list | None = None,
    smooth_param: float | list | None = None,
    s_frames: list | None = None,
    blocks: list | None = None,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    device: str | torch.device = "cuda",
) -> list[tuple]:
    """Smooth SEVERAL sessions in one batched run: each session is an
    independent recording (its own ensemble CSV set), and sessions stack as
    extra keypoint lanes of one optimizer and one final pass.

    Args:
        input_sources: one input source (directory or CSV list) per session.
        save_files: one output CSV path per session.
        bodypart_list: keypoints to smooth, shared across sessions;
            default = each session's own detected keypoints.
        smooth_param: fixed ``s``: a scalar (all sessions) or a per-session
            list of scalars/lists.
        blocks: per-session block structure (list of block lists), or None.
        Other args as in :func:`fit_eks_singlecam`.

    Returns:
        list of (df_smoothed, s_finals, input_dfs_list, bodypart_list),
        one per session.
    """
    assert len(save_files) == len(input_sources), "one save_file per session"

    marker_arrays, names_per_session, dfs_per_session = [], [], []
    for src in input_sources:
        input_dfs_list, keypoint_names = format_data(src)
        names = bodypart_list if bodypart_list is not None else keypoint_names
        marker_arrays.append(input_dfs_to_markerArray([input_dfs_list], names, [""]))
        names_per_session.append(names)
        dfs_per_session.append(input_dfs_list)

    results = ensemble_kalman_smoother_singlecam_sessions(
        marker_arrays=marker_arrays,
        keypoint_names=names_per_session,
        smooth_param=smooth_param,
        s_frames=s_frames,
        blocks=blocks,
        avg_mode=avg_mode,
        var_mode=var_mode,
        devices=devices,
        partition=partition,
        device=device,
    )

    out = []
    for (df_smoothed, s_finals), save_file, dfs, names in zip(
        results, save_files, dfs_per_session, names_per_session
    ):
        save_dir = os.path.dirname(save_file)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        save_dlc_csv(df_smoothed, save_file)
        out.append((df_smoothed, s_finals, dfs, names))
    return out


@tracing.entry_point
def ensemble_kalman_smoother_singlecam_sessions(
    marker_arrays: list,
    keypoint_names: list,
    smooth_param: float | list | None = None,
    s_frames: list | None = None,
    blocks: list | None = None,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> list[tuple]:
    """Array-level multi-session single-camera smoother.

    Sessions with equal (models, frames) are concatenated along the keypoint
    axis and smoothed as ONE run, equivalent to per-session runs because
    every stage is independent per keypoint lane (up to float32 rounding:
    the lane count sets how the kernels cut each lane, so batched and solo
    runs add in different orders). Unequal shapes, a single session, and a
    mix of fixed and auto ``s`` fall back to one run per session.

    Args:
        marker_arrays: one (M, 1, T, K_s, 3) MarkerArray per session.
        keypoint_names: per-session keypoint-name lists.
        smooth_param: scalar (broadcast) or per-session list.
        blocks: per-session lists of keypoint-index blocks, or None.
        timings: as in :func:`ensemble_kalman_smoother_singlecam`, for the
            batched run (a fallback fills it from its last session).

    Returns:
        list of (markers_df, s_finals) per session.
    """
    if not marker_arrays:
        return []
    n_sessions = len(marker_arrays)
    assert len(keypoint_names) == n_sessions, "one name list per session"
    per_session_param = isinstance(smooth_param, (list, tuple))
    if per_session_param:
        assert len(smooth_param) == n_sessions, (
            "per-session smooth_param list must match the session count"
        )
    if blocks:
        assert len(blocks) == n_sessions, "one block list per session"

    def solo_runs():
        return [
            ensemble_kalman_smoother_singlecam(
                marker_array=ma,
                keypoint_names=names,
                smooth_param=(smooth_param[i] if per_session_param else smooth_param),
                s_frames=s_frames,
                blocks=(blocks[i] if blocks else []),
                avg_mode=avg_mode,
                var_mode=var_mode,
                devices=devices,
                partition=partition,
                device=device,
                timings=timings,
            )
            for i, (ma, names) in enumerate(zip(marker_arrays, keypoint_names))
        ]

    if len({ma.shape[:3] for ma in marker_arrays}) > 1 or n_sessions == 1:
        logger.info("sessions differ in (models, frames) shape or are one; smoothing them one by one")
        return solo_runs()
    if per_session_param and any(p is None for p in smooth_param):
        # mixed fixed/auto sessions would need a partial optimizer run
        logger.info("mixed fixed/auto smooth_param across sessions; smoothing them one by one")
        return solo_runs()

    # stack sessions along the keypoint axis: (M, 1, T, sum(K_s), 3)
    k_counts = [ma.shape[3] for ma in marker_arrays]
    offsets = np.concatenate([[0], np.cumsum(k_counts)])
    stacked = MarkerArray(
        np.concatenate([np.asarray(ma.array) for ma in marker_arrays], axis=3),
        data_fields=list(marker_arrays[0].data_fields),
    )

    # per-session blocks shift by each session's keypoint offset; once ANY
    # session declares blocks, block-less sessions contribute singletons
    merged_blocks: list = []
    if blocks and any(blocks):
        for i, session_blocks in enumerate(blocks):
            if session_blocks:
                merged_blocks += [[int(offsets[i]) + k for k in b] for b in session_blocks]
            else:
                merged_blocks += [[int(offsets[i]) + k] for k in range(k_counts[i])]

    # scalar smooth_param broadcasts; per-session entries expand per keypoint
    merged_param: float | list | None = smooth_param
    if per_session_param:
        merged_param = []
        for i, p in enumerate(smooth_param):
            if isinstance(p, (list, tuple, np.ndarray)):
                vals = [float(v) for v in p]
                if len(vals) == 1:  # length-1 lists broadcast, like the core
                    vals = vals * k_counts[i]
                assert len(vals) == k_counts[i], (
                    f"session {i}: smooth_param list must have one entry "
                    f"per keypoint ({k_counts[i]}), got {len(vals)}"
                )
                merged_param += vals
            else:
                merged_param += [float(p)] * k_counts[i]

    final_np, s_all = _singlecam_smooth_table(
        stacked, merged_param, s_frames, merged_blocks, avg_mode, var_mode,
        devices, partition, device, timings,
    )
    span = tracing.begin(timings, "table")
    n_frames = final_np.shape[0]
    n_labels = len(OUTPUT_LABELS)
    results = []
    for i, names in enumerate(keypoint_names):
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        sub = dlc_frame(final_np[:, lo:hi, :].reshape(n_frames, (hi - lo) * n_labels), names, OUTPUT_LABELS)
        results.append((sub, s_all[lo:hi]))
    tracing.end(timings, span)
    return results


@tracing.entry_point
def ensemble_kalman_smoother_singlecam(
    marker_array: MarkerArray,
    keypoint_names: list,
    smooth_param: float | list | None = None,
    s_frames: list | None = None,
    blocks: list = [],
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> tuple:
    """Array-level single-camera smoother.

    Args:
        marker_array: (n_models, 1, T, K, 3) with fields [x, y, likelihood].
        device: where the pipeline runs ("cuda" by default).
        timings: if a dict, the device is synchronized between stages and
            their seconds are recorded ("prep", "optimizer", "final_pass",
            "package"), with the optimizer's Adam iteration count, the
            spans of the stages, of the Adam iterations and of the pandas
            table ("table") and this call's kernel launches
            (``eks_tpu_torch.tracing``).

    Returns:
        (markers_df, s_finals) — DataFrame with 9 labels per keypoint.
    """
    final_np, s_finals = _singlecam_smooth_table(
        marker_array, smooth_param, s_frames, blocks, avg_mode, var_mode,
        devices, partition, device, timings,
    )
    span = tracing.begin(timings, "table")
    n_frames, n_keypoints = final_np.shape[:2]
    markers_df = dlc_frame(
        final_np.reshape(n_frames, n_keypoints * len(OUTPUT_LABELS)), keypoint_names, OUTPUT_LABELS
    )
    tracing.end(timings, span)
    return markers_df, s_finals


def _singlecam_smooth_table(
    marker_array: MarkerArray,
    smooth_param=None,
    s_frames=None,
    blocks=[],
    avg_mode="median",
    var_mode="confidence_weighted_var",
    devices=None,
    partition="keypoint",
    device="cuda",
    timings=None,
) -> tuple:
    """The singlecam pipeline up to the pandas table: returns
    ``(final_np (T, K, 9) in OUTPUT_LABELS order, s_finals)``."""
    dev = resolve_device(device)
    n_models, _, _, n_keypoints, _ = marker_array.shape

    span = tracing.begin(timings, "prep")
    arr = torch.as_tensor(
        np.ascontiguousarray(marker_array.array[:, 0], dtype=np.float32), device=dev
    )  # (M, T, K, 3)
    stats, ys, means, S0s = _prep_singlecam(
        arr[..., 0], arr[..., 1], arr[..., 2], n_models, avg_mode, var_mode
    )
    eye = torch.eye(2, dtype=torch.float32, device=dev).expand(n_keypoints, 2, 2).contiguous()
    m0s = torch.zeros((n_keypoints, 2), dtype=torch.float32, device=dev)
    tracing.end(timings, span, dev, stage=True)

    s_finals, ms, Vs = run_kalman_smoother(
        ys=ys, m0s=m0s, S0s=S0s, As=eye, Cs=eye, Qs=eye,
        ensemble_vars=stats[..., 2:4],  # (T, K, 2)
        s_frames=s_frames, smooth_param=smooth_param, blocks=blocks,
        devices=devices, partition=partition, timings=timings,
    )

    span = tracing.begin(timings, "package")
    (final_np,) = pull_outputs(_package_singlecam_full(stats, means, ms, Vs, eye))
    tracing.end(timings, span, stage=True)
    return final_np, s_finals


def _package_singlecam_full(stats, means, ms, Vs, Cs) -> torch.Tensor:
    """The (T, K, 9) output table in OUTPUT_LABELS order: reprojected
    smoothed positions y = C m plus the centering means, the ensemble
    statistics, and the posterior variances diag(C V Cᵀ)."""
    y_m = torch.einsum("kij,ktj->kti", Cs, ms)  # (K, T, 2)
    y_v = torch.einsum("kij,ktjl,kml->ktim", Cs, Vs, Cs)  # (K, T, 2, 2)
    smoothed = y_m.transpose(0, 1) + means[None]  # (T, K, 2)
    postvar = torch.stack([y_v[..., 0, 0], y_v[..., 1, 1]], dim=-1).transpose(0, 1)
    return torch.cat(
        [smoothed, stats[..., 4:5], stats[..., 0:2], stats[..., 2:4], postvar], dim=-1
    )


def _prep_singlecam(data_x, data_y, data_lh, n_models, avg_mode, var_mode):
    """Ensemble stats + centering (quantile 100: every frame) + KF init from
    the raw (M, T, K) planes; returns (stats (T, K, 5), ys (K, T, 2),
    means (K, 2), S0s (K, 2, 2)). Centering uses the plain mean over frames
    (not a NaN-aware one), as the JAX package does."""
    stats = _ensemble_kernel(data_x, data_y, data_lh, n_models, avg_mode, var_mode, 1000.0)
    preds = stats[..., :2]
    means = preds.mean(dim=0)  # (K, 2)
    centered = preds - means
    ys = centered.transpose(0, 1).contiguous()  # (K, T, 2)
    var_xy = _nanvar(centered, 0)  # (K, 2)
    S0s = torch.diag_embed(var_xy)
    return stats, ys, means, S0s


def initialize_kalman_filter(emA_centered_preds: MarkerArray, device: str | torch.device = "cuda") -> tuple:
    """Random-walk init from a centered MarkerArray: m0 = 0,
    S0 = diag(nanvar of the centered predictions), A = C = Q = I_2."""
    dev = resolve_device(device)
    _, _, _, n_keypoints, _ = emA_centered_preds.shape
    centered = emA_centered_preds.slice_fields("x", "y").array[0, 0]  # (T, K, 2)
    var_xy = np.nanvar(centered, axis=0)
    S0s = np.zeros((n_keypoints, 2, 2))
    S0s[:, 0, 0] = var_xy[:, 0]
    S0s[:, 1, 1] = var_xy[:, 1]
    eye = np.tile(np.eye(2), (n_keypoints, 1, 1))

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return t(np.zeros((n_keypoints, 2))), t(S0s), t(eye), t(eye), t(eye)
