"""IBL paw smoother: two asynchronous cameras aligned by timestamps.

Counterpart of ``eks_tpu/models/ibl_paw.py``. Prologue: the right
camera's paw labels are swapped (its view is mirrored), its markers are
linearly interpolated onto the left camera's timestamps and x-mirrored by the
image width; left frames outside the right camera's time range are dropped.
The aligned two-view data (with a dummy zero likelihood field) is then handed
to the linear multicam smoother with the likelihood filter disabled.
"""

from __future__ import annotations

import logging
import os
from typing import Literal, Sequence

import numpy as np
import pandas as pd

import torch

from eks_tpu_torch import tracing
from eks_tpu_torch.marker_array import MarkerArray, input_dfs_to_markerArray
from eks_tpu_torch.models.multicam import ensemble_kalman_smoother_multicam
from eks_tpu_torch.utils import convert_lp_dlc, save_dlc_csv

__all__ = [
    "fit_eks_multicam_ibl_paw",
    "remove_camera_means",
    "add_camera_means",
]

logger = logging.getLogger(__name__)

BODYPART_LIST = ["paw_l", "paw_r"]
CAMERA_NAMES = ["left", "right"]


def remove_camera_means(
    ensemble_stacks: list[np.ndarray],
    camera_means: Sequence,
) -> list[np.ndarray]:
    """Subtract per-camera means from column ``camera_id`` of each stack.
    Returns new arrays; the caller's inputs are never written to."""
    out = [np.array(a) for a in ensemble_stacks]
    for k in range(len(ensemble_stacks)):
        for cam_id, cam_mean in enumerate(camera_means):
            out[k][:, cam_id] = ensemble_stacks[k][:, cam_id] - cam_mean
    return out


def add_camera_means(
    ensemble_stacks: list[np.ndarray],
    camera_means: Sequence,
) -> list[np.ndarray]:
    """Inverse of :func:`remove_camera_means`. Returns new arrays."""
    out = [np.array(a) for a in ensemble_stacks]
    for k in range(len(ensemble_stacks)):
        for cam_id, cam_mean in enumerate(camera_means):
            out[k][:, cam_id] = ensemble_stacks[k][:, cam_id] + cam_mean
    return out


@tracing.entry_point
def fit_eks_multicam_ibl_paw(
    input_source: str,
    save_dir: str,
    smooth_param: float | list | None = None,
    s_frames: list | None = None,
    quantile_keep_pca: float = 50.0,
    avg_mode: Literal["mean", "median"] = "median",
    var_mode: Literal["var", "confidence_weighted_var"] = "confidence_weighted_var",
    img_width: int = 128,
    inflate_vars: bool = False,
    n_latent: int = 3,
    devices: int | None = None,
    partition: Literal["keypoint", "time"] = "keypoint",
    device: str | torch.device = "cuda",
) -> tuple:
    """Align the asynchronous left/right paw cameras and smooth jointly.

    Expects ``input_source`` to contain per-seed prediction CSVs with 'left'
    or 'right' in the filename plus two ``*timestamps*`` ``.npy`` arrays.
    ``device`` is where the smoother runs ("cuda" by default);
    ``devices``/``partition`` shard the smoothing step over that many
    devices along the keypoint or the time axis.

    Returns:
        (camera_dfs, s_finals, input_dfs_list, bodypart_list)
    """
    input_dfs_left: list[pd.DataFrame] = []
    input_dfs_right: list[pd.DataFrame] = []
    timestamps_left = None
    timestamps_right = None

    for filename in os.listdir(input_source):
        path = os.path.join(input_source, filename)
        if "timestamps" not in filename:
            # reference contract: every non-timestamps file is a prediction CSV, and anything
            # without 'left' in its name is treated as right-camera — warn
            # when that catch-all is doing real work so a stray file does
            # not silently corrupt the right ensemble
            if "left" not in filename and "right" not in filename:
                logger.warning(
                    "file %r has neither 'left' nor 'right' in its name; "
                    "treating it as a RIGHT-camera prediction CSV (reference "
                    "semantics) — remove it from the input directory if that "
                    "is not intended",
                    filename,
                )
            df = pd.read_csv(path, header=[0, 1, 2], index_col=0)
            df = convert_lp_dlc(df, BODYPART_LIST)
            if "left" in filename:
                input_dfs_left.append(df)
            else:
                # the right camera is mirrored: swap paw identities
                swap = {
                    "paw_l_x": "paw_r_x",
                    "paw_l_y": "paw_r_y",
                    "paw_l_likelihood": "paw_r_likelihood",
                    "paw_r_x": "paw_l_x",
                    "paw_r_y": "paw_l_y",
                    "paw_r_likelihood": "paw_l_likelihood",
                }
                df = df.rename(columns=swap)
                df = df.loc[:, list(swap.keys())]
                input_dfs_right.append(df)
        else:
            ts = np.load(path)
            if "left" in filename:
                timestamps_left = ts
            else:
                timestamps_right = ts

    if timestamps_left is None or timestamps_right is None:
        raise ValueError("Both cameras need a timestamps .npy file for alignment")
    if len(input_dfs_right) != len(input_dfs_left) or len(input_dfs_left) == 0:
        raise ValueError(
            "Left and right cameras must contribute equal, non-zero ensemble counts."
        )

    # frames of the left camera that fall inside the right camera's range
    keep = (timestamps_left >= timestamps_right[0]) & (
        timestamps_left <= timestamps_right[-1]
    )
    ts_query = timestamps_left[keep]

    xy_cols = [0, 1, 3, 4]  # paw_l x/y, paw_r x/y in the converted frame
    left_per_model, right_per_model = [], []
    for m in range(len(input_dfs_left)):
        left_np = input_dfs_left[m].to_numpy()[keep][:, xy_cols]
        right_raw = input_dfs_right[m].to_numpy()
        right_np = np.stack(
            [
                np.interp(ts_query, timestamps_right, right_raw[:, j])
                for j in xy_cols
            ],
            axis=-1,
        )
        # mirror x to the left camera's orientation
        right_np[:, 0] = img_width - right_np[:, 0]
        right_np[:, 2] = img_width - right_np[:, 2]
        left_per_model.append(left_np)
        right_per_model.append(right_np)

    keys = ["paw_l_x", "paw_l_y", "paw_r_x", "paw_r_y"]
    input_dfs_list = [
        [pd.DataFrame(arr, columns=keys) for arr in left_per_model],
        [pd.DataFrame(arr, columns=keys) for arr in right_per_model],
    ]

    if var_mode != "var":
        # the likelihood field below is dummy zeros, so the
        # confidence-weighted variance divides by zero and saturates at
        # float32 max; the reference's default does the same with its zero
        # dummy field, so the default is kept for parity, but flag it loudly
        logger.warning(
            "fit_eks_multicam_ibl_paw: var_mode=%r divides by the paw "
            "family's dummy zero likelihoods, saturating every ensemble "
            "variance at float32 max (reference-parity behavior); pass "
            "var_mode='var' for meaningful variances",
            var_mode,
        )

    marker_array = input_dfs_to_markerArray(
        input_dfs_list, BODYPART_LIST, CAMERA_NAMES, data_fields=["x", "y"]
    )
    # append a dummy zero likelihood field
    lh_shape = list(marker_array.shape)
    lh_shape[-1] = 1
    marker_array = MarkerArray.stack_fields(
        marker_array,
        MarkerArray(shape=tuple(lh_shape), data_fields=["likelihood"]),
    )

    camera_dfs, s_finals, _df_3d = ensemble_kalman_smoother_multicam(
        marker_array=marker_array,
        keypoint_names=BODYPART_LIST,
        camera_names=CAMERA_NAMES,
        smooth_param=smooth_param,
        quantile_keep_pca=quantile_keep_pca,
        s_frames=s_frames,
        avg_mode=avg_mode,
        var_mode=var_mode,
        inflate_vars=inflate_vars,
        n_latent=n_latent,
        inflate_vars_kwargs={"likelihoods": None},
        devices=devices,
        partition=partition,
        device=device,
    )

    os.makedirs(save_dir, exist_ok=True)
    for c, camera in enumerate(CAMERA_NAMES):
        save_dlc_csv(
            camera_dfs[c], os.path.join(save_dir, f"multicam_{camera}_results.csv")
        )
    return camera_dfs, s_finals, input_dfs_list, BODYPART_LIST
