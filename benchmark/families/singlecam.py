"""Single camera: ``eks_tpu_torch.ensemble_kalman_smoother_singlecam``.

Upstream EKS's single-camera model: per keypoint a 2-D random walk
(A = C = Q = I), observed as the ensemble median centred by its mean over
frames, with the ensemble variance as the observation noise and a prior
variance from the centred medians.
"""

from __future__ import annotations

import numpy as np
import torch

from families import Model
from reference.ensemble import ensemble_stats, nanvar
from reference.precision import Precision


def keypoint_names(cfg: dict) -> list[str]:
    return [f"kp{k}" for k in range(cfg["keypoints"])]


def call(eks, arr: np.ndarray, cfg: dict, smooth_param, device: str, timings: dict | None):
    from eks_tpu_torch.marker_array import MarkerArray

    return eks.ensemble_kalman_smoother_singlecam(
        marker_array=MarkerArray(arr, data_fields=["x", "y", "likelihood"]),
        keypoint_names=keypoint_names(cfg), smooth_param=smooth_param, device=device,
        timings=timings,
    )


def outputs(ret, cfg: dict) -> dict:
    df, s = ret
    return {"tables": df.to_numpy().reshape(1, cfg["frames"], cfg["keypoints"], 9),
            "s": np.asarray(s, dtype=np.float64)}


def model(arr: np.ndarray, cfg: dict, p: Precision, device) -> Model:
    q = p.q
    a = torch.as_tensor(arr[:, 0], device=device)  # (M, T, K, 3)
    stats = ensemble_stats(a[..., 0], a[..., 1], a[..., 2], p)  # (T, K, 5)
    preds = stats[..., :2]
    means = q(preds.mean(dim=0))  # (K, 2)
    centered = q(preds - means)
    ys = centered.transpose(0, 1).contiguous()  # (K, T, 2)
    K = ys.shape[0]
    eye = torch.eye(2, dtype=p.dtype, device=device).expand(K, 2, 2)
    return Model(
        stats=stats[None], ys=ys, m0=torch.zeros(K, 2, dtype=p.dtype, device=device),
        S0=torch.diag_embed(nanvar(centered, 0, p)), A=eye, Q=eye, C=eye,
        r=torch.clamp(stats[..., 2:4], min=1e-12).transpose(0, 1).contiguous(), means=means,
    )


def package(m: Model, means: torch.Tensor, covs: torch.Tensor, p: Precision) -> torch.Tensor:
    """(1, T, K, 9) table: C m plus the centring means, the ensemble
    statistics, and diag(C V Cᵀ)."""
    xy = p.q(means.transpose(0, 1) + m.means)  # C = I
    post = torch.diagonal(covs, dim1=-2, dim2=-1).transpose(0, 1)
    st = m.stats[0]
    return torch.cat([xy, st[..., 4:5], st[..., 0:2], st[..., 2:4], post], dim=-1)[None]
