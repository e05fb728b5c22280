"""Linear multi-camera: ``eks_tpu_torch.ensemble_kalman_smoother_multicam``
with no calibration, no variance inflation and s tuned or given.

Upstream EKS's model of a rig of C cameras with no calibration: per
keypoint a random walk in an ``n_latent``-dimensional PCA latent of the
2C centred ensemble medians, observed through the components, with the
ensemble variances as the observation noise (``reference/pca.py``). Each
camera's table holds C m plus its centring means, the ensemble
statistics, and diag(C V Cᵀ) plus the ensemble variance (upstream adds
the two).

Importing the module adds the configuration's session recipe to the
generators (``generators/two_camera.py``).
"""

from __future__ import annotations

import numpy as np
import torch

import generators.two_camera  # noqa: F401  (adds make_two_camera_session)
from families import Model
from reference.ensemble import ensemble_stats
from reference.pca import pca_init
from reference.precision import Precision


def keypoint_names(cfg: dict) -> list[str]:
    return [f"kp{k}" for k in range(cfg["keypoints"])]


def camera_names(cfg: dict) -> list[str]:
    return [f"cam{c}" for c in range(cfg["cameras"])]


def call(eks, arr: np.ndarray, cfg: dict, smooth_param, device: str, timings: dict | None):
    from eks_tpu_torch.marker_array import MarkerArray

    return eks.ensemble_kalman_smoother_multicam(
        marker_array=MarkerArray(arr, data_fields=["x", "y", "likelihood"]),
        keypoint_names=keypoint_names(cfg), camera_names=camera_names(cfg), smooth_param=smooth_param,
        quantile_keep_pca=cfg["quantile_keep_pca"], inflate_vars=False, n_latent=cfg["n_latent"],
        device=device, timings=timings,
    )


def outputs(ret, cfg: dict) -> dict:
    camera_dfs, s, _ = ret
    T, K = cfg["frames"], cfg["keypoints"]
    return {"tables": np.stack([df.to_numpy().reshape(T, K, 9) for df in camera_dfs]),
            "s": np.asarray(s, dtype=np.float64)}


def model(arr: np.ndarray, cfg: dict, p: Precision, device) -> Model:
    a = torch.as_tensor(arr, device=device)  # (M, C, T, K, 3)
    stats = ensemble_stats(a[..., 0], a[..., 1], a[..., 2], p)  # (C, T, K, 5)
    ys, m0, S0, A, Q, C, means = pca_init(stats, cfg["n_latent"], cfg["quantile_keep_pca"], p)
    K, T, O = ys.shape
    r = torch.clamp(stats[..., 2:4], min=1e-12).permute(2, 1, 0, 3).reshape(K, T, O)
    return Model(stats=stats, ys=ys, m0=m0, S0=S0, A=A, Q=Q, C=C, r=r.contiguous(), means=means)


def package(m: Model, means: torch.Tensor, covs: torch.Tensor, p: Precision) -> torch.Tensor:
    """(C, T, K, 9) tables: C m plus the centring means, the ensemble
    statistics, and diag(C V Cᵀ) plus the ensemble variance."""
    q = p.q
    K, T, _ = means.shape
    n_cams = m.stats.shape[0]

    def by_camera(x):  # (K, T, 2C) -> (C, T, K, 2)
        return x.reshape(K, T, n_cams, 2).permute(2, 1, 0, 3)

    xy = q(by_camera(q(torch.einsum("kol,ktl->kto", m.C, means))) + m.means[:, None])
    proj = q(torch.einsum("kol,ktlj,koj->kto", m.C, covs, m.C))
    st = m.stats
    post = q(by_camera(proj) + st[..., 2:4])
    return torch.cat([xy, st[..., 4:5], st[..., 0:2], st[..., 2:4], post], dim=-1)
