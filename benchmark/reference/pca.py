"""Upstream EKS's initialisation of the linear multi-camera model (eks
v4.6.2 ``ensemble_kalman_smoother_multicam`` with no calibration), plain.

From the ensemble statistics of C cameras, per keypoint:

- the frame filter: a frame is valid where its largest ensemble variance
  over the cameras and x, y is at most the ``quantile``-th percentile of
  those over all frames (linear interpolation, as ``np.percentile``);
  every keypoint then keeps its first n valid frames, n the least count of
  any keypoint (upstream's min-count truncation);
- the centring: each camera's medians minus their mean over the kept
  frames; the centred 2C coordinates of a frame, camera by camera, are
  the observation y;
- PCA of the kept rows of y: their mean, then the right singular vectors
  of the rows minus it, the first ``n_latent`` of them the components; the
  principal components of every valid frame are (y - mean) times the
  components;
- the model: m0 = 0, A = I, C = componentsᵀ; S0 the diagonal of the
  variances (ddof 0) of each keypoint's valid principal components; Q the
  covariance (ddof 1) of the lag-1 differences of the valid frames'
  principal components taken in order with the invalid frames left out,
  over its largest absolute entry.

Departures from upstream: sklearn's PCA is an SVD of the centred rows here
too, but without its sign convention (``svd_flip``): a component and its
latent coordinate change sign together, which no output and no likelihood
sees. Everything runs in the caller's precision (float64 for the
reference) rather than upstream's mix of float32 and float64.
"""

from __future__ import annotations

import torch

from reference.precision import Precision


def valid_frames(variances: torch.Tensor, quantile: float) -> torch.Tensor:
    """(T, K) bool: the frames the filter keeps, from the ensemble
    variances (C, T, K, 2)."""
    max_vars = variances.amax(dim=(0, 3))
    return max_vars <= torch.quantile(max_vars, quantile / 100.0, dim=0)


def pca_init(stats: torch.Tensor, n_latent: int, quantile: float, p: Precision):
    """From the ensemble statistics (C, T, K, 5): the observations y
    (K, T, 2C), m0 (K, L), S0, A, Q (K, L, L), C (K, 2C, L) and the
    centring means (C, K, 2)."""
    q = p.q
    preds = stats[..., :2]
    n_cams, T, K, _ = stats.shape
    valid = valid_frames(stats[..., 2:4], quantile)
    n_kept = int(valid.sum(dim=0).min())
    kept = [torch.nonzero(valid[:, k])[:n_kept, 0] for k in range(K)]
    means = q(torch.stack([preds[:, kept[k], k].mean(dim=1) for k in range(K)], dim=1))  # (C, K, 2)
    ys = q(preds - means[:, None]).permute(2, 1, 0, 3).reshape(K, T, 2 * n_cams)
    S0, Q, C = [], [], []
    for k in range(K):
        rows = ys[k, kept[k]]
        mean = q(rows.mean(dim=0))
        comps = q(torch.linalg.svd(q(rows - mean), full_matrices=False).Vh[:n_latent])  # (L, 2C)
        pcs = q(q(ys[k, valid[:, k]] - mean) @ comps.T)  # (n_valid, L)
        S0.append(torch.diag(q(pcs.var(dim=0, unbiased=False))))
        cov = q(torch.cov(q(pcs[1:] - pcs[:-1]).T).reshape(n_latent, n_latent))
        peak = cov.abs().max()
        Q.append(q(cov / peak) if peak > 0 else cov)
        C.append(comps.T)
    eye = torch.eye(n_latent, dtype=p.dtype, device=stats.device)
    return (ys.contiguous(), torch.zeros(K, n_latent, dtype=p.dtype, device=stats.device),
            torch.stack(S0), eye.expand(K, n_latent, n_latent), torch.stack(Q), torch.stack(C), means)
