"""Frame-span cropping for the optimizer's ``s_frames``, observation-noise
helpers, and centering.

Span semantics (same contract as ``eks_tpu/utils/frames.py``): 0-based
half-open ``(start, end)`` tuples, None = open end, multiple non-overlapping
spans are concatenated in ascending order. Works on tensors of any device
(the selection is one index gather). ``crop_R`` and ``build_R_from_vars``
are the host (numpy) helpers for full time-varying R. ``center_predictions`` is the host
(numpy) variance-quantile frame filter and mean centering of the general
multi-camera path.
"""

from __future__ import annotations

import numpy as np
import torch

from eks_tpu_torch.marker_array import MarkerArray

__all__ = ["build_R_from_vars", "center_predictions", "crop_R", "crop_frames"]


def _resolve_span(span, i: int, n: int) -> tuple[int, int]:
    """Normalize one (start, end) entry to concrete [lo, hi) bounds."""
    if not (isinstance(span, tuple) and len(span) == 2):
        raise ValueError(f"span #{i} is not a (start, end) pair: {span!r}")
    raw_lo, raw_hi = span
    for end_name, value in (("start", raw_lo), ("end", raw_hi)):
        if value is not None and not isinstance(value, int):
            raise ValueError(f"span #{i} has a non-integer {end_name}: {value!r}")
    lo = 0 if raw_lo is None else raw_lo
    hi = n if raw_hi is None else raw_hi
    if not 0 <= lo < hi <= n:
        raise ValueError(
            f"span #{i} resolves to [{lo}, {hi}), which is not a valid window "
            f"on a length-{n} axis"
        )
    return lo, hi


def crop_frames(y: torch.Tensor, s_frames, dim: int = 0) -> torch.Tensor:
    """Concatenate the frame spans of ``y`` selected by ``s_frames`` along
    ``dim`` (axis 0 by default, as in the JAX package)."""
    if s_frames is None or len(s_frames) == 0:
        return y
    if not isinstance(s_frames, list):
        raise TypeError("expected s_frames as a list of (start, end) tuples, or None")
    if s_frames == [(None, None)]:
        return y
    n = y.shape[dim]
    spans = sorted(_resolve_span(f, i, n) for i, f in enumerate(s_frames))
    for (a_lo, a_hi), (b_lo, b_hi) in zip(spans, spans[1:]):
        if b_lo < a_hi:
            raise ValueError(
                f"spans [{a_lo}, {a_hi}) and [{b_lo}, {b_hi}) intersect; "
                "cropping windows must be disjoint"
            )
    keep = np.concatenate([np.arange(lo, hi) for lo, hi in spans])
    return y.index_select(dim, torch.as_tensor(keep, device=y.device))


def crop_R(R: np.ndarray, s_frames) -> np.ndarray:
    """Crop a (..., T, O, O) time-varying covariance along its time axis, on
    the host."""
    R_np = np.asarray(R)
    if not s_frames:
        return R_np
    *_, T, o1, o2 = R_np.shape
    assert o1 == o2, "R_tv must be square in its last two dims"
    cropped = crop_frames(torch.as_tensor(R_np), s_frames, dim=R_np.ndim - 3)
    return cropped.numpy()


def build_R_from_vars(ev: np.ndarray) -> np.ndarray:
    """(..., T, O) per-dim variances -> (..., T, O, O) diagonal covariances,
    floored at 1e-12, on the host."""
    ev_np = np.clip(np.asarray(ev), 1e-12, None)
    o = ev_np.shape[-1]
    return ev_np[..., :, None] * np.eye(o, dtype=ev_np.dtype)


def center_predictions(
    ensemble_marker_array: MarkerArray,
    quantile_keep_pca: float,
) -> tuple[np.ndarray, MarkerArray, MarkerArray, MarkerArray]:
    """Variance-quantile frame filter + per-camera/per-keypoint mean centering.

    Per keypoint, frames whose max-over-cameras ensemble variance exceeds the
    per-keypoint ``quantile_keep_pca`` percentile are marked invalid; all
    keypoints are truncated to the global minimum count of valid frames, and
    predictions are centered by the mean over those valid frames
    (same contract as reference eks/utils.py:293-365; implementation is one
    vectorized take_along_axis gather rather than a per-keypoint loop).

    Returns:
        (valid_frames_mask (T, K) bool,
         emA_centered_preds (1, C, T, K, 2),
         emA_good_centered_preds (1, C, T_good, K, 2),
         emA_means (1, C, 1, K, 2))
    """
    n_models, n_cameras, n_frames, n_keypoints, _ = ensemble_marker_array.shape
    assert n_models == 1, "Expected a post-ensemble MarkerArray (models axis already collapsed to 1)."

    preds = ensemble_marker_array.slice_fields("x", "y").array  # (1,C,T,K,2)
    variances = ensemble_marker_array.slice_fields("var_x", "var_y").array

    # per-frame max variance over cameras and x/y -> (T, K)
    max_vars = np.max(variances, axis=(0, 1, 4))
    thresholds = np.percentile(max_vars, quantile_keep_pca, axis=0)
    valid_frames_mask = max_vars <= thresholds  # (T, K)

    # every keypoint keeps its first `min_frames` valid frames; argsort on the
    # inverted mask is a stable way to pull valid indices to the front per kp
    min_frames = int(valid_frames_mask.sum(axis=0).min())
    first_valid = np.argsort(~valid_frames_mask, axis=0, kind="stable")[:min_frames]

    # gather (1,C,Tg,K,2) in one shot: index varies along (frames, keypoints)
    gather = first_valid[None, None, :, :, None]
    good = np.take_along_axis(preds, gather, axis=2)
    means = good.mean(axis=2, keepdims=True)  # (1,C,1,K,2)

    fields = ["x", "y"]
    return (
        valid_frames_mask,
        MarkerArray(preds - means, data_fields=fields),
        MarkerArray(good - means, data_fields=fields),
        MarkerArray(means, data_fields=fields),
    )
