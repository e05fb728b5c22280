"""Frame-span cropping for the optimizer's ``s_frames``.

Span semantics (same contract as ``eks_tpu/utils/frames.py``): 0-based
half-open ``(start, end)`` tuples, None = open end, multiple non-overlapping
spans are concatenated in ascending order. Works on tensors of any device
(the selection is one index gather).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["crop_frames"]


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
