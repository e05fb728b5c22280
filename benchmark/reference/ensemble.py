"""Ensemble statistics of pose predictions, as upstream EKS defines them.

Over the ensemble members (axis 0): the NaN-aware median of x and y (the
mean of the two middle values when their count is even), the mean
likelihood (the sum over members divided by their number), and the
confidence-weighted variance ``nanvar(x) / mean_likelihood`` with ddof 0;
a variance that is NaN becomes 1000.
"""

from __future__ import annotations

import torch

from reference.precision import Precision

NAN_VARIANCE = 1000.0


def nanmedian(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Median of the non-NaN values along ``dim``; the mean of the two
    middle ones when their count is even; NaN where there are none."""
    isnan = torch.isnan(a)
    n = (~isnan).sum(dim=dim, keepdim=True)
    srt = torch.sort(torch.where(isnan, torch.full_like(a, float("inf")), a), dim=dim).values
    lo = torch.gather(srt, dim, torch.clamp(n - 1, min=0) // 2)
    hi = torch.gather(srt, dim, torch.clamp(n // 2, max=a.shape[dim] - 1))
    med = ((lo + hi) / 2).squeeze(dim)
    return torch.where(n.squeeze(dim) == 0, torch.full_like(med, float("nan")), med)


def nanmean(a: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    isnan = torch.isnan(a)
    total = torch.where(isnan, torch.zeros_like(a), a).sum(dim=dim, keepdim=keepdim)
    return total / (~isnan).sum(dim=dim, keepdim=keepdim).to(a.dtype)


def nanvar(a: torch.Tensor, dim: int, p: Precision) -> torch.Tensor:
    """Variance with ddof 0 over the non-NaN values along ``dim``."""
    isnan = torch.isnan(a)
    dev = p.q(torch.where(isnan, torch.zeros_like(a), a - p.q(nanmean(a, dim, keepdim=True))))
    return p.q(p.q((dev * dev)).sum(dim=dim) / (~isnan).sum(dim=dim).to(a.dtype))


def ensemble_stats(x: torch.Tensor, y: torch.Tensor, lh: torch.Tensor, p: Precision) -> torch.Tensor:
    """(M, ...) member planes of x, y and likelihood -> (..., 5) statistics
    [median x, median y, variance x, variance y, mean likelihood]."""
    x, y, lh = p.q(x), p.q(y), p.q(lh)
    n_members = x.shape[0]
    if n_members < 2:
        raise ValueError("the confidence-weighted variance needs two members or more")
    conf = p.q(lh.sum(dim=0) / n_members)
    var_x = torch.nan_to_num(p.q(nanvar(x, 0, p) / conf), nan=NAN_VARIANCE)
    var_y = torch.nan_to_num(p.q(nanvar(y, 0, p) / conf), nan=NAN_VARIANCE)
    return torch.stack([nanmedian(x, 0), nanmedian(y, 0), var_x, var_y, conf], dim=-1)
