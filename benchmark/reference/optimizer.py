"""The s-optimizer as upstream EKS and the program state it, replayed: per
keypoint, Adam on log s of the negative log-likelihood with a constant R,
from the upstream initial guess, until the upstream stop rule.

- Initial s: the standard deviation of the frame-to-frame changes of the
  ensemble variances over the first 2000 frames (all coordinates
  together), rounded to 5 decimals; 2.0 where that is not a positive
  number. Adam starts from log s, s clipped to [1e-6, 1e3].
- Loss: the negative log-likelihood at s = exp(clip(log s, -8, 8)), with R
  the time median of the variances floored at 1e-12 and then at 1e-4 (a
  non-finite loss counts as 1e12 with no gradient).
- Adam as optax's ``adam(1.0)`` fed the gradient times the learning rate
  0.25: b1 = 0.9, b2 = 0.999, eps = 1e-8, the bias correction after the
  count's increment.
- Stop: a lane stops when |loss - previous loss| < 0.01 |log(max(previous,
  1e-12))| + 1e-6, or after 300 iterations; it keeps its state from then on.

A lane's loss near the stop threshold decides, to a rounding, whether it
stops. Where the replay's |change| lies within ``TIE`` times |loss| of the
threshold, the stop is a tie: the replay records the lane's s there as one
of its answers and goes on as if it had not stopped, so that the
answers are the s of every tie and of the stop that is no tie.
"""

from __future__ import annotations

import math

import torch

from reference.ensemble import nanmean, nanmedian
from reference.pkalman import filter_loglik
from reference.precision import Precision

LR, TOL, CAP, BOUNDS, MIN_R_VAR = 0.25, 1e-2, 300, (-8.0, 8.0), 1e-4
B1, B2, EPS = 0.9, 0.999, 1e-8
#: a stop test within this share of |loss| of its threshold is a tie: a
#: float32 log-likelihood over 10,000 steps is off by some 1e-7 of itself
#: (the port's kernel A against its plain version: 2.4e-7 at most)
TIE = 1e-6


def initial_s(r: torch.Tensor) -> torch.Tensor:
    """(K,) initial s from per-step variances r (K, T, O)."""
    ev = r[:, :2000]
    diffs = ev[:, 1:] - ev[:, :-1]
    dev = diffs - nanmean(diffs, dim=(1, 2), keepdim=True)
    std = torch.sqrt(nanmean(dev * dev, dim=(1, 2)))
    s = torch.round(std * 1e5) / 1e5
    return torch.where(torch.isfinite(s) & (s > 0), s, torch.full_like(s, 2.0))


def constant_r(r: torch.Tensor) -> torch.Tensor:
    """(K, T, O) per-step variances -> (K, O) constant R."""
    return torch.clamp(nanmedian(torch.clamp(r, min=1e-12), dim=1), min=MIN_R_VAR)


def loss_and_grad(lanes, log_s: torch.Tensor, p: Precision):
    """Negative log-likelihoods (N,) at exp(clip(log_s)) and their
    derivatives in log s."""
    ys, m0, S0, A, Q, C, r = lanes
    x = log_s.detach().clone().requires_grad_(True)
    s = torch.exp(torch.clamp(x, *BOUNDS)).to(p.dtype)
    nll = -filter_loglik(ys, m0, S0, A, s[:, None, None] * Q, C, r, p)
    (grad,) = torch.autograd.grad(nll.sum(), x)
    nll = nll.detach().to(torch.float64)
    finite = torch.isfinite(nll)
    return torch.where(finite, nll, torch.full_like(nll, 1e12)), torch.where(finite, grad, torch.zeros_like(grad))


def replay(lanes, r_steps: torch.Tensor, p: Precision) -> list[list[float]]:
    """The answers (values of log s, as above) of every lane: ``lanes`` the
    model tensors with R constant, ``r_steps`` (N, T, O) the per-step
    variances the initial guess is taken from."""
    s_log = torch.log(torch.clamp(initial_s(r_steps), 1e-6, 1e3)).to(torch.float64)
    n = s_log.shape[0]
    mu, nu = torch.zeros_like(s_log), torch.zeros_like(s_log)
    count = torch.zeros_like(s_log)
    prev = torch.full_like(s_log, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=s_log.device)
    answers: list[list[float]] = [[] for _ in range(n)]
    for _ in range(CAP):
        loss, grad = loss_and_grad(lanes, s_log, p)
        g = grad.to(torch.float64) * LR
        mu_new, nu_new = (1 - B1) * g + B1 * mu, (1 - B2) * g * g + B2 * nu
        c = count + 1
        s_new = s_log - (mu_new / (1 - B1 ** c)) / (torch.sqrt(nu_new / (1 - B2 ** c)) + EPS)
        thr = TOL * torch.abs(torch.log(torch.clamp(prev, min=1e-12))) + 1e-6
        change = torch.abs(loss - prev)
        finite = torch.isfinite(prev)
        tie = finite & (torch.abs(change - thr) <= TIE * torch.abs(loss))
        stop = finite & (change < thr) & ~tie
        active = ~done
        s_log = torch.where(active, s_new, s_log)
        mu, nu = torch.where(active, mu_new, mu), torch.where(active, nu_new, nu)
        count = torch.where(active, c, count)
        prev = torch.where(active, loss, prev)
        for k in torch.nonzero(active & (tie | stop))[:, 0].tolist():
            answers[k].append(float(torch.clamp(s_log[k], *BOUNDS)))
        done = done | (active & stop)
        if bool(done.all()):
            break
    for k in torch.nonzero(~done)[:, 0].tolist():  # stopped by the iteration cap
        answers[k].append(float(torch.clamp(s_log[k], *BOUNDS)))
    return answers
