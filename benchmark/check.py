"""What decides ``correct``: the program's outputs against the plain
reference, as a few numbers, each with its limit.

For every session judged, the reference (``reference/``, float64) works out
the session's model again from the benchmark's own inputs, and reads the
program's outputs only to judge them:

- ``stats_gap``: the ensemble columns (likelihood, medians, variances),
  as the largest |program - reference| / (1 + |reference|);
- ``mean_gap``: the smoothed x and y, as the largest |program - reference|
  in posterior standard deviations (the square root of the reference's
  posterior variance column);
- ``var_gap``: the posterior variance columns, as the largest relative
  error |program - reference| / reference;
- ``s_gap`` (tuned s only): the largest distance in log s between the
  program's s of a keypoint and the nearest of the answers of the
  reference's replay of the optimizer (``reference/optimizer.py``), over
  ``SAMPLE`` keypoints drawn from the seed (the replay is an Adam loop of
  float64 parallel-scan filters, seconds a few lanes).

The smoothed columns are the reference's RTS smoother at the program's s.
A non-finite program value where the reference is finite is an infinite
gap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from families import load
from reference.kalman import kalman_filter, rts_smoother
from reference.optimizer import BOUNDS, constant_r, replay
from reference.precision import FLOAT64, Precision

#: columns of the output tables: the smoothed x, y; the ensemble statistics;
#: the posterior variances of x, y
MEANS, STATS, VARIANCES = [0, 1], [2, 3, 4, 5, 6], [7, 8]
#: keypoint lanes a run's s is replayed on
SAMPLE = 8


def sample_lanes(seed: int, n_lanes: int, k: int = SAMPLE) -> list[int]:
    """``k`` of ``n_lanes`` keypoint lanes, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence(seed % 2**64, spawn_key=(1,)))
    return sorted(rng.choice(n_lanes, size=min(k, n_lanes), replace=False).tolist())


def _cat(models, field):
    return torch.cat([getattr(m, field) for m in models])


def _split(models, x: torch.Tensor) -> list:
    out, k0 = [], 0
    for m in models:
        k1 = k0 + m.ys.shape[0]
        out.append(x[k0:k1])
        k0 = k1
    return out


def filter_pass(models, s: torch.Tensor, p: Precision):
    """The sequential filter over every keypoint lane of ``models``, each at
    its scale ``s`` with its per-step R: the filtered moments, for the
    smoother."""
    ys, m0, S0, A, Q, C, r = (_cat(models, f) for f in ("ys", "m0", "S0", "A", "Q", "C", "r"))
    _, ms, Ps = kalman_filter(ys, m0, S0, A, Q * s.to(p.dtype)[:, None, None], C, r, p, keep=ys.shape[0])
    return ms, Ps


def tuned_s(models, p: Precision, lanes: list[int] | None = None) -> list[list[float]]:
    """The reference's answers (log s) for the keypoint lanes ``lanes`` of
    ``models`` (all by default): the optimizer's replay, the lanes at once."""
    idx = slice(None) if lanes is None else torch.as_tensor(lanes, device=models[0].ys.device)
    model = [_cat(models, f)[idx] for f in ("ys", "m0", "S0", "A", "Q", "C")]
    r = _cat(models, "r")[idx]
    return replay(model + [constant_r(r)], r, p)


def smoothed_tables(fam, models, ms, Ps, s: torch.Tensor, p: Precision) -> list:
    """Each session's output tables from the RTS smoother at scales s."""
    A = _cat(models, "A")
    means, covs = rts_smoother(ms, Ps, A, _cat(models, "Q") * s.to(p.dtype)[:, None, None], p)
    return [fam.package(m, mu, cv, p) for m, mu, cv in zip(models, _split(models, means), _split(models, covs))]


def _gap(got: np.ndarray, ref: np.ndarray, scale: np.ndarray) -> float:
    """The largest |got - ref| / scale where ``ref`` is finite; infinite
    where ``got`` is not finite there."""
    both = np.isfinite(ref)
    if (both & ~np.isfinite(got)).any():
        return math.inf
    return float((np.abs(got[both] - ref[both]) / scale[both]).max(initial=0.0))


def gaps(got: np.ndarray, ref: np.ndarray) -> dict:
    """The three gaps of one session's tables (cameras, T, K, 9)."""
    sd = np.sqrt(ref[..., VARIANCES])
    return {
        "stats_gap": _gap(got[..., STATS], ref[..., STATS], 1.0 + np.abs(ref[..., STATS])),
        "mean_gap": _gap(got[..., MEANS], ref[..., MEANS], sd),
        "var_gap": _gap(got[..., VARIANCES], ref[..., VARIANCES], ref[..., VARIANCES]),
    }


def judge_sessions(cfg: dict, arrs: list, outputs: list, tuned: bool, device,
                   sample: list[int] | None = None) -> list[dict]:
    """The numbers compared, for each session of ``arrs`` and the program's
    ``outputs`` on it (``{"tables", "s"}`` each), all sessions in one pass
    of the reference; s on the keypoint lanes ``sample`` of all sessions
    together (all by default), and ``s_gap`` in each session that has one
    of them."""
    fam = load(cfg["family"])
    models = [fam.model(a, cfg, FLOAT64, device) for a in arrs]
    s = torch.as_tensor(np.concatenate([o["s"] for o in outputs]), dtype=torch.float64, device=device)
    ms, Ps = filter_pass(models, s, FLOAT64)
    refs = smoothed_tables(fam, models, ms, Ps, s, FLOAT64)
    out = []
    for o, ref in zip(outputs, refs):
        out.append(gaps(np.asarray(o["tables"], dtype=np.float64), ref.double().cpu().numpy()))
    if tuned:
        lanes = list(range(s.shape[0])) if sample is None else sample
        log_s = torch.clamp(torch.log(s), *BOUNDS).tolist()
        dist = torch.full((s.shape[0],), float("nan"), dtype=torch.float64)
        for k, ans in zip(lanes, tuned_s(models, FLOAT64, lanes)):
            dist[k] = min(abs(log_s[k] - a) for a in ans)
        for nums, d in zip(out, _split(models, dist)):
            if not bool(torch.isnan(d).all()):
                nums["s_gap"] = float(d[~torch.isnan(d)].max())
    return out


def judge(cfg: dict, arrs: list, outputs: list, tuned: bool, device, sample: list[int] | None = None) -> dict:
    """The numbers compared over all the sessions: each the largest."""
    per = judge_sessions(cfg, arrs, outputs, tuned, device, sample)
    keys = dict.fromkeys(k for p in per for k in p)
    return {k: max(p[k] for p in per if k in p) for k in keys}


def control_outputs(cfg: dict, arrs: list, smooth_param, p: Precision, device) -> list:
    """The reference put in the program's place at precision ``p``: its
    tables, and with ``smooth_param`` None its s, where its replay of the
    optimizer stops."""
    fam = load(cfg["family"])
    models = [fam.model(a, cfg, p, device) for a in arrs]
    if smooth_param is None:
        s = torch.exp(torch.tensor([ans[-1] for ans in tuned_s(models, p)], dtype=torch.float64, device=device))
    else:
        s = torch.full((sum(m.ys.shape[0] for m in models),), float(smooth_param), dtype=torch.float64,
                       device=device)
    ms, Ps = filter_pass(models, s, p)
    tables = smoothed_tables(fam, models, ms, Ps, s, p)
    return [{"tables": t.double().cpu().numpy(), "s": si.cpu().numpy()}
            for t, si in zip(tables, _split(models, s))]
