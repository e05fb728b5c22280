"""One module per family of configurations, found by the ``family`` key of
a configuration file: how a job calls the program's entry point and reads
its outputs, and how the plain reference (``reference/``) models the same
session. A family module has:

- ``call(eks, arr, cfg, smooth_param, device, timings)``: one job, the
  entry point's call on the (members, cameras, frames, keypoints, 3)
  array, returning what the entry point returns;
- ``outputs(ret, cfg)``: that return value, once the window has closed, as
  ``{"tables": (cameras, frames, keypoints, 9) array, "s": (keypoints,)}``;
- ``model(arr, cfg, p, device)``: the reference's ``Model`` of a session;
- ``package(model, means, covs, p)``: the reference's output tables from
  smoothed means (K, T, D) and covariances (K, T, D, D).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

#: the nine output columns of every camera table, per keypoint
COLUMNS = ("x", "y", "likelihood", "x_ens_median", "y_ens_median", "x_ens_var", "y_ens_var",
           "x_posterior_var", "y_posterior_var")


@dataclass
class Model:
    """A session as the reference sees it: the ensemble statistics
    (cameras, T, K, 5), each keypoint's linear-Gaussian state-space model
    (ys (K, T, O), m0 (K, D), S0, A, Q (K, D, D), C (K, O, D)), its
    per-step observation variances r (K, T, O), and what packaging needs."""
    stats: torch.Tensor
    ys: torch.Tensor
    m0: torch.Tensor
    S0: torch.Tensor
    A: torch.Tensor
    Q: torch.Tensor
    C: torch.Tensor
    r: torch.Tensor
    means: torch.Tensor


def load(name: str):
    return importlib.import_module(f"families.{name}")
