"""Carry the JAX package's operands across to the port.

The smoother has no learned weights: what its kernels consume are the
state-space parameters (m0, S0, A, Q, C, r) and, for the fused NLLs, the
per-lane scalar tables (constant R: ``_scalar_offsets``; time-varying R:
``_scalar_offsets_tv``), the multi-camera prep's state, and the smoother
scan's (E, g, L) planes. These helpers turn numpy copies of them into the
port's float32 tensors, so that a test can feed both packages identical
operands.
"""

from __future__ import annotations

import numpy as np
import torch

from eks_tpu_torch.ops.pkalman import _scalar_offsets_tv, _table_dims

__all__ = [
    "multicam_params_from_numpy",
    "params_from_numpy",
    "scalar_table_from_numpy",
    "smoother_planes_from_numpy",
    "tv_planes_from_numpy",
    "tv_scalar_table_from_numpy",
]


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def params_from_numpy(m0, S0, A, Q, C, r, device: str | torch.device = "cpu",
                      dtype: torch.dtype = torch.float32) -> tuple:
    """Batched state-space parameters as tensors: m0 (N, D), S0/A/Q
    (N, D, D), C (N, O, D), r (N, O) constant or (N, T, O) time-varying (the
    pupil family's D = 3, O = 8 included)."""
    return tuple(_tensor(a, device, dtype) for a in (m0, S0, A, Q, C, r))


def multicam_params_from_numpy(m0s, S0s, As, Qs, Cs, means, device: str | torch.device = "cpu") -> tuple:
    """The linear multi-camera prep's state, as the JAX package's
    ``_prep_multicam_linear`` returns it, as float32 tensors: m0s (K, L),
    S0s/As/Qs (K, L, L), Cs (K, 2C, L) and the centering means (C, K, 2)."""
    m0s, Cs = np.asarray(m0s), np.asarray(Cs)
    if m0s.ndim != 2 or Cs.ndim != 3 or Cs.shape[0] != m0s.shape[0] or Cs.shape[2] != m0s.shape[1]:
        raise ValueError(f"expected m0s (K, L) and Cs (K, 2C, L), got {m0s.shape} and {Cs.shape}")
    return tuple(_tensor(a, device) for a in (m0s, S0s, As, Qs, Cs, means))


def smoother_planes_from_numpy(E, g, L, device: str | torch.device = "cpu") -> torch.Tensor:
    """RTS smoothing elements E (N, T, D, D), g (N, T, D), L (N, T, D, D) in
    forward time order, as the (N, 2D² + D, T) float32 planes the smoother
    scan reads: E row-major, then g, then L row-major."""
    E, g, L = np.asarray(E), np.asarray(g), np.asarray(L)
    if g.ndim != 3 or E.shape != g.shape + g.shape[-1:] or L.shape != E.shape:
        raise ValueError(f"expected E, L (N, T, D, D) and g (N, T, D), got {E.shape}, {g.shape}, {L.shape}")
    N, T, _ = g.shape
    planes = np.concatenate([E.reshape(N, T, -1), g, L.reshape(N, T, -1)], axis=-1)
    return _tensor(np.ascontiguousarray(planes.transpose(0, 2, 1)), device)


def scalar_table_from_numpy(scal, device: str | torch.device = "cpu") -> torch.Tensor:
    """An (N, n_scal) scalar table in the layout of
    ``ops/pkalman.py::_scalar_offsets`` (the same as the JAX package's
    ``_pack_scalars``) as a contiguous float32 tensor."""
    scal = np.asarray(scal)
    if scal.ndim != 2:
        raise ValueError(f"expected an (N, n_scal) table, got shape {scal.shape}")
    return _tensor(scal, device)


def tv_scalar_table_from_numpy(scal, O: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """An (N, n_scal) time-varying-R scalar table for O observations, in the
    layout of ``ops/pkalman.py::_scalar_offsets_tv`` (the same as the JAX
    package's ``_pack_scalars_tv``: 84 floats at D = 3, O = 8), as a
    contiguous float32 tensor."""
    scal = np.asarray(scal)
    if scal.ndim != 2:
        raise ValueError(f"expected an (N, n_scal) table, got shape {scal.shape}")
    _table_dims(scal.shape[1], O, _scalar_offsets_tv)  # raises if the width fits no D
    return _tensor(scal, device)


def tv_planes_from_numpy(ys, r, device: str | torch.device = "cpu") -> torch.Tensor:
    """Observations ys and noise variances r, both (N, T, O), as the
    (N, 2O, T) float32 planes the time-varying-R NLL reads: the y planes,
    then the r planes."""
    ys, r = np.asarray(ys), np.asarray(r)
    if ys.ndim != 3 or ys.shape != r.shape:
        raise ValueError(f"expected ys and r of one (N, T, O) shape, got {ys.shape} and {r.shape}")
    planes = np.concatenate([ys.transpose(0, 2, 1), r.transpose(0, 2, 1)], axis=1)
    return _tensor(np.ascontiguousarray(planes), device)
