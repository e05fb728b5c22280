"""Carry the JAX package's operands across to the port.

The smoother has no learned weights: what its kernels consume are the
state-space parameters (m0, S0, A, Q, C, r) and, for the fused NLL, the
per-lane scalar table. These helpers turn numpy copies of either into the
port's float32 tensors, so that a test can feed both packages identical
operands.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "scalar_table_from_numpy"]


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def params_from_numpy(m0, S0, A, Q, C, r, device: str | torch.device = "cpu",
                      dtype: torch.dtype = torch.float32) -> tuple:
    """Batched state-space parameters as tensors: m0 (N, D), S0/A/Q
    (N, D, D), C (N, O, D), r (N, O) or (N, T, O)."""
    return tuple(_tensor(a, device, dtype) for a in (m0, S0, A, Q, C, r))


def scalar_table_from_numpy(scal, device: str | torch.device = "cpu") -> torch.Tensor:
    """An (N, n_scal) scalar table in the layout of
    ``ops/pkalman.py::_scalar_offsets`` (the same as the JAX package's
    ``_pack_scalars``) as a contiguous float32 tensor."""
    scal = np.asarray(scal)
    if scal.ndim != 2:
        raise ValueError(f"expected an (N, n_scal) table, got shape {scal.shape}")
    return _tensor(scal, device)
