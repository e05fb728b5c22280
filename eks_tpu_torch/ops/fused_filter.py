"""Kernel B: inclusive prefix scan of filtering elements, one lane per block.

Replaces the Pallas prefix-scan kernel ``eks_tpu/ops/pallas_filter.py``
(``_make_scan_kernel`` with the filter algebra), which the final smoothing
pass reaches through ``filter_prefix_pallas``. The CUDA source is
``eks_tpu_torch/csrc/prefix_scan.cu``; the plain PyTorch version beside it is
the log-depth associative scan of ``ops/pkalman.py``.

``filter_prefix`` takes the plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from eks_tpu_torch.ops import cuda_build
from eks_tpu_torch.ops.pkalman import _combine_filter, associative_scan, filter_state_dim

__all__ = ["LAUNCHES", "LAUNCHES_BY_D", "filter_prefix", "filter_prefix_plain"]

#: kernel launches since import (or since a caller last reset it), in all
#: and by the state dimension of the instance launched
LAUNCHES = 0
LAUNCHES_BY_D = {2: 0, 3: 0}

#: state dimensions the CUDA kernel is instantiated for (the singlecam
#: path's and the pupil path's)
_CUDA_D = (2, 3)


def filter_prefix_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, P, T) filtering elements -> their
    inclusive prefix combination along T."""
    filter_state_dim(planes.shape[-2])
    return associative_scan(_combine_filter, planes)


def _lib():
    lib = cuda_build.load("prefix_scan")
    fn = lib.prefix_scan_filter_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _filter_prefix_cuda(planes: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if planes.device.type != "cuda":
        raise ValueError(f"prefix_scan kernel takes a CUDA tensor, got {planes.device}")
    if planes.dtype != torch.float32:
        raise TypeError(f"prefix_scan kernel takes float32, got {planes.dtype}")
    if planes.ndim != 3 or not planes.is_contiguous():
        raise ValueError("prefix_scan kernel takes a contiguous (N, P, T) tensor")
    N, P, T = planes.shape
    D = filter_state_dim(P)
    if D not in _CUDA_D:
        raise NotImplementedError(f"prefix_scan kernel is built for D in {_CUDA_D}, got D={D}")
    out = torch.empty((N, P, T), dtype=torch.float32, device=planes.device)
    if N == 0 or T == 0:
        return out
    fn = _lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(planes.data_ptr(), out.data_ptr(), N, T, D, stream)
    if rc != 0:
        raise RuntimeError(f"prefix_scan kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_D[D] += 1
    return out


def filter_prefix(planes: torch.Tensor) -> torch.Tensor:
    """(N, P, T) filtering elements -> inclusive prefix along T: kernel B on
    a CUDA tensor, the plain version on a CPU tensor."""
    if planes.device.type == "cuda":
        return _filter_prefix_cuda(planes)
    if planes.device.type == "cpu":
        return filter_prefix_plain(planes)
    raise RuntimeError(f"no prefix scan for device {planes.device}")
