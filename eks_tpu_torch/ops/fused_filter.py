"""Kernels B and D: scans of filtering and smoothing elements over N lanes.

Replaces the Pallas scan kernels of ``eks_tpu/ops/pallas_filter.py``:
``_make_scan_kernel`` with the filter algebra (``filter_prefix_pallas``, the
forward filter of the final smoothing pass), with the smoother algebra
(``smoother_suffix_pallas``, its backward RTS pass) and with the paired
algebra (the scan's JVP), and ``_make_scan_kernel_batched`` (the same scans
over N lanes in one launch, plain and paired, which the staged optimizer
loss runs at more than eight observations). The CUDA source is
``eks_tpu_torch/csrc/prefix_scan.cu``: one kernel template, instantiated for
{filter, smoother} x {float, (primal, tangent) pairs} x D in {2, 3}, one
lane per thread block, so a single-lane scan is N = 1 of the lane-batched
one. The plain PyTorch versions beside it are the log-depth associative
scans of ``ops/pkalman.py`` and ``torch.func.jvp`` of them.

Every wrapper takes the plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from eks_tpu_torch.ops import cuda_build
from eks_tpu_torch.ops.pkalman import (
    _combine_filter,
    _combine_smoother,
    associative_scan,
    filter_state_dim,
    smoother_state_dim,
)

__all__ = [
    "LAUNCHES",
    "LAUNCHES_BY_INSTANCE",
    "filter_prefix",
    "filter_prefix_paired",
    "filter_prefix_plain",
    "smoother_suffix",
    "smoother_suffix_paired",
    "smoother_suffix_plain",
]

#: state dimensions the CUDA kernel is instantiated for (singlecam: 2; the
#: pupil and multi-camera families: 3)
_CUDA_D = (2, 3)

#: kernel launches since import (or since a caller last reset them): in all,
#: and of every instance by (kind, paired, D)
LAUNCHES = 0
LAUNCHES_BY_INSTANCE = {
    (kind, paired, D): 0
    for kind in ("filter", "smoother") for paired in (False, True) for D in _CUDA_D
}


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def filter_prefix_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, P, T) filtering elements -> their
    inclusive prefix combination along T."""
    filter_state_dim(planes.shape[-2])
    return associative_scan(_combine_filter, planes)


def smoother_suffix_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, P, T) smoothing elements in forward time
    order -> their inclusive suffix combination along T (step t holds the
    combination of elements t .. T-1)."""
    smoother_state_dim(planes.shape[-2])
    return associative_scan(_combine_smoother, planes, reverse=True)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def _lib():
    fn = cuda_build.load("prefix_scan").prefix_scan_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _scan_cuda(planes: torch.Tensor, kind: str, paired: bool) -> torch.Tensor:
    """Launch the (kind, paired) instance on (N, W * P, T) planes, W = 2 when
    paired (primal planes, then tangent planes)."""
    global LAUNCHES
    if planes.device.type != "cuda":
        raise ValueError(f"prefix_scan kernel takes a CUDA tensor, got {planes.device}")
    if planes.dtype != torch.float32:
        raise TypeError(f"prefix_scan kernel takes float32, got {planes.dtype}")
    if planes.ndim != 3 or not planes.is_contiguous():
        raise ValueError("prefix_scan kernel takes a contiguous (N, P, T) tensor")
    N, rows, T = planes.shape
    if paired and rows % 2:
        raise ValueError(f"paired planes hold P primal and P tangent planes, got {rows}")
    P = rows // 2 if paired else rows
    D = filter_state_dim(P) if kind == "filter" else smoother_state_dim(P)
    if D not in _CUDA_D:
        raise NotImplementedError(f"prefix_scan kernel is built for D in {_CUDA_D}, got D={D}")
    out = torch.empty((N, rows, T), dtype=torch.float32, device=planes.device)
    if N == 0 or T == 0:
        return out
    fn = _lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(planes.data_ptr(), out.data_ptr(), N, T, D, int(kind == "smoother"),
                int(paired), stream)
    if rc != 0:
        raise RuntimeError(f"prefix_scan kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_INSTANCE[(kind, paired, D)] += 1
    return out


def _dispatch(planes: torch.Tensor, kind: str, plain) -> torch.Tensor:
    if planes.device.type == "cuda":
        return _scan_cuda(planes, kind, False)
    if planes.device.type == "cpu":
        return plain(planes)
    raise RuntimeError(f"no prefix scan for device {planes.device}")


def _dispatch_paired(planes, tangents, kind: str, plain):
    if planes.device.type == "cuda":
        if tangents.shape != planes.shape or tangents.device != planes.device:
            raise ValueError("paired scan: planes and tangents must share shape and device")
        P = planes.shape[1]
        out = _scan_cuda(torch.cat([planes, tangents], dim=1), kind, True)
        return out[:, :P], out[:, P:]
    if planes.device.type == "cpu":
        return torch.func.jvp(plain, (planes,), (tangents,))
    raise RuntimeError(f"no prefix scan for device {planes.device}")


def filter_prefix(planes: torch.Tensor) -> torch.Tensor:
    """(N, P, T) filtering elements -> inclusive prefix along T: the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    return _dispatch(planes, "filter", filter_prefix_plain)


def smoother_suffix(planes: torch.Tensor) -> torch.Tensor:
    """(N, P, T) smoothing elements (E, g, L) in forward time order ->
    inclusive suffix along T; the kernel walks time backward by index."""
    return _dispatch(planes, "smoother", smoother_suffix_plain)


def filter_prefix_paired(planes: torch.Tensor, tangents: torch.Tensor):
    """(prefix, its tangent) of the filter scan along ``tangents``, both
    (N, P, T): on the card one launch on the (N, 2P, T) pairs."""
    return _dispatch_paired(planes, tangents, "filter", filter_prefix_plain)


def smoother_suffix_paired(planes: torch.Tensor, tangents: torch.Tensor):
    """(suffix, its tangent) of the smoother scan along ``tangents``."""
    return _dispatch_paired(planes, tangents, "smoother", smoother_suffix_plain)
