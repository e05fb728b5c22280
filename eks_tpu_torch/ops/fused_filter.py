"""Kernels B and D: scans of filtering and smoothing elements over N lanes.

Replaces the Pallas scan kernels of ``eks_tpu/ops/pallas_filter.py``:
``_make_scan_kernel`` with the filter algebra (``filter_prefix_pallas``, the
forward filter of the final smoothing pass), with the smoother algebra
(``smoother_suffix_pallas``, its backward RTS pass) and with the paired
algebra (the scan's JVP), and ``_make_scan_kernel_batched`` (the same scans
over N lanes in one launch, plain and paired, which the staged optimizer
loss runs at more than eight observations). The CUDA source is
``eks_tpu_torch/csrc/prefix_scan.cu``: one kernel template, instantiated for
{filter, smoother} x {float, (primal, tangent) pairs} x D in {1, 2, 3}, so a
single-lane scan is N = 1 of the lane-batched one. Each lane is cut into G
segments, one thread block each (``segment_partition`` picks G from the
lanes, the steps and the card's SM count), and a call runs a deterministic
three-phase segmented scan through an (N, G, W * P) scratch buffer that the
wrapper allocates. The plain PyTorch versions beside it are the log-depth
associative scans of ``ops/pkalman.py`` and ``torch.func.jvp`` of them.

Every wrapper takes the plain version for a tensor on the CPU. For a CUDA
tensor at D <= 3 it launches the kernel or raises: a failed build or launch
is never answered with the plain version. Beyond D = 3 the JAX package has no
Pallas scan (``_use_pallas``) and runs XLA's ``associative_scan``; the port
follows that dispatch by shape and runs the plain version on the card,
counted in ``PLAIN_ROUTE_LAUNCHES`` (the multi-camera family at
``n_latent`` 4 and above).

The carry combine of a time-sharded scan (``carry_combine``, the second
entry of ``prefix_scan.cu``) combines every step of one shard's locally
scanned chunk with the combination of the chunks before it in scan order;
``parallel/mesh.py`` builds the sharded scans from it. It replaces no
Pallas kernel: the JAX package carries those combines with XLA collectives.
Beyond D = 3 it follows the scans' dispatch, the plain version on the card,
counted apart in ``CARRY_PLAIN_ROUTE_LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from eks_tpu_torch.ops import cuda_build
from eks_tpu_torch.ops.linalg import jvp
from eks_tpu_torch.ops.pkalman import (
    _combine_filter,
    _combine_smoother,
    associative_scan,
    filter_state_dim,
    smoother_state_dim,
)

__all__ = [
    "CARRY_LAUNCHES_BY_INSTANCE",
    "LAUNCHES",
    "LAUNCHES_BY_INSTANCE",
    "CARRY_PLAIN_ROUTE_LAUNCHES",
    "PLAIN_ROUTE_LAUNCHES",
    "carry_combine",
    "carry_combine_paired",
    "carry_combine_plain",
    "check_scratch",
    "filter_prefix",
    "filter_prefix_paired",
    "filter_prefix_plain",
    "scan_plan",
    "segment_partition",
    "sm_count",
    "smoother_suffix",
    "smoother_suffix_paired",
    "smoother_suffix_plain",
]

#: state dimensions the CUDA kernel is instantiated for (singlecam: 2; the
#: pupil and multi-camera families: 3; multi-camera at n_latent 1 and 2: 1, 2)
_CUDA_D = (1, 2, 3)

#: kernel launches since import (or since a caller last reset them): in all,
#: and of every instance by (kind, paired, D)
LAUNCHES = 0
LAUNCHES_BY_INSTANCE = {
    (kind, paired, D): 0
    for kind in ("filter", "smoother") for paired in (False, True) for D in _CUDA_D
}
#: scans of CUDA tensors beyond D = 3, run by the plain version on the card
PLAIN_ROUTE_LAUNCHES = 0
#: carry-combine kernel launches of every instance by (kind, paired, D)
CARRY_LAUNCHES_BY_INSTANCE = dict.fromkeys(LAUNCHES_BY_INSTANCE, 0)
#: carry combines of CUDA tensors beyond D = 3, run by the plain version
CARRY_PLAIN_ROUTE_LAUNCHES = 0


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
# the lane x segment grid
# --------------------------------------------------------------------------- #
def segment_partition(N: int, T: int, sms: int, min_steps: int, max_steps: int) -> tuple:
    """(G, L): each of N lanes' T steps cut into G contiguous segments of L
    steps (the last may be shorter, none is empty), one thread block each.

    Aims at two blocks per SM in one wave, G = floor(2 sms / N) (a ceiling
    would leave a few blocks for a second wave), with no segment shorter
    than ``min_steps`` unless the lane is, and at least enough segments that
    none is longer than ``max_steps`` (what one block stages in shared
    memory). A pure function of its arguments."""
    if min(N, T, sms, min_steps) < 1 or max_steps < min_steps:
        raise ValueError(f"segment_partition: bad arguments {(N, T, sms, min_steps, max_steps)}")
    G = min(max(2 * sms // N, 1), -(-T // min_steps))
    G = max(G, -(-T // max_steps))
    L = -(-T // G)
    return -(-T // L), L


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def check_scratch(name: str, x: torch.Tensor, shape: tuple, device=None) -> None:
    """Raise ValueError unless ``x`` is a contiguous float32 ``shape`` tensor
    (on ``device``, when given): a kernel's scratch buffer."""
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(
            f"{name} scratch must be contiguous float32 {tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} scratch must be on {device}, got {x.device}")


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def _lib():
    lib = cuda_build.load("prefix_scan")
    fn = lib.prefix_scan_f32
    if fn.argtypes is None:  # the scan's argtypes last: a thread that sees them sees the others
        geo = lib.prefix_scan_geometry
        geo.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        geo.restype = ctypes.c_int
        carry = lib.carry_combine_f32
        carry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        carry.restype = ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


_GEOMETRY: dict = {}


def _geometry(kind: str, paired: bool, D: int) -> tuple:
    """(threads per block, most steps per segment) of an instance."""
    key = (kind, paired, D)
    if key not in _GEOMETRY:
        threads, max_steps = ctypes.c_int(), ctypes.c_int()
        rc = _lib().prefix_scan_geometry(D, int(kind == "smoother"), int(paired),
                                         ctypes.byref(threads), ctypes.byref(max_steps))
        if rc != 0:
            raise RuntimeError(f"prefix_scan has no instance {key} (CUDA error {rc})")
        _GEOMETRY[key] = (threads.value, max_steps.value)
    return _GEOMETRY[key]


_PLANS: dict = {}


def scan_plan(N: int, T: int, kind: str, paired: bool, D: int, device: torch.device) -> dict:
    """The launch geometry of an (N, ., T) scan on ``device``: segments per
    lane G, steps per segment L, threads per block. Kept per shape, instance
    and device: an optimizer asks for the same one every iteration."""
    key = (N, T, kind, paired, D, device.index)
    plan = _PLANS.get(key)
    if plan is None:
        threads, max_steps = _geometry(kind, paired, D)
        G, L = segment_partition(N, T, sm_count(device), threads, max_steps)
        plan = _PLANS[key] = {"G": G, "L": L, "threads": threads}
    return plan


def _scan_cuda(planes: torch.Tensor, kind: str, paired: bool, scratch=None) -> torch.Tensor:
    """Launch the (kind, paired) instance on (N, W * P, T) planes, W = 2 when
    paired (primal planes, then tangent planes). ``scratch``, (N, G, W * P)
    float32, is checked when given, else allocated here."""
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
    D = _state_dim(rows // 2 if paired else rows, kind)
    if D not in _CUDA_D:
        raise NotImplementedError(f"prefix_scan kernel is built for D in {_CUDA_D}, got D={D}")
    out = torch.empty((N, rows, T), dtype=torch.float32, device=planes.device)
    if N == 0 or T == 0:
        return out
    G = scan_plan(N, T, kind, paired, D, planes.device)["G"]
    if scratch is None:
        scratch = torch.empty((N, G, rows), dtype=torch.float32, device=planes.device)
    else:
        check_scratch("prefix_scan", scratch, (N, G, rows), planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().prefix_scan_f32(planes.data_ptr(), out.data_ptr(), scratch.data_ptr(), N, T, D,
                                    int(kind == "smoother"), int(paired), G, stream)
    if rc != 0:
        raise RuntimeError(f"prefix_scan kernel launch failed with CUDA error {rc}")
    with cuda_build.COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_INSTANCE[(kind, paired, D)] += 1
    return out


def _state_dim(n_planes: int, kind: str) -> int:
    return filter_state_dim(n_planes) if kind == "filter" else smoother_state_dim(n_planes)


def _plain_route(planes: torch.Tensor, kind: str, carry: bool = False) -> bool:
    """Whether a CUDA scan (or with ``carry``, a carry combine) takes the
    plain version by shape: D > 3, where the JAX package runs XLA's
    associative scan. Counted when it does."""
    global PLAIN_ROUTE_LAUNCHES, CARRY_PLAIN_ROUTE_LAUNCHES
    if _state_dim(planes.shape[-2], kind) <= max(_CUDA_D):
        return False
    with cuda_build.COUNT_LOCK:
        if carry:
            CARRY_PLAIN_ROUTE_LAUNCHES += 1
        else:
            PLAIN_ROUTE_LAUNCHES += 1
    return True


def _dispatch(planes: torch.Tensor, kind: str, plain) -> torch.Tensor:
    if planes.device.type == "cuda":
        return plain(planes) if _plain_route(planes, kind) else _scan_cuda(planes, kind, False)
    if planes.device.type == "cpu":
        return plain(planes)
    raise RuntimeError(f"no prefix scan for device {planes.device}")


def _dispatch_paired(planes, tangents, kind: str, plain):
    if planes.device.type == "cuda":
        if tangents.shape != planes.shape or tangents.device != planes.device:
            raise ValueError("paired scan: planes and tangents must share shape and device")
        if _plain_route(planes, kind):
            return jvp(plain, (planes,), (tangents,))
        P = planes.shape[1]
        out = _scan_cuda(torch.cat([planes, tangents], dim=1), kind, True)
        return out[:, :P], out[:, P:]
    if planes.device.type == "cpu":
        return jvp(plain, (planes,), (tangents,))
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


# --------------------------------------------------------------------------- #
# the carry combine of a time-sharded scan
# --------------------------------------------------------------------------- #
def carry_combine_plain(carry: torch.Tensor, local: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain PyTorch version: every step of the (N, P, T) chunk ``local``
    combined with the (N, P) ``carry``, the combination of the chunks before
    it in scan order: ``_combine_filter(carry, local_t)`` for the filter,
    ``_combine_smoother(carry, local_t)`` for the smoother (the carry holds
    the chunks later in time)."""
    combine = _combine_filter if kind == "filter" else _combine_smoother
    return combine(carry[..., None].expand_as(local), local)


def _carry_cuda(carry: torch.Tensor, local: torch.Tensor, kind: str, paired: bool) -> torch.Tensor:
    """Launch the carry kernel's (kind, paired) instance: ``carry`` (N, W * P)
    and ``local`` (N, W * P, T), W = 2 when paired (primal, then tangent)."""
    if local.dtype != torch.float32 or carry.dtype != torch.float32:
        raise TypeError("carry_combine kernel takes float32")
    if local.ndim != 3 or not local.is_contiguous() or not carry.is_contiguous():
        raise ValueError("carry_combine kernel takes a contiguous (N, P, T) chunk and (N, P) carry")
    N, rows, T = local.shape
    if tuple(carry.shape) != (N, rows) or carry.device != local.device:
        raise ValueError(f"carry must be ({N}, {rows}) on {local.device}, got {tuple(carry.shape)} on {carry.device}")
    if paired and rows % 2:
        raise ValueError(f"paired planes hold P primal and P tangent planes, got {rows}")
    D = _state_dim(rows // 2 if paired else rows, kind)
    if D not in _CUDA_D:
        raise NotImplementedError(f"carry_combine kernel is built for D in {_CUDA_D}, got D={D}")
    out = torch.empty_like(local)
    if N == 0 or T == 0:
        return out
    with torch.cuda.device(local.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().carry_combine_f32(carry.data_ptr(), local.data_ptr(), out.data_ptr(), N, T, D,
                                      int(kind == "smoother"), int(paired), stream)
    if rc != 0:
        raise RuntimeError(f"carry_combine kernel launch failed with CUDA error {rc}")
    with cuda_build.COUNT_LOCK:
        CARRY_LAUNCHES_BY_INSTANCE[(kind, paired, D)] += 1
    return out


def carry_combine(carry: torch.Tensor, local: torch.Tensor, kind: str) -> torch.Tensor:
    """(N, P, T) chunk ``local`` combined step by step with the (N, P)
    ``carry``: the kernel on a CUDA tensor (the plain version beyond D = 3,
    counted in ``CARRY_PLAIN_ROUTE_LAUNCHES``), the plain version on a CPU
    tensor."""
    if local.device.type == "cuda":
        if _plain_route(local, kind, carry=True):
            return carry_combine_plain(carry, local, kind)
        return _carry_cuda(carry, local, kind, False)
    if local.device.type == "cpu":
        return carry_combine_plain(carry, local, kind)
    raise RuntimeError(f"no carry combine for device {local.device}")


def carry_combine_paired(carry, dcarry, local, dlocal, kind: str):
    """(combined, its tangent) of ``carry_combine`` along the tangents
    ``dcarry`` and ``dlocal``: on the card one launch on the pairs."""
    def plain(c, x):
        return carry_combine_plain(c, x, kind)

    if local.device.type == "cuda":
        if _plain_route(local, kind, carry=True):
            return jvp(plain, (carry, local), (dcarry, dlocal))
        P = local.shape[1]
        out = _carry_cuda(torch.cat([carry, dcarry], dim=1).contiguous(),
                          torch.cat([local, dlocal], dim=1), kind, True)
        return out[:, :P], out[:, P:]
    if local.device.type == "cpu":
        return jvp(plain, (carry, local), (dcarry, dlocal))
    raise RuntimeError(f"no carry combine for device {local.device}")
