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
counted as ``("scan_plain_route", kind)`` (the multi-camera family at
``n_latent`` 4 and above).

A chunk of a time-sharded scan (``parallel/mesh.py``) runs the same three
launches in two phases: ``chunk_total`` (phase A: the reduce over every
segment and the totals launch, which also writes the chunk's total in scan
order) and ``chunk_scan`` (phase B: the downsweep from the carry of the
chunks before it in scan order, which the host combines from their totals in
between); ``scan_total`` and ``scan_carried`` are the two in one call. This
replaces no Pallas kernel: the JAX package carries those combines with XLA
collectives. Beyond D = 3 it follows the scans' dispatch, the plain version on
the card, its carry combine counted apart (``("scan_carried_plain_route",
kind)``).

Every launch is counted in ``tracing.LAUNCHES``: ``("scan", kind, paired,
D)``, a carried downsweep also as ``("scan_carried", kind, paired, D)``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from eks_tpu_torch import tracing
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
    "ChunkTotal",
    "carry_combine_plain",
    "check_scratch",
    "chunk_scan",
    "chunk_total",
    "filter_prefix",
    "filter_prefix_paired",
    "filter_prefix_plain",
    "scan_carried",
    "scan_carried_plain",
    "scan_plan",
    "scan_total",
    "scan_total_plain",
    "segment_partition",
    "sm_count",
    "smoother_suffix",
    "smoother_suffix_paired",
    "smoother_suffix_plain",
]

#: state dimensions the CUDA kernel is instantiated for (singlecam: 2; the
#: pupil and multi-camera families: 3; multi-camera at n_latent 1 and 2: 1, 2)
_CUDA_D = (1, 2, 3)


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
        for entry, n_ptrs in (("prefix_scan_total_f32", 3), ("prefix_scan_carried_f32", 4)):
            f = getattr(lib, entry)
            f.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            f.restype = ctypes.c_int
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


def _instance(planes: torch.Tensor, kind: str, paired: bool) -> tuple:
    """(N, W * P, T, D) of planes the kernel takes, W = 2 when paired
    (primal planes, then tangent planes); raises on any it does not."""
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
    return N, rows, T, D


def _call(entry: str, device: torch.device, ptrs: tuple, N: int, T: int, D: int, kind: str, paired: bool,
          G: int) -> None:
    """Run one of the library's entries on ``device``'s current stream."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_lib(), entry)(*ptrs, N, T, D, int(kind == "smoother"), int(paired), G, stream)
    if rc != 0:
        raise RuntimeError(f"prefix_scan kernel launch ({entry}) failed with CUDA error {rc}")


def _count(kind: str, paired: bool, D: int, carried: bool = False) -> None:
    tracing.count(("scan", kind, paired, D))
    if carried:
        tracing.count(("scan_carried", kind, paired, D))


def _scan_cuda(planes: torch.Tensor, kind: str, paired: bool, scratch=None) -> torch.Tensor:
    """Launch the (kind, paired) instance on (N, W * P, T) planes, W = 2 when
    paired (primal planes, then tangent planes). ``scratch``, (N, G, W * P)
    float32, is checked when given, else allocated here."""
    N, rows, T, D = _instance(planes, kind, paired)
    out = torch.empty((N, rows, T), dtype=torch.float32, device=planes.device)
    if N == 0 or T == 0:
        return out
    G = scan_plan(N, T, kind, paired, D, planes.device)["G"]
    if scratch is None:
        scratch = torch.empty((N, G, rows), dtype=torch.float32, device=planes.device)
    else:
        check_scratch("prefix_scan", scratch, (N, G, rows), planes.device)
    _call("prefix_scan_f32", planes.device, (planes.data_ptr(), out.data_ptr(), scratch.data_ptr()), N, T, D,
          kind, paired, G)
    _count(kind, paired, D)
    return out


def _state_dim(n_planes: int, kind: str) -> int:
    return filter_state_dim(n_planes) if kind == "filter" else smoother_state_dim(n_planes)


def _plain_route(planes: torch.Tensor, kind: str) -> bool:
    """Whether a CUDA scan takes the plain version by shape: D > 3, where
    the JAX package runs XLA's associative scan. Counted when it does."""
    if _state_dim(planes.shape[-2], kind) <= max(_CUDA_D):
        return False
    tracing.count(("scan_plain_route", kind))
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
# a chunk of a time-sharded scan, from its carry-in
# --------------------------------------------------------------------------- #
_PLAIN = {"filter": filter_prefix_plain, "smoother": smoother_suffix_plain}
#: the time step that holds a chunk's total in scan order
_EDGE = {"filter": -1, "smoother": 0}


def carry_combine_plain(carry: torch.Tensor, local: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain PyTorch version: every step of the (N, P, T) chunk ``local``
    combined with the (N, P) ``carry``, the combination of the chunks before
    it in scan order: ``_combine_filter(carry, local_t)`` for the filter,
    ``_combine_smoother(carry, local_t)`` for the smoother (the carry holds
    the chunks later in time)."""
    combine = _combine_filter if kind == "filter" else _combine_smoother
    return combine(carry[..., None].expand_as(local), local)


def scan_total_plain(planes: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain PyTorch version of ``scan_total``: the (N, P) edge of the
    chunk's plain scan, its last step for the filter, its first for the
    smoother."""
    return _PLAIN[kind](planes)[..., _EDGE[kind]]


def scan_carried_plain(planes: torch.Tensor, carry: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain PyTorch version of ``scan_carried``: the chunk's plain scan,
    every step combined with ``carry``."""
    return carry_combine_plain(carry, _PLAIN[kind](planes), kind)


@dataclass
class ChunkTotal:
    """Phase A of a chunk's carried scan, kept for its phase B
    (``chunk_scan``). ``total`` is the chunk's total in scan order, (N, P),
    or with tangents the pair (total, its tangent). On the card phase B reads
    ``planes``, (N, W * P, T) (paired: the primal planes, then the tangent
    planes, packed by the one ``cat``), and ``scratch``, the (N, G, W * P)
    prefixes of the segment totals; on the plain route, ``local``, the
    chunk's own scan (a pair with tangents)."""

    kind: str
    paired: bool
    total: object
    planes: torch.Tensor | None = None
    scratch: torch.Tensor | None = None
    D: int = 0
    G: int = 0
    local: object = None


def _total_cuda(packed: torch.Tensor, kind: str, paired: bool) -> ChunkTotal:
    """Phase A on the card: the reduce over every segment and the totals
    launch, which writes the chunk's total."""
    N, rows, T, D = _instance(packed, kind, paired)
    G = scan_plan(N, T, kind, paired, D, packed.device)["G"] if N else 0
    total = torch.empty((N, rows), dtype=torch.float32, device=packed.device)
    scratch = torch.empty((N, G, rows), dtype=torch.float32, device=packed.device)
    if N:
        _call("prefix_scan_total_f32", packed.device, (packed.data_ptr(), scratch.data_ptr(), total.data_ptr()),
              N, T, D, kind, paired, G)
    P = rows // 2 if paired else rows
    return ChunkTotal(kind, paired, (total[:, :P], total[:, P:]) if paired else total, planes=packed,
                      scratch=scratch, D=D, G=G)


def chunk_total(planes: torch.Tensor, kind: str, tangents: torch.Tensor | None = None) -> ChunkTotal:
    """Phase A of the carried scan of one chunk, (N, P, T) filtering or
    smoothing elements in forward time order (with ``tangents``, the paired
    scan along them): on a CUDA tensor at D <= 3 two launches that leave
    the chunk's total and what phase B reads; else the plain scan, whose
    edge is the total (beyond D = 3 on the card counted in
    ``("scan_plain_route", kind)``)."""
    paired = tangents is not None
    if planes.shape[-1] < 1:
        raise ValueError("a chunk holds at least one step")
    if planes.device.type == "cuda":
        if paired and (tangents.shape != planes.shape or tangents.device != planes.device):
            raise ValueError("paired scan: planes and tangents must share shape and device")
        if not _plain_route(planes, kind):
            return _total_cuda(torch.cat([planes, tangents], dim=1) if paired else planes, kind, paired)
    elif planes.device.type != "cpu":
        raise RuntimeError(f"no prefix scan for device {planes.device}")
    plain, edge = _PLAIN[kind], _EDGE[kind]
    local = jvp(plain, (planes,), (tangents,)) if paired else plain(planes)
    total = tuple(x[..., edge] for x in local) if paired else local[..., edge]
    return ChunkTotal(kind, paired, total, local=local)


def chunk_scan(chunk: ChunkTotal, carry=None):
    """Phase B: the chunk scanned from ``carry``, the combination of the
    chunks before it in scan order, (N, P) (with tangents the pair (carry,
    its tangent)), or from nothing (None: the first chunk in scan order).
    On the card one launch, the downsweep, counted as the chunk's scan (and
    with a carry as ``("scan_carried", kind, paired, D)``); returns (N, P, T), or
    with tangents the pair (scan, its tangent)."""
    kind, paired = chunk.kind, chunk.paired
    if chunk.planes is None:
        if carry is None:
            return chunk.local
        local = chunk.local[0] if paired else chunk.local
        if local.device.type == "cuda":  # beyond D = 3
            tracing.count(("scan_carried_plain_route", kind))

        def plain(c, x):
            return carry_combine_plain(c, x, kind)

        return jvp(plain, (carry[0], chunk.local[0]), (carry[1], chunk.local[1])) if paired else plain(carry, local)
    planes = chunk.planes
    N, rows, T = planes.shape
    if carry is not None:
        carry = torch.cat(carry, dim=1) if paired else carry
        if carry.dtype != torch.float32:
            raise TypeError(f"prefix_scan kernel takes a float32 carry, got {carry.dtype}")
        if tuple(carry.shape) != (N, rows) or carry.device != planes.device or not carry.is_contiguous():
            raise ValueError(f"the carry must be contiguous ({N}, {rows}) on {planes.device}, "
                             f"got {tuple(carry.shape)} on {carry.device}")
    out = torch.empty_like(planes)
    if N:
        _call("prefix_scan_carried_f32", planes.device,
              (planes.data_ptr(), out.data_ptr(), chunk.scratch.data_ptr(), None if carry is None else carry.data_ptr()),
              N, T, chunk.D, kind, paired, chunk.G)
        _count(kind, paired, chunk.D, carried=carry is not None)
    if paired:
        P = rows // 2
        return out[:, :P], out[:, P:]
    return out


def scan_total(planes: torch.Tensor, kind: str, tangents: torch.Tensor | None = None):
    """The total in scan order of the (N, P, T) chunk ``planes``, (N, P),
    or with ``tangents`` the pair (total, its tangent): phase A alone."""
    return chunk_total(planes, kind, tangents).total


def scan_carried(planes: torch.Tensor, carry, kind: str, tangents: torch.Tensor | None = None, dcarry=None):
    """The (N, P, T) chunk ``planes`` scanned from the (N, P) ``carry``, or
    with ``tangents`` the pair (scan, its tangent) from the carry and its
    tangent ``dcarry``: phase A, then phase B on its prefixes."""
    chunk = chunk_total(planes, kind, tangents)
    return chunk_scan(chunk, carry if tangents is None else (carry, dcarry))
