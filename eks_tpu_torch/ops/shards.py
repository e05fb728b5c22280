"""Shards over a mesh: the lane split, the time shards and the sharded scans.

A mesh is a tuple of ``torch.device``; it may name one device more than
once, which is how eight shards run on the CPU in the tests and four shards
on one card. The single-device path is one shard of the same code: a whole
sequence on one device is ``TimeShards`` with one chunk, whose scan is the
kernel's own scan.

Lanes (``split_leading``): the leading axis cut by ``torch.tensor_split``
(uneven shards, no padding lanes), each shard on its device; ``core`` runs
the keypoint axis through it.

Time (``TimeShards``): the frame axis cut into nearly equal chunks, one a
shard. Each chunk's elements are built on its device and scanned there by
the scan kernel in two phases (``filter_prefix_sharded`` and
``smoother_suffix_sharded``, float and paired): phase A of every chunk gives
its total (``fused_filter.chunk_total``), the totals (``N x W*P`` floats
each) travel with ``Tensor.to`` to be combined in scan order by the
algebra's plain combine (the filter's in matrix form), and phase B scans
every chunk from its carry (``fused_filter.chunk_scan``), with no pass of
its own for the carry. The JAX package instead lets the SPMD partitioner put
collectives into XLA's ``associative_scan``.

Every shard runs in turn on the calling thread with its device current
(``map_shards``): on a host with several cards the asynchronous launches let
the cards overlap. One host thread per card measured slower on four H100s
(the threads take turns at the interpreter lock), so there is none.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from eks_tpu_torch.ops import fused_filter
from eks_tpu_torch.ops.linalg import jvp
from eks_tpu_torch.ops.pkalman import _combine_filter_mats, _combine_smoother, filter_state_dim

__all__ = [
    "TimeShards",
    "emission_on",
    "filter_prefix_paired_sharded",
    "filter_prefix_sharded",
    "make_mesh",
    "map_shards",
    "smoother_suffix_paired_sharded",
    "smoother_suffix_sharded",
    "split_leading",
]

Mesh = tuple  # of torch.device


def make_mesh(n_devices: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` devices of ``device``'s type.

    For CUDA it is ``cuda:0 … cuda:n-1`` (every visible card when
    ``n_devices`` is None), and it raises ``ValueError`` when the host has
    fewer cards. It never puts shards on the CPU: the JAX package falls back
    to CPU devices when its platform has too few, which would hide the card.
    For the CPU it is ``(cpu,) * n_devices``, whose shards run one after
    another (the counterpart of the JAX tests' virtual CPU devices)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return (torch.device("cpu"),) * (1 if n_devices is None else int(n_devices))
    if dev.type != "cuda":
        raise ValueError(f"no mesh of {dev.type} devices")
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = available if n_devices is None else int(n_devices)
    if n < 1 or available < n:
        raise ValueError(f"requested {n} devices but only {available} available")
    return tuple(torch.device("cuda", i) for i in range(n))


# --------------------------------------------------------------------------- #
# the shards in turn on the calling thread
# --------------------------------------------------------------------------- #
def map_shards(fn, devices, *per_shard) -> list:
    """``[fn(i, *(x[i] for x in per_shard)) for i in shards]``, in turn on
    the calling thread, shard i with ``devices[i]`` as the current device.
    Launches are asynchronous, so shards on distinct cards overlap on the
    devices as far as the host's dispatch lets them."""
    out = []
    for i, dev in enumerate(torch.device(d) for d in devices):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            out.append(fn(i, *(x[i] for x in per_shard)))
    return out


# --------------------------------------------------------------------------- #
# lanes
# --------------------------------------------------------------------------- #
def split_leading(mesh: Mesh, operands: list) -> tuple[list, list]:
    """Every operand's leading axis split over the mesh by
    ``torch.tensor_split`` (None stays None), keeping only the non-empty
    shards: (their devices, per shard the list of its operand slices)."""
    n = len(mesh)
    parts = [torch.tensor_split(x, n) if x is not None else (None,) * n for x in operands]
    keep = [i for i in range(n) if parts[0][i].shape[0] > 0]
    devices = [mesh[i] for i in keep]
    return devices, [[None if p[i] is None else p[i].to(mesh[i]) for p in parts] for i in keep]


def emission_on(h_fn, device: torch.device):
    """The emission ``h_fn`` with its tensors on ``device``: a
    ``functools.partial`` over tensors (the camera projector) is rebuilt
    there; any other emission is returned as it is."""
    if (isinstance(h_fn, functools.partial) and not h_fn.keywords
            and all(torch.is_tensor(a) for a in h_fn.args)):
        return functools.partial(h_fn.func, *(a.to(device) for a in h_fn.args))
    return h_fn


# --------------------------------------------------------------------------- #
# time
# --------------------------------------------------------------------------- #
class TimeShards:
    """A sequence of T steps cut into nearly equal chunks, chunk i on
    ``devices[i]`` (``torch.tensor_split``'s sizes; no chunk is empty, so a
    sequence shorter than the mesh takes fewer shards)."""

    def __init__(self, mesh: Mesh, T: int):
        sizes = [len(c) for c in np.array_split(np.arange(T), len(mesh))]
        keep = [i for i, n in enumerate(sizes) if n > 0]
        self.devices = tuple(torch.device(mesh[i]) for i in keep)
        starts = np.concatenate([[0], np.cumsum([sizes[i] for i in keep])])
        self.bounds = tuple((int(a), int(b)) for a, b in zip(starts[:-1], starts[1:]))

    def __len__(self) -> int:
        return len(self.devices)

    def split(self, x: torch.Tensor, dim: int) -> list:
        """``x`` cut along its time axis ``dim``, chunk i on device i."""
        return [x.narrow(dim, a, b - a).to(d) for d, (a, b) in zip(self.devices, self.bounds)]

    def replicate(self, x) -> list:
        """``x`` on every shard's device (None stays None)."""
        return [None if x is None else x.to(d) for d in self.devices]

    def map(self, fn, *per_shard) -> list:
        """``map_shards`` over these shards."""
        return map_shards(fn, self.devices, *per_shard)

    def gather(self, chunks: list, dim: int, device) -> torch.Tensor:
        """The chunks joined along ``dim`` on ``device``."""
        return torch.cat([c.to(device) for c in chunks], dim=dim)

    def total(self, parts: list, device) -> torch.Tensor:
        """The sum of per-shard partial results on ``device``, in shard order."""
        out = parts[0].to(device)
        for p in parts[1:]:
            out = out + p.to(device)
        return out


def _carries(totals: list, combine) -> list:
    """Per chunk, in scan order, the combination of the chunk totals before
    it (None for the first), on the first chunk's device. A total is a tuple:
    (total,) or (total, its tangent)."""
    home = totals[0][0].device
    carries, acc = [None], None
    for tot in totals[:-1]:
        tot = tuple(x.to(home) for x in tot)
        acc = tot if acc is None else combine(acc, tot)
        carries.append(acc)
    return carries


def _combine_filter_totals(earlier: torch.Tensor, later: torch.Tensor) -> torch.Tensor:
    """The filter algebra's combine of two (N, P, 1) chunk totals in matrix
    form: tens of operations where the unrolled planes take hundreds, and
    under forward mode thousands, on every carry of the optimizer's loss."""
    return _combine_filter_mats(earlier, later, filter_state_dim(earlier.shape[-2]))


def _sharded_scan(kind: str, chunks: list, tangents: list | None = None) -> list:
    """The filter prefix or smoother suffix of a time-sharded sequence, with
    tangents when ``tangents`` is given. One chunk is scanned as it is.
    Several take two passes over the shards: phase A of every chunk's scan
    (its total), the totals combined in scan order by the algebra's plain
    combine (the smoother's from the last chunk back), then phase B of every
    chunk from its carry (the first in scan order from none)."""
    paired = tangents is not None
    if len(chunks) == 1:  # one device's whole sequence: the scan itself, no total
        # the kernels' wrappers are looked up at call time
        if kind == "filter":
            scan = fused_filter.filter_prefix_paired if paired else fused_filter.filter_prefix
        else:
            scan = fused_filter.smoother_suffix_paired if paired else fused_filter.smoother_suffix
        return [scan(chunks[0], tangents[0]) if paired else scan(chunks[0])]
    combine = _combine_filter_totals if kind == "filter" else _combine_smoother
    devices = [c.device for c in chunks]
    parts = map_shards(lambda i, x, dx: fused_filter.chunk_total(x, kind, dx), devices, chunks,
                       tangents if paired else [None] * len(chunks))

    def pair_combine(a, b):
        return jvp(combine, (a[0], b[0]), (a[1], b[1])) if paired else (combine(a[0], b[0]),)

    # the totals as (N, P, 1) planes, (total,) or (total, its tangent)
    totals = [tuple(x[..., None] for x in (p.total if paired else (p.total,))) for p in parts]
    carries = (_carries(totals, pair_combine) if kind == "filter"
               else _carries(totals[::-1], pair_combine)[::-1])

    def finish(i, part, carry):
        if carry is not None:
            carry = tuple(x[..., 0].to(devices[i]) for x in carry)
            carry = carry if paired else carry[0].contiguous()
        return fused_filter.chunk_scan(part, carry)

    return map_shards(finish, devices, parts, carries)


def filter_prefix_sharded(chunks: list) -> list:
    """The inclusive prefix of the filtering elements of a time-sharded
    sequence: ``chunks[i]``, (N, P, T_i) on its shard's device, in time
    order. Phase A of the scan kernel gives each chunk's total on its
    device, the totals are combined in shard order by the filter combine,
    and phase B scans each chunk from the combination of the chunks before
    it. Returns the scanned chunks, each on its device."""
    return _sharded_scan("filter", chunks)


def smoother_suffix_sharded(chunks: list) -> list:
    """The inclusive suffix of the smoothing elements of a time-sharded
    sequence (chunks in forward time order); the carries run from the last
    chunk back, combined by ``_combine_smoother`` with the later element
    first."""
    return _sharded_scan("smoother", chunks)


def filter_prefix_paired_sharded(chunks: list, tangents: list) -> list:
    """``filter_prefix_sharded`` with tangents: per chunk (prefix, its
    tangent), each phase one paired launch on the card; the carries are
    combined under ``torch.func.jvp`` of the plain combine."""
    return _sharded_scan("filter", chunks, tangents)


def smoother_suffix_paired_sharded(chunks: list, tangents: list) -> list:
    """``smoother_suffix_sharded`` with tangents."""
    return _sharded_scan("smoother", chunks, tangents)
