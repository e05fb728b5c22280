"""Multi-device smoothing: keypoint-axis and time-axis sharding over a mesh.

Counterpart of ``eks_tpu/parallel/mesh.py``. A mesh here is a tuple of
``torch.device``; it may name one device more than once, which is how eight
shards run on the CPU in the tests and four shards on one card.

Keypoint axis (``partition="keypoint"``, the default): every keypoint's
optimizer and smoothing lane is independent, so the block axis is split over
the mesh with ``torch.tensor_split`` (uneven shards, no padding lanes; a
block of keypoints that share s is never split) and each shard runs the
single-device optimizer and final pass on its own device, through the same
kernels, with no communication. Each shard's optimizer loop stops when its
own lanes converge. ``pad_and_shard_leading`` keeps the JAX package's
padding (lane 0 repeated) for callers that want equal shards.

Time axis (``partition="time"``): the frame axis is split into nearly equal
chunks, one a shard. Each chunk's elements are built on its device and
scanned there by the scan kernel in two phases (``filter_prefix_sharded``
and ``smoother_suffix_sharded``, float and paired): phase A of every chunk
gives its total (``fused_filter.chunk_total``), the totals (``N x W*P``
floats each) travel with ``Tensor.to`` to be combined in scan order by the
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
    "filter_prefix_paired_sharded",
    "filter_prefix_sharded",
    "make_mesh",
    "map_shards",
    "optimize_and_smooth_sharded",
    "optimize_blocks_sharded",
    "pad_and_shard_leading",
    "shard_leading",
    "shard_time",
    "smooth_all_sharded",
    "smooth_time_sharded",
    "smoother_suffix_paired_sharded",
    "smoother_suffix_sharded",
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
# keypoint axis
# --------------------------------------------------------------------------- #
def _pad_leading(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad axis 0 to a multiple by repeating the first element."""
    pad = -x.shape[0] % multiple
    return torch.cat([x, x[:1].expand(pad, *x.shape[1:])]) if pad else x


def shard_leading(mesh: Mesh, x: torch.Tensor) -> list:
    """``x`` cut into ``len(mesh)`` equal shards along its leading axis, shard
    i on ``mesh[i]``: ``_split_leading`` under the JAX package's name, for a
    leading length that divides the mesh size (pad it with
    ``pad_and_shard_leading``)."""
    if x.shape[0] % len(mesh):
        raise ValueError(f"leading axis {x.shape[0]} is not divisible by the mesh size {len(mesh)}")
    return [ops[0] for ops in _split_leading(mesh, [x])[1]]


def pad_and_shard_leading(mesh: Mesh, operands: list) -> tuple[list, int]:
    """Pad every operand's leading axis to a multiple of the mesh size,
    repeating element 0 (whose results callers slice away), and shard each
    over the mesh. Returns (per operand its list of shards, the original
    leading length)."""
    n_real = int(operands[0].shape[0])
    return [shard_leading(mesh, _pad_leading(torch.as_tensor(x), len(mesh))) for x in operands], n_real


def _split_leading(mesh: Mesh, operands: list) -> tuple[list, list]:
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


def optimize_blocks_sharded(mesh: Mesh, operands: list, timings: dict | None = None, **opts):
    """``core._optimize_blocks_joint`` with the block axis of ``operands``
    (yB, rB, m0B, S0B, AB, QB, CB, maskB, s_log_init, xB (or None)) split
    over the mesh: every shard's Adam loop runs on its device and stops when
    its own blocks converge. Returns (log s, last
    loss, iterations) per block on the device of ``operands[0]``; with
    ``timings``, "adam_iters_per_shard" and "adam_iters" (their maximum)."""
    from eks_tpu_torch.core import _optimize_blocks_joint

    home = operands[0].device
    devices, shards = _split_leading(mesh, operands)
    h_fn = opts.pop("h_fn", None)
    shard_timings = [{} for _ in devices]

    def run(i, ops, tm):
        *arrays, s_log_init, xB = ops
        return _optimize_blocks_joint(*arrays, s_log_init, h_fn=emission_on(h_fn, devices[i]), xB=xB,
                                      timings=tm, **opts)

    results = map_shards(run, devices, shards, shard_timings)
    if timings is not None:
        timings["adam_iters_per_shard"] = [tm.get("adam_iters", 0) for tm in shard_timings]
        timings["adam_iters"] = max(timings["adam_iters_per_shard"])
    return tuple(torch.cat([r[j].to(home) for r in results]) for j in range(3))


def smooth_all_sharded(mesh: Mesh, operands: list, h_fn=None, sequential: bool = False):
    """``core._smooth_all`` with the lane axis of ``operands`` (ys, m0s, S0s,
    As, Qs, Cs, s_finals, rs) split over the mesh, each shard on its device.
    Returns smoothed means and covariances on the device of ``operands[0]``."""
    from eks_tpu_torch.core import _smooth_all

    home = operands[0].device
    devices, shards = _split_leading(mesh, operands)
    results = map_shards(
        lambda i, ops: _smooth_all(*ops, h_fn=emission_on(h_fn, devices[i]), sequential=sequential),
        devices, shards)
    return tuple(torch.cat([r[j].to(home) for r in results]) for j in range(2))


def optimize_and_smooth_sharded(
    ys: np.ndarray,  # (K, T, O)
    m0s: np.ndarray,  # (K, D)
    S0s: np.ndarray,  # (K, D, D)
    As: np.ndarray,  # (K, D, D)
    Qs: np.ndarray,  # (K, D, D)
    Cs: np.ndarray,  # (K, O, D)
    ensemble_vars: np.ndarray,  # (K, T, O) per-step variances
    mesh: Mesh,
    s_log_init: np.ndarray | None = None,  # (K,)
    lr: float = 0.25,
    tol: float = 1e-2,
    safety_cap: int = 300,
    min_R_var: float = 1e-4,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The full smoothing step, per-keypoint s optimization then the final
    smoothing pass, with the keypoint axis sharded over the mesh; singleton
    blocks (one s per keypoint). Host arrays in, host arrays out:
    (s_finals (K,), ms (K, T, D), Vs (K, T, D, D))."""
    from eks_tpu_torch.core import _device_constant_r

    home = mesh[0]

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=home)

    ys_t, m0_t, S0_t, A_t, Q_t, C_t, ev_t = map(up, (ys, m0s, S0s, As, Qs, Cs, ensemble_vars))
    K = ys_t.shape[0]
    r_const = _device_constant_r(ev_t, float(min_R_var))
    s_log0 = up(np.zeros(K) if s_log_init is None else s_log_init)
    ones = torch.ones((K, 1), dtype=ys_t.dtype, device=home)
    s_log_f, _, _ = optimize_blocks_sharded(
        mesh, [x[:, None] for x in (ys_t, r_const, m0_t, S0_t, A_t, Q_t, C_t)] + [ones, s_log0, None],
        lr=float(lr), s_lo=-8.0, s_hi=8.0, tol=float(tol), safety_cap=int(safety_cap),
    )
    s_finals = torch.exp(torch.clamp(s_log_f, -8.0, 8.0))
    rs = torch.clamp(ev_t, min=1e-12)
    ms, Vs = smooth_all_sharded(mesh, [ys_t, m0_t, S0_t, A_t, Q_t, C_t, s_finals, rs])
    return s_finals.cpu().numpy(), ms.cpu().numpy(), Vs.cpu().numpy()


# --------------------------------------------------------------------------- #
# time axis
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


def shard_time(mesh: Mesh, operands: list, time_axes: list) -> list:
    """Every operand cut along its time axis ``time_axes[i]`` into the mesh's
    chunks (None replicates it): per operand the list of its chunks, chunk
    j on ``mesh[j]``. A T that does not divide the mesh is split into nearly
    equal chunks (the JAX package replicates it instead)."""
    out = []
    for x, ax in zip(operands, time_axes):
        x = torch.as_tensor(x)
        out.append([x.to(d) for d in mesh] if ax is None else TimeShards(mesh, x.shape[ax]).split(x, ax))
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


def smooth_time_sharded(
    ys: np.ndarray,  # (T, O)
    m0: np.ndarray,
    S0: np.ndarray,
    A: np.ndarray,
    Q: np.ndarray,
    C: np.ndarray,
    r_diag: np.ndarray,  # (T, O)
    mesh: Mesh,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sequence-parallel smoothing of ONE keypoint with its time axis sharded
    over the mesh. T must be divisible by the mesh size, as in the JAX
    package. Returns host arrays (log-likelihood, smoothed means (T, D),
    covariances (T, D, D))."""
    from eks_tpu_torch.ops.pkalman import kalman_smoother_parallel

    T = ys.shape[0]
    if T % len(mesh):
        raise ValueError(f"T={T} must be divisible by the mesh size {len(mesh)}")

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=mesh[0])[None]

    r = torch.clamp(up(r_diag), min=1e-12)
    res = kalman_smoother_parallel(*map(up, (ys, m0, S0, A, Q, C)), r, TimeShards(mesh, T), compute_ll=True)
    return (res.log_likelihood[0].cpu().numpy(), res.smoothed_means[0].cpu().numpy(),
            res.smoothed_covs[0].cpu().numpy())
