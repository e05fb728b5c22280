"""Kernels A and C: the fused filter NLLs of the optimizers.

Kernel A: constant diagonal R (the s-optimizer's loss), instantiated at
every D in {1, 2, 3} with O in {2, 4, 6, 8}, the shapes the JAX package's
fused route admits: (2, 2) for the singlecam family, (D, 2C) for the linear
multi-camera family at ``n_latent`` D with two to four cameras. More
observations or D > 3 take the staged plane NLL of ``ops/filters.py``
(``_staged_nll_paired``); ``kernel_a_takes`` is the test, and
``filters.linear_member_lls`` the one caller that asks it.

Replaces the Pallas kernel ``eks_tpu/ops/pallas_nll.py`` ``_make_fused_kernel``
(plain and ``paired=True``), reached in the JAX package through
``filter_nll_fused_batched``. Per lane it returns the marginal log-likelihood
of a linear Kalman filter with constant diagonal R, building every filtering
element on the fly from the observations and a per-lane scalar table, so the
only T-sized input is y. The paired form also returns d ll / d(log s) in the
same launch, from the table's tangent: the forward-mode pairing of the JAX
package, without reverse-mode autograd through the kernel.

The CUDA source is ``eks_tpu_torch/csrc/fused_nll.cu``. The table's layout
(``_scalar_offsets``, ``_pack_scalars``) lives in ``ops/pkalman.py`` beside
``_table_planes``, which expands it into the element planes the kernel
builds. The plain PyTorch version here scans those planes with the plain
associative scan and evaluates the epilogue of ``ops/pkalman.py``: it is
the staged plane NLL of the JAX package. Its paired form is
``torch.func.jvp`` of the plain version. The wrappers take the plain version
only for tensors on the CPU; for CUDA tensors they launch the kernel or raise.

The table kernel (``table_paired``, in ``csrc/fused_nll.cu`` at kernel A's
instances): the s-optimizer's paired table, (table, d table / d log s), for
every lane straight from its block's log s, in one launch. Its plain
version is forward mode twice, ``pkalman.paired_scaled_q`` and then
``pkalman._pack_scalars``, what the optimizer ran before the kernel and
still runs at shapes kernel A does not take (``filters.linear_member_lls``
chooses).

Kernel C: time-varying diagonal R (the pupil optimizer's loss). Replaces
``eks_tpu/ops/pallas_nll.py`` ``_make_fused_kernel_tv`` (plain and paired),
reached there through ``filter_nll_fused_tv_batched``. Its T-sized input is
one (N, 2O, T) tensor, the y planes followed by the r planes; each step's
element is built in the information form from those and the lane's
time-varying-R table (``_scalar_offsets_tv``, ``_pack_scalars_tv`` and
``_table_planes_tv`` in ``ops/pkalman.py``). The CUDA source is
``eks_tpu_torch/csrc/fused_nll_tv.cu``; the plain version is the staged
time-varying-R plane NLL (``pkalman._table_nll_tv``) over the plain scan, and
the paired wrapper takes a table tangent only, as kernel A's does.

Both kernels spread each lane over G segments, one thread block each
(``fused_filter.segment_partition`` picks G from the lanes, the steps and
the card's SM count; ``nll_plan`` and ``tv_plan`` keep it per shape),
through two scratch buffers the wrapper allocates as one: the segment totals
(N, G, W * P) and the per-segment log-density sums (W, N, G), W = 2 when
paired.
"""

from __future__ import annotations

import ctypes

import torch

from eks_tpu_torch import tracing
from eks_tpu_torch.ops import cuda_build
from eks_tpu_torch.ops.fused_filter import check_scratch, filter_prefix_plain, segment_partition, sm_count
from eks_tpu_torch.ops.linalg import jvp
from eks_tpu_torch.ops.pkalman import (
    _jvp_or_call,
    _pack_scalars,
    _pack_scalars_tv,
    _scalar_offsets,
    _scalar_offsets_tv,
    _staged_nll,
    _table_dims,
    _table_nll_tv,
    paired_scaled_q,
)

__all__ = [
    "built_shapes",
    "filter_nll_fused_batched",
    "filter_nll_fused_tv_batched",
    "fused_nll",
    "fused_nll_paired",
    "fused_nll_tv",
    "fused_nll_tv_paired",
    "kernel_a_takes",
    "nll_plan",
    "table_paired",
    "table_paired_plain",
    "tv_plan",
]

#: (D, O) pairs the CUDA kernels are instantiated for: kernel A at every
#: D <= 3 with an even O <= 8 (``FUSED_NLL_SHAPES`` in ``csrc/fused_nll.cu``),
#: the JAX package's fused route; kernel C at the pupil family's (3, 8)
_CUDA_SHAPES = tuple((D, O) for D in (1, 2, 3) for O in (2, 4, 6, 8))
_CUDA_SHAPES_TV = ((3, 8),)


def kernel_a_takes(D: int, O: int) -> bool:
    """Whether kernel A and the table kernel are built for state dimension
    D and O observations: the route test of the s-optimizer's loss."""
    return (D, O) in _CUDA_SHAPES


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def _fused_nll_plain(table: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A: (N,) log-likelihoods, the staged
    plane NLL over the plain scan."""
    return _staged_nll(table, y, filter_prefix_plain)


def _fused_nll_paired_plain(table, dtable, y):
    """Plain paired version: (ll, d ll) along the table tangent ``dtable``."""
    return _jvp_or_call(_fused_nll_plain, (table, y.contiguous()), (dtable, None))


def table_paired_plain(s_log, y0, m0, S0, A, Q, C, r, b_max: int, s_lo: float, s_hi: float):
    """Plain version of the table kernel: ``paired_scaled_q``, then
    ``pkalman._pack_scalars`` in forward mode along its tangent."""
    sQ, dsQ = paired_scaled_q(s_log, Q, b_max, s_lo, s_hi)
    return jvp(lambda q: _pack_scalars(y0, m0, S0, A, q, C, r), (sQ,), (dsQ,))


def _fused_nll_tv_plain(table: torch.Tensor, yr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C: (N,) log-likelihoods."""
    return _table_nll_tv(table, yr, filter_prefix_plain)


def _fused_nll_tv_paired_plain(table, dtable, yr):
    """Plain paired version of kernel C: (ll, d ll) along ``dtable``."""
    return _jvp_or_call(_fused_nll_tv_plain, (table, yr.contiguous()), (dtable, None))


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def _lib(paired: bool, tv: bool):
    name = "fused_nll_tv" if tv else "fused_nll"
    fn = getattr(cuda_build.load(name), name + ("_paired_f32" if paired else "_f32"))
    if fn.argtypes is None:
        # y (or yr), table[, dtable], out, totals, partials; N, T, D, O, G
        fn.argtypes = [ctypes.c_void_p] * (6 if paired else 5) + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _table_lib():
    fn = cuda_build.load("fused_nll").nll_table_paired_f32
    if fn.argtypes is None:
        # s_log, y0, m0, S0, A, Q_base, C, r, table, dtable; N, b_max, D, O; s_lo, s_hi; stream
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def built_shapes() -> tuple:
    """The (D, O) instances the library of kernel A reports it builds
    (``FUSED_NLL_SHAPES`` in ``csrc/fused_nll.cu``)."""
    fn = cuda_build.load("fused_nll").fused_nll_shapes
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int]
    Ds, Os = (ctypes.c_int * 64)(), (ctypes.c_int * 64)()
    n = fn(Ds, Os, 64)
    return tuple((Ds[i], Os[i]) for i in range(n))


_GEOMETRY: dict = {}
_PLANS: dict = {}


def _geometry(library: str) -> tuple:
    """(threads per block, most steps per segment) of a library's kernels."""
    if library not in _GEOMETRY:
        geo = getattr(cuda_build.load(library), library + "_geometry")
        geo.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        threads, max_steps = ctypes.c_int(), ctypes.c_int()
        geo(ctypes.byref(threads), ctypes.byref(max_steps))
        _GEOMETRY[library] = (threads.value, max_steps.value)
    return _GEOMETRY[library]


def _plan(library: str, N: int, T: int, device: torch.device) -> dict:
    key = (library, N, T, device.index)
    plan = _PLANS.get(key)
    if plan is None:
        threads, max_steps = _geometry(library)
        G, L = segment_partition(N, T, sm_count(device), threads, max_steps)
        plan = _PLANS[key] = {"G": G, "L": L, "threads": threads}
    return plan


def nll_plan(N: int, T: int, device: torch.device) -> dict:
    """Kernel A's launch geometry for N lanes of T steps on ``device``:
    segments per lane G, steps per segment L, threads per block. Kept per
    (N, T, device): an optimizer asks for the same one every iteration."""
    return _plan("fused_nll", N, T, device)


def tv_plan(N: int, T: int, device: torch.device) -> dict:
    """Kernel C's launch geometry for N lanes of T steps on ``device``, as
    ``nll_plan``'s."""
    return _plan("fused_nll_tv", N, T, device)


def _check(name: str, x: torch.Tensor, shape: tuple):
    if x.device.type != "cuda":
        raise ValueError(f"fused_nll: {name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"fused_nll: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"fused_nll: {name} must be contiguous {shape}, got {tuple(x.shape)}")


def _launch(table, dtable, y, tv: bool = False, scratch=None) -> torch.Tensor:
    """Launch kernel A on (table, y (N, O, T)) or, with ``tv``, kernel C on
    (table, yr (N, 2O, T)); returns the (1, N) or, paired, (2, N) output.
    The ``scratch``, (totals (N, G, W * P), partials (W, N, G)), is checked
    when given; else it is allocated here, as one buffer."""
    N, rows, T = y.shape
    if tv:
        if rows % 2:
            raise ValueError(f"fused_nll: yr must hold O y planes and O r planes, got {rows} planes")
        O = rows // 2
        D, shapes = _table_dims(table.shape[1], O, _scalar_offsets_tv), _CUDA_SHAPES_TV
    else:
        O = rows
        D, shapes = _table_dims(table.shape[1], O), _CUDA_SHAPES
    if (D, O) not in shapes:
        raise NotImplementedError(
            f"fused_nll{'_tv' if tv else ''} kernel is built for (D, O) in {shapes}, got {(D, O)}"
        )
    _check("y", y, (N, rows, T))
    _check("table", table, (N, table.shape[1]))
    if dtable is not None:
        _check("dtable", dtable, tuple(table.shape))
    if y.device != table.device or (dtable is not None and dtable.device != y.device):
        raise ValueError("fused_nll: y and the tables must be on one device")
    W = 2 if dtable is not None else 1
    out = torch.empty((W, N), dtype=torch.float32, device=y.device)
    if N == 0:
        return out
    if T == 0:
        return out.zero_()
    fn = _lib(dtable is not None, tv)
    ptrs = [x.data_ptr() for x in (y, table) + ((dtable,) if dtable is not None else ()) + (out,)]
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        G = (tv_plan(N, T, y.device) if tv else nll_plan(N, T, y.device))["G"]
        n_tot = N * G * W * (3 * D * D + 2 * D)  # floats of the segment totals
        if scratch is None:
            buf = torch.empty(n_tot + W * N * G, dtype=torch.float32, device=y.device)
            scratch_ptrs = (buf.data_ptr(), buf.data_ptr() + 4 * n_tot)
        else:
            for x, sh in zip(scratch, ((N, G, n_tot // (N * G)), (W, N, G))):
                check_scratch("fused_nll", x, sh, y.device)
            scratch_ptrs = tuple(x.data_ptr() for x in scratch)
        rc = fn(*ptrs, *scratch_ptrs, N, T, D, O, G, stream)
    if rc != 0:
        raise RuntimeError(f"fused_nll kernel launch failed with CUDA error {rc}")
    return out


def fused_nll(table: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Log-likelihoods (N,) of N constant-R filters from their scalar tables
    (N, n_scal) and observation planes y (N, O, T)."""
    if y.device.type == "cpu":
        return _fused_nll_plain(table, y)
    if y.device.type != "cuda":
        raise RuntimeError(f"no fused NLL for device {y.device}")
    out = _launch(table, None, y)
    tracing.count(("A", _table_dims(table.shape[1], y.shape[1]), y.shape[1], False))
    return out[0]


def fused_nll_paired(table: torch.Tensor, dtable: torch.Tensor, y: torch.Tensor):
    """(ll (N,), d ll (N,)): the log-likelihoods and their derivative along
    the table tangent ``dtable`` (N, n_scal), in one launch on the card."""
    if y.device.type == "cpu":
        return _fused_nll_paired_plain(table, dtable, y)
    if y.device.type != "cuda":
        raise RuntimeError(f"no fused NLL for device {y.device}")
    out = _launch(table, dtable, y)
    tracing.count(("A", _table_dims(table.shape[1], y.shape[1]), y.shape[1], True))
    return out[0], out[1]


def table_paired(s_log, y0, m0, S0, A, Q, C, r, b_max: int, s_lo: float, s_hi: float):
    """(table, dtable) (N, n_scal): the scalar tables of N = n_blocks * b_max
    lanes at process noise s Q, s = exp(clamp(log s, s_lo, s_hi)) of the
    lane's block, and their derivative along log s. s_log (n_blocks,); y0
    and r (N, O); m0 (N, D); S0, A and Q (N, D, D); C (N, O, D). One launch
    on the card at kernel A's (D, O) instances; the plain version for CPU
    tensors."""
    if s_log.device.type == "cpu":
        return table_paired_plain(s_log, y0, m0, S0, A, Q, C, r, b_max, s_lo, s_hi)
    if s_log.device.type != "cuda":
        raise RuntimeError(f"no table kernel for device {s_log.device}")
    N, O, D = C.shape
    if (D, O) not in _CUDA_SHAPES:
        raise NotImplementedError(f"the table kernel is built for (D, O) in {_CUDA_SHAPES}, got {(D, O)}")
    if b_max < 1 or s_log.ndim != 1 or N != s_log.shape[0] * b_max:
        raise ValueError(f"table_paired: {N} lanes are not {tuple(s_log.shape)} blocks of {b_max}")
    operands = {"s_log": (s_log, (N // b_max,)), "y0": (y0, (N, O)), "m0": (m0, (N, D)),
                "S0": (S0, (N, D, D)), "A": (A, (N, D, D)), "Q": (Q, (N, D, D)), "C": (C, (N, O, D)),
                "r": (r, (N, O))}
    for name, (x, shape) in operands.items():
        _check(name, x, shape)
        if x.device != s_log.device:
            raise ValueError("table_paired: every operand must be on one device")
    out = torch.empty((2, N, _scalar_offsets(D, O)[1]), dtype=torch.float32, device=s_log.device)
    if N == 0:
        return out[0], out[1]
    with torch.cuda.device(s_log.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _table_lib()(*(x.data_ptr() for x, _ in operands.values()), out[0].data_ptr(), out[1].data_ptr(),
                          N, b_max, D, O, s_lo, s_hi, stream)
    if rc != 0:
        raise RuntimeError(f"table kernel launch failed with CUDA error {rc}")
    tracing.count(("table", D, O))
    return out[0], out[1]


def filter_nll_fused_batched(ys, m0, S0, A, Q, C, r) -> torch.Tensor:
    """Marginal log-likelihoods (N,) of N constant-diagonal-R linear filters:
    ys (N, T, O), parameters with a leading N, r (N, O)."""
    table = _pack_scalars(ys[:, 0], m0, S0, A, Q, C, r)
    return fused_nll(table.contiguous(), ys.transpose(1, 2).contiguous())


def fused_nll_tv(table: torch.Tensor, yr: torch.Tensor) -> torch.Tensor:
    """Log-likelihoods (N,) of N time-varying-R filters from their tables
    (N, n_scal_tv) and the planes yr (N, 2O, T): y rows, then r rows."""
    if yr.device.type == "cpu":
        return _fused_nll_tv_plain(table, yr)
    if yr.device.type != "cuda":
        raise RuntimeError(f"no fused NLL for device {yr.device}")
    out = _launch(table, None, yr, tv=True)
    tracing.count(("C", False))
    return out[0]


def fused_nll_tv_paired(table: torch.Tensor, dtable: torch.Tensor, yr: torch.Tensor):
    """(ll (N,), d ll (N,)) of N time-varying-R filters: the log-likelihoods
    and their derivative along the table tangent ``dtable``, in one launch
    on the card."""
    if yr.device.type == "cpu":
        return _fused_nll_tv_paired_plain(table, dtable, yr)
    if yr.device.type != "cuda":
        raise RuntimeError(f"no fused NLL for device {yr.device}")
    out = _launch(table, dtable, yr, tv=True)
    tracing.count(("C", True))
    return out[0], out[1]


def filter_nll_fused_tv_batched(ys, m0, S0, A, Q, C, r) -> torch.Tensor:
    """Marginal log-likelihoods (N,) of N linear filters with time-varying
    diagonal R: ys and r (N, T, O), parameters with a leading N. Needs Q and
    S0 invertible (information form)."""
    table = _pack_scalars_tv(m0, S0, A, Q, C)
    yr = torch.cat([ys.transpose(1, 2), r.transpose(1, 2)], dim=1)
    return fused_nll_tv(table.contiguous(), yr.contiguous())
