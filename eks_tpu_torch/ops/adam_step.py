"""The s-optimizer's Adam step: one launch an iteration on the card.

Each iteration of the s-optimizer (``core._joint_masked_adam``) evaluates
its loss as the members' log-likelihoods and their derivatives along log s,
n_blocks * b_max of them (``MemberNLL``). The step then does everything up
to the next evaluation: each block's masked sum of its members' NLLs (a
non-finite member counts 1e12 with a zero derivative), optax's Adam update
(``adam(1.0)`` fed ``grad * lr``: b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root
= 0, the count incremented before the bias correction), the stop rule
(|loss - prev| < tol * |log(max(prev, 1e-12))| + 1e-6) and the commits of a
block's state while it is active (not stopped, fewer than ``safety_cap``
iterations).

``AdamStep`` holds that state. For CUDA float32 tensors a step is one
launch of ``adam_step_kernel`` (``csrc/fused_nll.cu``, in kernel A's
library), which updates the state in place and writes the count of blocks
still active to a pinned host word; the loop's stop test waits for the
stream and reads that word. Replaces no Pallas kernel: the JAX package runs
this tail inside its jitted while loop. For CPU tensors, and float64 ones
(the sequential oracle), the step is the plain version ``adam_step_plain``,
the same operations in plain PyTorch; it is also the kernel's oracle, and
on the card the two agree bit for bit at one member a block.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from eks_tpu_torch import tracing
from eks_tpu_torch.ops import cuda_build

__all__ = ["AdamState", "AdamStep", "MemberNLL", "adam_state", "adam_step_plain", "block_nll_sums"]

B1, B2, EPS = 0.9, 0.999, 1e-8
_INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class MemberNLL:
    """The s-optimizer's loss as its Adam step takes it: ``member_lls(s_log
    (n_blocks,)) -> (ll, d ll / d log s)``, each (n_blocks * b_max,) in block
    order, and the members' weights ``mask`` (n_blocks * b_max,): 1 for a
    member, 0 for a block's padding."""

    member_lls: Callable
    mask: torch.Tensor
    b_max: int


class AdamState(NamedTuple):
    """Per block: log s, Adam's moments and count, the last loss, the
    iterations taken and whether the stop rule has fired."""

    s_log: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor  # int32
    prev_loss: torch.Tensor
    iters: torch.Tensor  # int32
    done: torch.Tensor  # bool


def adam_state(s_log: torch.Tensor) -> AdamState:
    """The state before the first step, from the parameter (n_blocks,) or
    (n_blocks, n_params) (copied)."""
    n, dev, dt = s_log.shape[0], s_log.device, s_log.dtype
    return AdamState(
        s_log.clone(), torch.zeros_like(s_log), torch.zeros_like(s_log),
        torch.zeros(n, dtype=torch.int32, device=dev), torch.full((n,), float("inf"), dtype=dt, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev), torch.zeros(n, dtype=torch.bool, device=dev),
    )


def block_nll_sums(lls, dlls, mask, b_max: int):
    """Per-block sums (n_blocks,) of the masked member NLLs and of their
    derivatives; non-finite member NLLs count as 1e12 with a zero
    derivative."""
    n_blocks = lls.shape[0] // b_max
    finite = torch.isfinite(lls)
    nll = torch.where(finite, -lls, torch.full_like(lls, 1e12))
    dnll = torch.where(finite, -dlls, torch.zeros_like(dlls))
    return (
        (nll * mask).reshape(n_blocks, b_max).sum(dim=1),
        (dnll * mask).reshape(n_blocks, b_max).sum(dim=1),
    )


def adam_step_plain(state: AdamState, lls, dlls, mask, b_max: int, lr: float, tol: float,
                    safety_cap: int) -> AdamState:
    """Plain version of the step: the block sums, then the update, the stop
    rule and the masked commits; returns the new state."""
    s_log, mu, nu, count, prev_loss, iters, done = state
    dt, dev = s_log.dtype, s_log.device
    loss, grad = block_nll_sums(lls, dlls, mask, b_max)
    active = ~done & (iters < safety_cap)
    g = grad * lr
    mu_new = (1 - B1) * g + B1 * mu
    nu_new = (1 - B2) * (g * g) + B2 * nu
    count_new = count + 1
    cf = count_new.to(dt)
    mu_hat = mu_new / (1 - torch.pow(torch.tensor(B1, dtype=dt, device=dev), cf))
    nu_hat = nu_new / (1 - torch.pow(torch.tensor(B2, dtype=dt, device=dev), cf))
    s_new = s_log + -1.0 * (mu_hat / (torch.sqrt(nu_hat + 0.0) + EPS))
    rel_tol = tol * torch.abs(torch.log(torch.maximum(prev_loss, torch.tensor(1e-12, dtype=dt, device=dev))))
    stop = torch.isfinite(prev_loss) & (torch.abs(loss - prev_loss) < rel_tol + 1e-6)
    return AdamState(
        torch.where(active, s_new, s_log),
        torch.where(active, mu_new, mu),
        torch.where(active, nu_new, nu),
        torch.where(active, count_new, count),
        torch.where(active, loss, prev_loss),
        torch.where(active, iters + 1, iters),
        torch.where(active, stop, done),
    )


def _lib():
    lib = cuda_build.load("fused_nll")
    fn = lib.adam_step_f32
    if fn.argtypes is None:
        # ll, dll, mask, s_log, mu, nu, count, prev_loss, iters, done, n_active; n, b_max; lr, tol;
        # safety_cap, device; stream
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.adam_step_host_word.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.adam_step_wait.argtypes = [ctypes.c_void_p]
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, dtype: torch.dtype, device: torch.device):
    if x.device != device:
        raise ValueError(f"adam_step: {name} must be on {device}, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"adam_step: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"adam_step: {name} must be contiguous {shape}, got {tuple(x.shape)}")


class AdamStep:
    """The s-optimizer's Adam state over n_blocks blocks of ``b_max``
    members, from log s ``s_log`` (n_blocks,), and its step. ``running()``
    is the stop test: whether any block is still active. ``step(lls,
    dlls)`` takes the members' (ll, d ll / d log s). ``state.s_log`` is the
    parameter the loss reads.

    On the card (CUDA float32) every step is one kernel launch, counted as
    ``("adam_step", b_max)`` in ``tracing.LAUNCHES``, which updates the
    state in place; the state, a pinned host word and the launch's arguments
    are made here, once, and the first step checks the members' operands.
    Elsewhere (the CPU; float64) each step is ``adam_step_plain``."""

    def __init__(self, s_log: torch.Tensor, mask: torch.Tensor, b_max: int, lr: float, tol: float,
                 safety_cap: int):
        self.mask, self.b_max, self.lr, self.tol, self.safety_cap = mask, b_max, lr, tol, safety_cap
        n, dev = s_log.shape[0], s_log.device
        self._kernel = dev.type == "cuda" and s_log.dtype != torch.float64
        if not self._kernel:
            if dev.type != "cpu" and s_log.dtype != torch.float64:
                raise RuntimeError(f"no Adam step kernel for device {dev}")
            self.state = adam_state(s_log)
            return
        if s_log.dtype != torch.float32 or s_log.ndim != 1:
            raise TypeError(f"adam_step: log s must be a float32 vector, got {s_log.dtype} {tuple(s_log.shape)}")
        if b_max < 1:
            raise ValueError(f"adam_step: b_max must be at least 1, got {b_max}")
        _check("mask", mask, (n * b_max,), torch.float32, dev)
        # the count of active blocks, which the kernel writes through its
        # device pointer; before the first step, all of them
        self._n_active = torch.full((1,), n if safety_cap > 0 else 0, dtype=torch.int32, pin_memory=True)
        self._word = ctypes.c_int32.from_address(self._n_active.data_ptr())
        self.state = adam_state(s_log)
        lib = _lib()
        word = ctypes.c_void_p()
        rc = lib.adam_step_host_word(self._n_active.data_ptr(), ctypes.byref(word))
        if rc != 0:
            raise RuntimeError(f"adam_step: no device pointer for the pinned count word, CUDA error {rc}")
        with torch.cuda.device(dev):
            self._stream = torch.cuda.current_stream().cuda_stream
            index = torch.cuda.current_device()
        self._launch, self._wait = lib.adam_step_f32, lib.adam_step_wait
        self._args = [None, None, mask.data_ptr(), *(x.data_ptr() for x in self.state), word.value, n, b_max,
                      lr, tol, min(int(safety_cap), _INT32_MAX), index, self._stream]
        self._checked = False

    def running(self) -> bool:
        """Whether any block is still active: the loop's one wait for the
        device an iteration."""
        if not self._kernel:
            s = self.state
            return bool((~s.done & (s.iters < self.safety_cap)).any())
        rc = self._wait(self._stream)
        if rc != 0:
            raise RuntimeError(f"adam_step: waiting for the stream failed with CUDA error {rc}")
        return self._word.value > 0

    def step(self, lls: torch.Tensor, dlls: torch.Tensor) -> None:
        if not self._kernel:
            self.state = adam_step_plain(self.state, lls, dlls, self.mask, self.b_max, self.lr, self.tol,
                                         self.safety_cap)
            return
        if not self._checked:
            for name, x in (("ll", lls), ("dll", dlls)):
                _check(name, x, tuple(self.mask.shape), torch.float32, self.mask.device)
            self._checked = True
        args = self._args
        args[0], args[1] = lls.data_ptr(), dlls.data_ptr()
        rc = self._launch(*args)
        if rc != 0:
            raise RuntimeError(f"Adam step kernel launch failed with CUDA error {rc}")
        tracing.count(("adam_step", self.b_max))
