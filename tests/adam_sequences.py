"""Recorded (ll, d ll / d log s) sequences for the s-optimizer's Adam step,
shared by the CPU tests (tests/test_torch_core.py) and the card tests
(tests/test_torch_cuda_kernels.py). Each member's log-likelihood follows
its own course, whatever the step does, so two versions of the step can be
held against each other iteration by iteration on the same inputs."""

import numpy as np
import torch


def member_sequences(n_blocks: int, b_max: int, n_iter: int, seed: int = 0):
    """(lls, dlls, mask, s_log): ``n_iter`` float32 arrays (n_blocks *
    b_max,) each of members' log-likelihoods and derivatives, block by
    block; the members' weights; a start (n_blocks,). Most blocks converge
    geometrically at their own rate, so the stop rule fires at other
    iterations; block 1 swings by 100 nats every iteration and never stops
    (it reaches the cap); block 2's first member turns NaN from the third
    iteration on (it counts 1e12); at b_max > 1 the last member of every
    other block is padding (weight 0) and carries garbage."""
    rng = np.random.default_rng(seed)
    n = n_blocks * b_max
    base = rng.uniform(1e3, 1e6, size=n)
    amp = rng.uniform(5.0, 100.0, size=n)
    rate = rng.uniform(0.2, 0.7, size=n)
    k = np.arange(n_iter)[:, None]
    lls = -(base + amp * rate ** k)
    swing = slice(b_max, 2 * b_max)
    lls[:, swing] = -(base[swing] + 50.0 * (-1.0) ** k)
    dlls = rng.normal(size=(n_iter, n)) * rng.uniform(1.0, 1e3, size=n)
    if n_blocks > 2:
        lls[2:, 2 * b_max] = np.nan
        dlls[2:, 2 * b_max] = np.nan
    mask = np.ones((n_blocks, b_max))
    if b_max > 1:
        mask[::2, -1] = 0.0
        pad = mask.reshape(-1) == 0
        lls[:, pad] = rng.normal(size=(n_iter, int(pad.sum()))) * 1e30
    s_log = rng.uniform(-2.0, 2.0, size=n_blocks)
    f32 = lambda a: a.astype(np.float32)
    return f32(lls), f32(dlls), f32(mask.reshape(-1)), f32(s_log)


def replay(lls, dlls, device):
    """A ``member_lls`` that returns the recorded pair of its k-th call,
    whatever log s it is given, as CUDA or CPU tensors on ``device``."""
    seq = [(torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)) for a, b in zip(lls, dlls)]
    calls = iter(seq)
    return lambda s_log: next(calls)
