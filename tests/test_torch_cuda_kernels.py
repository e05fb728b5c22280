"""Kernels A and B of the PyTorch port on the card, against their plain
versions on the same inputs, at the edge shapes the headline run of
chip_smoke.py does not reach: a single step, fewer steps than threads, time
axes one either side of a multiple of the block.

The kernels have no CPU mode, so every test here needs a CUDA card and
``nvcc``; on a machine without them each one skips. On the card (where JAX is
not installed, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from eks_tpu_torch.ops import fused_filter, fused_nll, pkalman

pytestmark = pytest.mark.cuda

# the kernels combine the same elements as the plain versions in another
# association order (per-thread chunks and a block sweep against a log-depth
# tree), in float32; entry by entry, relative to 1 + the entry's magnitude
RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there; the CPU tests hold their plain versions")
    return torch.device("cuda")


def _close(got, want):
    err = float(((got - want).abs() / (1.0 + want.abs())).max())
    assert err <= RTOL, err


def _lanes(N, T, O, D, seed=0):
    rng = np.random.default_rng(seed)
    ys = (rng.normal(size=(N, T, O)).cumsum(axis=1) * 0.1).astype(np.float32)
    m0 = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    S0 = np.tile(np.eye(D, dtype=np.float32) * 1.3, (N, 1, 1))
    A = np.tile(np.eye(D, dtype=np.float32), (N, 1, 1))
    Q = np.tile(np.eye(D, dtype=np.float32) * 0.7, (N, 1, 1))
    C = (np.tile(np.eye(O, D), (N, 1, 1)) + 0.05 * rng.normal(size=(N, O, D))).astype(np.float32)
    r = (np.abs(rng.normal(size=(N, O))) * 0.5 + 0.2).astype(np.float32)
    r_tv = (np.abs(rng.normal(size=(N, T, O))) * 0.5 + 0.2).astype(np.float32)
    return ys, m0, S0, A, Q, C, r, r_tv


def _nll_operands(dev, N, T):
    ys, m0, S0, A, Q, C, r, _ = (torch.as_tensor(x, device=dev) for x in _lanes(N, T, 2, 2))
    s_log = torch.linspace(-1.0, 1.0, N, device=dev)

    def pack(sl):
        return pkalman._pack_scalars(ys[:, 0], m0, S0, A, torch.exp(sl)[:, None, None] * Q, C, r)

    table, dtable = torch.func.jvp(pack, (s_log,), (torch.ones_like(s_log),))
    return table.contiguous(), dtable.contiguous(), ys.transpose(1, 2).contiguous()


@pytest.mark.parametrize("N,T", [(1, 1), (3, 5), (4, 255), (2, 257), (20, 1000)])
def test_kernel_a_matches_plain(dev, N, T):
    table, dtable, y = _nll_operands(dev, N, T)
    before = (fused_nll.LAUNCHES, fused_nll.PAIRED_LAUNCHES)
    ll = fused_nll.fused_nll(table, y)
    ll_p, dll_p = fused_nll.fused_nll_paired(table, dtable, y)
    torch.cuda.synchronize()
    assert (fused_nll.LAUNCHES, fused_nll.PAIRED_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = fused_nll._fused_nll_plain(table, y)
    want_p, want_dp = fused_nll._fused_nll_paired_plain(table, dtable, y)
    _close(ll, want)
    _close(ll_p, want_p)
    _close(dll_p, want_dp)
    # the fixed-order block reduction makes the kernel deterministic
    assert torch.equal(fused_nll.fused_nll(table, y), ll)


@pytest.mark.parametrize("T", [1, 7, 255, 257, 300])
def test_kernel_b_matches_plain(dev, T):
    ys, m0, S0, A, Q, C, _, r_tv = (torch.as_tensor(x, device=dev) for x in _lanes(3, T, 2, 2, seed=T))
    planes = pkalman._make_filter_elements(ys, m0, S0, A, Q, C, r_tv)
    before = fused_filter.LAUNCHES
    out = fused_filter.filter_prefix(planes)
    torch.cuda.synchronize()
    assert fused_filter.LAUNCHES == before + 1
    _close(out, fused_filter.filter_prefix_plain(planes))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(dev):
    table, dtable, y = _nll_operands(dev, 2, 16)
    with pytest.raises(TypeError):
        fused_nll.fused_nll(table.double(), y.double())
    with pytest.raises(ValueError):
        fused_nll.fused_nll(table, y.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        fused_nll.fused_nll_paired(table, dtable[:1], y)
    planes = torch.zeros(2, 16, 8, device=dev)
    with pytest.raises(TypeError):
        fused_filter.filter_prefix(planes.double())
    with pytest.raises(ValueError):
        fused_filter.filter_prefix(planes.transpose(1, 2))
