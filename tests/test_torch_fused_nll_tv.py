"""Kernel C of the PyTorch port (the fused time-varying-R NLL of
eks_tpu_torch/ops/fused_nll.py): its plain version against the JAX package's
fused TV kernel (Pallas, interpret mode), against both packages' staged TV
plane pipelines and against the port's float64 sequential filter, in value
and along a table tangent, on identical numpy operands. The CUDA kernel
itself runs only on the card (chip_smoke.py holds it against this plain
version); here the wrappers must refuse a CUDA request rather than fall back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import vmap

from eks_tpu.ops import pallas_nll as jax_nll
from eks_tpu.ops import pkalman as jax_pk
from eks_tpu_torch import tracing
from eks_tpu_torch.convert import (
    params_from_numpy,
    tv_planes_from_numpy,
    tv_scalar_table_from_numpy,
)
from eks_tpu_torch.ops import fused_nll, pkalman
from eks_tpu_torch.ops.kalman import kalman_filter
from tests.test_torch_fused_nll import _FakeCuda, _problem

# float32 filters over a few hundred steps, summed in another association
# order than the Pallas kernel's 128 chunks: the JAX package's own parity
# bound for this kernel (tests/test_pallas_nll.py); derivatives at its 2e-4
RTOL = 2e-5
RTOL_JVP = 2e-4

# (N, T, O, D): the pupil shape, the singlecam shape, a scalar state
SHAPES = [(3, 200, 8, 3), (2, 130, 2, 2), (2, 97, 2, 1)]


def _tv_problem(rng, N, T, O, D):
    """The operands of tests/test_pallas_nll.py::_tv_problem, as numpy."""
    ys, m0, S0, A, Q, C, _ = _problem(rng, N, T, O, D)
    r = (np.abs(rng.normal(size=(N, T, O))) * 0.5 + 0.2).astype(np.float32)
    return ys, m0, S0, (A * 0.95).astype(np.float32), Q, C, r


def _jax_staged(ys, m0, S0, A, Q, C, r):
    return vmap(jax_pk.filter_nll_parallel_planes_tv)(ys, m0, S0, A, Q, C, r)


@pytest.mark.parametrize("N,T,O,D", SHAPES)
def test_plain_kernel_c_matches_jax_fused_tv_nll(N, T, O, D):
    """Four routes to one number: the port's plain kernel C, the JAX
    package's fused TV kernel, the port's staged TV plane NLL, and the
    port's float64 sequential filter."""
    args = _tv_problem(np.random.default_rng(31 + N), N, T, O, D)
    ll_jax = jax_nll.filter_nll_fused_tv_batched(*(jnp.asarray(x) for x in args), interpret=True)
    params = params_from_numpy(*args[1:])
    y_t = torch.as_tensor(args[0])
    ll_port = fused_nll.filter_nll_fused_tv_batched(y_t, *params)
    ll_staged = pkalman.filter_nll_parallel_planes_tv(y_t, *params)
    ll_seq64 = kalman_filter(y_t.double(), *(p.double() for p in params)).log_likelihood
    np.testing.assert_allclose(ll_port.numpy(), np.asarray(ll_jax), rtol=RTOL)
    np.testing.assert_allclose(ll_staged.numpy(), ll_port.numpy(), rtol=RTOL)
    np.testing.assert_allclose(ll_port.numpy(), ll_seq64.numpy(), rtol=RTOL)


@pytest.mark.parametrize("N,T,O,D", SHAPES)
def test_tv_table_and_element_planes_match_jax(N, T, O, D):
    """One layout: the JAX package's TV table (84 floats at D = 3, O = 8)
    equals the port's entry for entry, carried across with convert.py it
    gives the port's plain kernel C the same answer, and the element planes
    the table expands into are the JAX package's ``_plane_nll_pre_tv``."""
    ys, m0, S0, A, Q, C, r = _tv_problem(np.random.default_rng(5 + N), N, T, O, D)
    assert pkalman._scalar_offsets_tv(D, O) == jax_nll._scalar_offsets_tv(D, O)
    scal_jax = np.asarray(vmap(jax_nll._pack_scalars_tv)(*(jnp.asarray(x) for x in (m0, S0, A, Q, C))))
    m0_t, S0_t, A_t, Q_t, C_t, r_t = params_from_numpy(m0, S0, A, Q, C, r)
    table = pkalman._pack_scalars_tv(m0_t, S0_t, A_t, Q_t, C_t)
    assert table.shape[1] == 6 * D * D + 2 * D + O * D == pkalman._scalar_offsets_tv(D, O)[1]
    np.testing.assert_allclose(table.numpy(), scal_jax, rtol=1e-6, atol=1e-7)
    for got, want in zip(pkalman._unpack_scalars_tv(table, D, O), (m0, S0, A, Q, C)):
        np.testing.assert_array_equal(got.numpy(), want)  # the raw blocks ride verbatim

    yr = tv_planes_from_numpy(ys, r)
    assert yr.shape == (N, 2 * O, T) and yr.is_contiguous()
    ll_from_jax_table = fused_nll.fused_nll_tv(tv_scalar_table_from_numpy(scal_jax, O), yr)
    np.testing.assert_allclose(
        ll_from_jax_table.numpy(), fused_nll.fused_nll_tv(table, yr).numpy(), rtol=RTOL
    )

    planes_jax = np.asarray(vmap(jax_pk._plane_nll_pre_tv)(*(jnp.asarray(x) for x in (ys, m0, S0, A, Q, C, r))))
    planes = pkalman._plane_nll_pre_tv(torch.as_tensor(ys), m0_t, S0_t, A_t, Q_t, C_t, r_t)
    assert planes.shape == (N, 3 * D * D + 2 * D, T)
    np.testing.assert_allclose(planes.numpy(), planes_jax, rtol=1e-5, atol=1e-5 * np.abs(planes_jax).max())


@pytest.mark.parametrize("O,D,T,jax_route", [
    # the JAX package's paired TV kernel in interpret mode where it compiles
    # in seconds; at the pupil shape that takes minutes on XLA:CPU, so there
    # the reference is jax.jvp of its staged TV plane pipeline, which the JAX
    # package's own tests hold the paired kernel against
    (2, 2, 96, "fused"),
    (2, 1, 64, "fused"),
    (8, 3, 120, "staged"),
])
def test_plain_paired_kernel_c_matches_jax_jvp(O, D, T, jax_route):
    """d ll / d(log s), with s scaling Q (tangents through Q⁻¹, Q⁻¹A and Q
    of the table): the port's paired plain version along the table tangent
    against jax.jvp of the JAX package, and the paired value against the
    plain value."""
    N = 2
    ys, m0, S0, A, Q, C, r = _tv_problem(np.random.default_rng(37), N, T, O, D)
    s_log = np.array([0.2, 0.0], np.float32)
    jargs = [jnp.asarray(x) for x in (ys, m0, S0, A, Q, C, r)]

    def jax_loss(sl):
        sQ = jnp.exp(sl)[:, None, None] * jargs[4]
        if jax_route == "fused":
            return jax_nll.filter_nll_fused_tv_batched(*jargs[:4], sQ, *jargs[5:], interpret=True)
        return _jax_staged(*jargs[:4], sQ, *jargs[5:])

    ll_j, dll_j = jax.jvp(jax_loss, (jnp.asarray(s_log),), (jnp.ones(N, jnp.float32),))

    m0_t, S0_t, A_t, Q_t, C_t, _ = params_from_numpy(m0, S0, A, Q, C, r)

    def pack(sl):
        return pkalman._pack_scalars_tv(m0_t, S0_t, A_t, torch.exp(sl)[:, None, None] * Q_t, C_t)

    sl_t = torch.as_tensor(s_log)
    table, dtable = torch.func.jvp(pack, (sl_t,), (torch.ones_like(sl_t),))
    yr = tv_planes_from_numpy(ys, r)
    ll_p, dll_p = fused_nll.fused_nll_tv_paired(table, dtable, yr)
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=RTOL)
    np.testing.assert_allclose(dll_p.numpy(), np.asarray(dll_j), rtol=RTOL_JVP)
    np.testing.assert_array_equal(ll_p.numpy(), fused_nll.fused_nll_tv(table, yr).numpy())
    # and a central difference of the float64 sequential filter
    h = 1e-4

    def seq64(sl):
        sQ = torch.exp(torch.as_tensor(sl, dtype=torch.float64))[:, None, None] * Q_t.double()
        return kalman_filter(torch.as_tensor(ys).double(), m0_t.double(), S0_t.double(), A_t.double(),
                             sQ, C_t.double(), torch.as_tensor(r).double()).log_likelihood.numpy()

    fd = (seq64(s_log + h) - seq64(s_log - h)) / (2 * h)
    np.testing.assert_allclose(dll_p.numpy(), fd, rtol=1e-3)


def test_prior_information_can_be_computed_once():
    """The optimizer hands ``_pack_scalars_tv`` the prior's part of the
    table, which does not depend on its parameters: same table, bit for bit."""
    _, m0, S0, A, Q, C, r = _tv_problem(np.random.default_rng(2), 4, 8, 8, 3)
    m0_t, S0_t, A_t, Q_t, C_t, _ = params_from_numpy(m0, S0, A, Q, C, r)
    prior = pkalman._prior_information(m0_t, S0_t)
    np.testing.assert_array_equal(
        pkalman._pack_scalars_tv(m0_t, S0_t, A_t, Q_t, C_t, prior=prior).numpy(),
        pkalman._pack_scalars_tv(m0_t, S0_t, A_t, Q_t, C_t).numpy(),
    )


def test_convert_refuses_malformed_tv_operands():
    with pytest.raises(ValueError):
        tv_scalar_table_from_numpy(np.zeros(84), 8)  # not (N, n_scal)
    with pytest.raises(ValueError):
        tv_scalar_table_from_numpy(np.zeros((2, 83)), 8)  # fits no D
    with pytest.raises(ValueError):
        tv_planes_from_numpy(np.zeros((2, 5, 8)), np.zeros((2, 5, 7)))
    table = tv_scalar_table_from_numpy(np.zeros((2, 84), np.float64), 8)
    assert table.dtype == torch.float32 and table.is_contiguous()


def test_kernel_c_wrappers_refuse_cuda_without_a_card():
    """A CUDA request reaches the kernel path and fails there; it never
    silently returns the plain version's answer."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; chip_smoke.py runs the kernel")
    ys, m0, S0, A, Q, C, r = _tv_problem(np.random.default_rng(0), 2, 16, 8, 3)
    table = pkalman._pack_scalars_tv(*params_from_numpy(m0, S0, A, Q, C, r)[:5])
    yr = tv_planes_from_numpy(ys, r)
    before = (tracing.launches("C", False), tracing.launches("C", True))
    with pytest.raises((RuntimeError, AssertionError)):
        fused_nll.fused_nll_tv(_FakeCuda(table), _FakeCuda(yr))
    with pytest.raises((RuntimeError, AssertionError)):
        fused_nll.fused_nll_tv_paired(_FakeCuda(table), _FakeCuda(table), _FakeCuda(yr))
    assert (tracing.launches("C", False), tracing.launches("C", True)) == before
    with pytest.raises(RuntimeError):
        fused_nll.fused_nll_tv(table.to("meta"), yr.to("meta"))  # nor any other device
    # shapes the CUDA kernel is not built for are refused before any launch
    small = torch.zeros(2, pkalman._scalar_offsets_tv(2, 2)[1])
    with pytest.raises(NotImplementedError):
        fused_nll.fused_nll_tv(_FakeCuda(small), _FakeCuda(torch.ones(2, 4, 16)))
    with pytest.raises(ValueError):
        fused_nll.fused_nll_tv(_FakeCuda(table), _FakeCuda(torch.ones(2, 15, 16)))  # odd plane count
