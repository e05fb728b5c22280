"""Kernel A of the PyTorch port (eks_tpu_torch/ops/fused_nll.py): its plain
version against the JAX package's fused NLL (Pallas, interpret mode), in
value and in d/d(log s), on identical numpy operands. The CUDA kernel itself
runs only on the card (chip_smoke.py phase 2 holds it against this plain
version); here the wrappers must refuse a CUDA request rather than fall back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import vmap

from eks_tpu.ops import pallas_nll as jax_nll
from eks_tpu_torch import tracing
from eks_tpu_torch.convert import params_from_numpy, scalar_table_from_numpy
from eks_tpu_torch.ops import fused_nll, pkalman

# float32 filters over a few hundred steps, summed in another association
# order than the Pallas kernel's 128 chunks: the JAX package's own parity
# bound for this kernel (tests/test_pallas_nll.py)
RTOL = 2e-5


def _problem(rng, N, T, O, D):
    """The operands of tests/test_pallas_nll.py::_problem, as numpy."""
    ys = (rng.normal(size=(N, T, O)).cumsum(axis=1) * 0.1).astype(np.float32)
    m0 = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    S0 = np.tile(np.eye(D, dtype=np.float32)[None] * 1.3, (N, 1, 1))
    A = np.tile(np.eye(D, dtype=np.float32)[None], (N, 1, 1))
    Q = np.tile(np.eye(D, dtype=np.float32)[None] * 0.7, (N, 1, 1))
    C = (np.tile(np.eye(O, D), (N, 1, 1)) + 0.05 * rng.normal(size=(N, O, D))).astype(np.float32)
    r = (np.abs(rng.normal(size=(N, O))) * 0.5 + 0.2).astype(np.float32)
    return ys, m0, S0, A, Q, C, r


# (N, T, O, D): the singlecam shape, the multi-camera shapes at n_latent 3
# (two, three and four cameras), and the other n_latent the CUDA kernel is
# instantiated for (1 and 2; D = 3 with one camera's O = 2)
SHAPES = [(5, 300, 2, 2), (3, 256, 2, 2), (2, 97, 4, 3), (2, 97, 6, 3), (2, 97, 8, 3),
          (2, 97, 2, 1), (2, 97, 4, 1), (2, 97, 8, 1), (2, 97, 4, 2), (2, 97, 6, 2), (2, 97, 2, 3)]


@pytest.mark.parametrize("N,T,O,D", SHAPES)
def test_plain_kernel_a_matches_jax_fused_nll(N, T, O, D):
    ys, m0, S0, A, Q, C, r = _problem(np.random.default_rng(11 + N), N, T, O, D)
    ll_jax = jax_nll.filter_nll_fused_batched(
        *(jnp.asarray(x) for x in (ys, m0, S0, A, Q, C, r)), interpret=True
    )
    before = tracing.snapshot()
    ll_port = fused_nll.filter_nll_fused_batched(
        torch.as_tensor(ys), *params_from_numpy(m0, S0, A, Q, C, r)
    )
    np.testing.assert_allclose(ll_port.numpy(), np.asarray(ll_jax), rtol=RTOL)
    # the plain version on CPU tensors is no launch of the kernel
    assert tracing.since(before) == {}


@pytest.mark.parametrize("N,T,O,D", SHAPES)
def test_scalar_table_layout_matches_jax(N, T, O, D):
    """The JAX package's own 46-float (at D = O = 2) table, carried across
    with convert.py, gives the port's plain kernel A the same answer as the
    port's own table, and the two tables agree entry for entry."""
    ys, m0, S0, A, Q, C, r = _problem(np.random.default_rng(11 + N), N, T, O, D)
    scal_jax = np.asarray(vmap(jax_nll._pack_scalars)(
        *(jnp.asarray(x) for x in (ys[:, 0], m0, S0, A, Q, C, r))
    ))
    assert scal_jax.shape[1] == jax_nll._scalar_offsets(D, O)[1] == pkalman._scalar_offsets(D, O)[1]
    assert pkalman._scalar_offsets(D, O) == jax_nll._scalar_offsets(D, O)
    table = pkalman._pack_scalars(torch.as_tensor(ys[:, 0]), *params_from_numpy(m0, S0, A, Q, C, r))
    # psd_solve: unrolled Cholesky here, LAPACK in the JAX package on the CPU
    np.testing.assert_allclose(table.numpy(), scal_jax, rtol=1e-5, atol=1e-6)
    y_planes = torch.as_tensor(np.ascontiguousarray(ys.transpose(0, 2, 1)))
    ll_from_jax_table = fused_nll.fused_nll(scalar_table_from_numpy(scal_jax), y_planes)
    np.testing.assert_allclose(
        ll_from_jax_table.numpy(), fused_nll.fused_nll(table, y_planes).numpy(), rtol=RTOL
    )


def test_plain_paired_kernel_a_matches_jax_jvp():
    """d ll / d(log s), with s scaling Q as the optimizer does: the port's
    paired plain version along the table tangent against jax.jvp of the JAX
    fused call (interpret mode)."""
    N, T, O, D = 3, 256, 2, 2
    ys, m0, S0, A, Q, C, r = _problem(np.random.default_rng(7), N, T, O, D)
    s_log = np.array([-0.4, 0.1, 0.6], np.float32)

    def jax_loss(sl):
        sQ = jnp.exp(sl)[:, None, None] * jnp.asarray(Q)
        return jax_nll.filter_nll_fused_batched(
            jnp.asarray(ys), jnp.asarray(m0), jnp.asarray(S0), jnp.asarray(A), sQ,
            jnp.asarray(C), jnp.asarray(r), interpret=True,
        )

    ll_j, dll_j = jax.jvp(jax_loss, (jnp.asarray(s_log),), (jnp.ones(N, jnp.float32),))

    y0 = torch.as_tensor(ys[:, 0])
    m0_t, S0_t, A_t, Q_t, C_t, r_t = params_from_numpy(m0, S0, A, Q, C, r)

    def pack(sl):
        return pkalman._pack_scalars(y0, m0_t, S0_t, A_t, torch.exp(sl)[:, None, None] * Q_t, C_t, r_t)

    sl_t = torch.as_tensor(s_log)
    table, dtable = torch.func.jvp(pack, (sl_t,), (torch.ones_like(sl_t),))
    y_planes = torch.as_tensor(np.ascontiguousarray(ys.transpose(0, 2, 1)))
    ll_p, dll_p = fused_nll.fused_nll_paired(table, dtable, y_planes)
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=RTOL)
    np.testing.assert_allclose(dll_p.numpy(), np.asarray(dll_j), rtol=RTOL, atol=RTOL * np.abs(np.asarray(dll_j)).max())
    # the paired value is the plain value
    np.testing.assert_array_equal(ll_p.numpy(), fused_nll.fused_nll(table, y_planes).numpy())


def test_plain_kernel_a_matches_staged_pipeline_and_sequential():
    """Three routes to one number: the port's plain kernel A (its staged
    plane pipeline: table, element planes, plain scan, epilogue), the JAX
    package's staged plane pipeline from raw parameters, and the port's
    float64 sequential filter."""
    from eks_tpu.ops.pkalman import _filter_nll_planes_batched_staged
    from eks_tpu_torch.ops.kalman import kalman_filter

    ys, m0, S0, A, Q, C, r = _problem(np.random.default_rng(3), 4, 210, 2, 2)
    params = params_from_numpy(m0, S0, A, Q, C, r)
    y_t = torch.as_tensor(ys)
    fused = fused_nll.filter_nll_fused_batched(y_t, *params)
    staged = np.asarray(_filter_nll_planes_batched_staged(*(jnp.asarray(x) for x in (ys, m0, S0, A, Q, C, r))))
    seq64 = kalman_filter(y_t.double(), *(p.double() for p in params)).log_likelihood
    np.testing.assert_allclose(fused.numpy(), staged, rtol=RTOL)
    np.testing.assert_allclose(fused.numpy(), seq64.numpy(), rtol=RTOL)


class _FakeCuda:
    """Quacks like a CUDA tensor far enough to reach a kernel wrapper's
    dispatch; holds a CPU tensor."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")
        self.dtype = t.dtype
        self.shape = t.shape
        self.ndim = t.ndim

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self._t.data_ptr()


def test_kernel_a_wrappers_refuse_cuda_without_a_card():
    """A CUDA request reaches the kernel path and fails there; it never
    silently returns the plain version's answer."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; chip_smoke.py runs the kernel")
    ys, m0, S0, A, Q, C, r = _problem(np.random.default_rng(0), 2, 16, 2, 2)
    table = pkalman._pack_scalars(torch.as_tensor(ys[:, 0]), *params_from_numpy(m0, S0, A, Q, C, r))
    y_planes = torch.as_tensor(np.ascontiguousarray(ys.transpose(0, 2, 1)))
    before = tracing.snapshot()
    with pytest.raises((RuntimeError, AssertionError)):
        fused_nll.fused_nll(_FakeCuda(table), _FakeCuda(y_planes))
    with pytest.raises((RuntimeError, AssertionError)):
        fused_nll.fused_nll_paired(_FakeCuda(table), _FakeCuda(table), _FakeCuda(y_planes))
    assert tracing.snapshot() == before
    # shapes the CUDA kernel is not built for are refused before any launch:
    # beyond D = 3 or O = 8, and an odd O (observations come in x, y pairs)
    for D, O in ((4, 4), (3, 10), (1, 3), (2, 12)):
        bad = torch.zeros(2, pkalman._scalar_offsets(D, O)[1])
        with pytest.raises(NotImplementedError):
            fused_nll.fused_nll(_FakeCuda(bad), _FakeCuda(torch.zeros(2, O, 16)))
    # every instance, singlecam and multi-camera at each n_latent, goes on
    # to the card
    for D, O in fused_nll._CUDA_SHAPES:
        tab = torch.zeros(2, pkalman._scalar_offsets(D, O)[1])
        with pytest.raises((RuntimeError, AssertionError)):
            fused_nll.fused_nll_paired(_FakeCuda(tab), _FakeCuda(tab), _FakeCuda(torch.zeros(2, O, 16)))
    assert tracing.snapshot() == before


def test_staged_nll_at_12_observations_matches_jax_staged_pipeline():
    """Six cameras (O = 12) are beyond the fused kernel: the loss is the
    staged plane NLL over the lane-batched scan. Value and d/d(log s) of the
    port's staged path (plain paired scan on the CPU) against ``jax.jvp`` of
    the JAX package's staged pipeline with its Pallas scan forced (interpret
    mode), on identical operands; and the dispatch takes that path."""
    from eks_tpu.ops.pallas_filter import force_pallas_scan
    from eks_tpu.ops.pkalman import _filter_nll_planes_batched_staged

    N, T, O, D = 2, 90, 12, 3
    ys, m0, S0, A, Q, C, r = _problem(np.random.default_rng(5), N, T, O, D)
    s_log = np.array([-0.3, 0.4], np.float32)

    def jax_loss(sl):
        sQ = jnp.exp(sl)[:, None, None] * jnp.asarray(Q)
        return _filter_nll_planes_batched_staged(
            jnp.asarray(ys), jnp.asarray(m0), jnp.asarray(S0), jnp.asarray(A), sQ,
            jnp.asarray(C), jnp.asarray(r))

    with force_pallas_scan(True):
        ll_j, dll_j = jax.jvp(jax_loss, (jnp.asarray(s_log),), (jnp.ones(N, jnp.float32),))

    y_t = torch.as_tensor(ys)
    m0_t, S0_t, A_t, Q_t, C_t, r_t = params_from_numpy(m0, S0, A, Q, C, r)

    def pack(sl):
        return pkalman._pack_scalars(y_t[:, 0], m0_t, S0_t, A_t, torch.exp(sl)[:, None, None] * Q_t, C_t, r_t)

    sl_t = torch.as_tensor(s_log)
    table, dtable = torch.func.jvp(pack, (sl_t,), (torch.ones_like(sl_t),))
    y_planes = torch.as_tensor(np.ascontiguousarray(ys.transpose(0, 2, 1)))
    ll_p, dll_p = pkalman._staged_nll_paired(table, dtable, y_planes)
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=1e-5)
    np.testing.assert_allclose(dll_p.numpy(), np.asarray(dll_j), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(dll_j)).max())
    # the optimizer's dispatch takes this path, and its value is the
    # value-only staged pipeline's
    ll_d, dll_d = pkalman.filter_nll_paired_batched(table, dtable, y_planes)
    np.testing.assert_array_equal(ll_d.numpy(), ll_p.numpy())
    np.testing.assert_array_equal(dll_d.numpy(), dll_p.numpy())
    np.testing.assert_allclose(pkalman._staged_nll(table, y_planes).numpy(), ll_p.numpy(), rtol=1e-6)


def test_nll_dispatch_takes_the_fused_kernel_up_to_8_observations(monkeypatch):
    """``filter_nll_paired_batched`` at two to four cameras (D = 3, O = 4, 6,
    8) is the fused NLL, as in the JAX package, and at five cameras and more
    (O = 10, 12) the staged path."""
    taken = []
    monkeypatch.setattr(fused_nll, "fused_nll_paired", lambda *a: taken.append("fused"))
    monkeypatch.setattr(pkalman, "_staged_nll_paired", lambda *a: taken.append("staged"))
    for O in (4, 6, 8, 10, 12):
        table = torch.zeros(2, pkalman._scalar_offsets(3, O)[1])
        pkalman.filter_nll_paired_batched(table, table, torch.zeros(2, O, 16))
    assert taken == ["fused", "fused", "fused", "staged", "staged"]
    # n_latent 1, 2 and 4 at two cameras: the fused NLL up to D = 3, as the
    # JAX package's _use_fused_nll, and the staged path at D = 4
    taken.clear()
    for D in (1, 2, 4):
        table = torch.zeros(2, pkalman._scalar_offsets(D, 4)[1])
        pkalman.filter_nll_paired_batched(table, table, torch.zeros(2, 4, 16))
    assert taken == ["fused", "fused", "staged"]
    # and the fused path's value is the fused NLL's
    monkeypatch.undo()
    ys, m0, S0, A, Q, C, r = _problem(np.random.default_rng(2), 2, 60, 4, 3)
    params = params_from_numpy(m0, S0, A, Q, C, r)
    y_t = torch.as_tensor(ys)
    table = pkalman._pack_scalars(y_t[:, 0], *params)
    y_planes = y_t.transpose(1, 2).contiguous()
    ll, _ = pkalman.filter_nll_paired_batched(table, torch.zeros_like(table), y_planes)
    np.testing.assert_array_equal(ll.numpy(), fused_nll.filter_nll_fused_batched(y_t, *params).numpy())


def test_cuda_shapes_are_the_sources_instance_list():
    """The wrapper's ``_CUDA_SHAPES`` are ``FUSED_NLL_SHAPES`` of
    csrc/fused_nll.cu, the one list the C dispatch and ``fused_nll_shapes``
    expand (the card tests ask the built library)."""
    import re
    from pathlib import Path

    text = (Path(fused_nll.__file__).resolve().parent.parent / "csrc" / "fused_nll.cu").read_text()
    macro = re.search(r"#define FUSED_NLL_SHAPES\(X\)(.*?)\n\n", text, re.S).group(1)
    listed = tuple((int(d), int(o)) for d, o in re.findall(r"X\((\d), (\d)\)", macro))
    assert listed == fused_nll._CUDA_SHAPES
    assert listed == tuple((D, O) for D in (1, 2, 3) for O in (2, 4, 6, 8))
    assert text.count("FUSED_NLL_SHAPES(") == 3  # the definition, the dispatch and fused_nll_shapes
