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
from eks_tpu_torch.ops import filters, fused_filter, fused_nll, pkalman

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
    ll_p, dll_p = filters._staged_nll_paired(table, dtable, y_planes)
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=1e-5)
    np.testing.assert_allclose(dll_p.numpy(), np.asarray(dll_j), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(dll_j)).max())
    # the optimizer's route takes this path, and its value is the
    # value-only staged pipeline's
    ll_d, dll_d = filters.linear_member_lls(y_t, r_t, m0_t, S0_t, A_t, Q_t, C_t, 1, -8.0, 8.0)(sl_t)
    np.testing.assert_array_equal(ll_d.numpy(), ll_p.numpy())
    np.testing.assert_array_equal(dll_d.numpy(), dll_p.numpy())
    np.testing.assert_allclose(pkalman._staged_nll(table, y_planes, fused_filter.filter_prefix).numpy(), ll_p.numpy(),
                               rtol=1e-6)


def _route_operands(N, O, D):
    """The flattened operands of ``filters.linear_member_lls`` for N
    members of 16 steps: zero observations, unit noise, identity model."""
    eye = torch.eye(D).expand(N, D, D)
    return (torch.zeros(N, 16, O), torch.ones(N, O), torch.zeros(N, D), eye, eye, eye,
            torch.eye(O, D).expand(N, O, D))


def test_nll_dispatch_takes_the_fused_kernel_up_to_8_observations(monkeypatch):
    """The s-optimizer's loss route (``filters.linear_member_lls``) at two to
    four cameras (D = 3, O = 4, 6, 8) is the fused NLL, as in the JAX
    package, and at five cameras and more (O = 10, 12) the staged path."""
    taken = []
    monkeypatch.setattr(fused_nll, "fused_nll_paired", lambda *a: taken.append("fused"))
    monkeypatch.setattr(filters, "_staged_nll_paired", lambda *a: taken.append("staged"))
    for O in (4, 6, 8, 10, 12):
        filters.linear_member_lls(*_route_operands(2, O, 3), 1, -8.0, 8.0)(torch.zeros(2))
    assert taken == ["fused", "fused", "fused", "staged", "staged"]
    # n_latent 1, 2 and 4 at two cameras: the fused NLL up to D = 3, as the
    # JAX package's _use_fused_nll, and the staged path at D = 4
    taken.clear()
    for D in (1, 2, 4):
        filters.linear_member_lls(*_route_operands(2, 4, D), 1, -8.0, 8.0)(torch.zeros(2))
    assert taken == ["fused", "fused", "staged"]
    # and the fused path's value (at s = 1) is the fused NLL's
    monkeypatch.undo()
    ys, m0, S0, A, Q, C, r = _problem(np.random.default_rng(2), 2, 60, 4, 3)
    m0_t, S0_t, A_t, Q_t, C_t, r_t = params = params_from_numpy(m0, S0, A, Q, C, r)
    y_t = torch.as_tensor(ys)
    ll, _ = filters.linear_member_lls(y_t, r_t, m0_t, S0_t, A_t, Q_t, C_t, 1, -8.0, 8.0)(torch.zeros(2))
    np.testing.assert_array_equal(ll.numpy(), fused_nll.filter_nll_fused_batched(y_t, *params).numpy())


def test_cuda_shapes_are_the_sources_instance_list():
    """The wrapper's ``_CUDA_SHAPES`` are ``FUSED_NLL_SHAPES`` of
    csrc/fused_nll.cu, the one list the C dispatches of kernel A and of the
    table kernel and ``fused_nll_shapes`` expand (the card tests ask the
    built library)."""
    import re
    from pathlib import Path

    text = (Path(fused_nll.__file__).resolve().parent.parent / "csrc" / "fused_nll.cu").read_text()
    macro = re.search(r"#define FUSED_NLL_SHAPES\(X\)(.*?)\n\n", text, re.S).group(1)
    listed = tuple((int(d), int(o)) for d, o in re.findall(r"X\((\d), (\d)\)", macro))
    assert listed == fused_nll._CUDA_SHAPES
    assert listed == tuple((D, O) for D in (1, 2, 3) for O in (2, 4, 6, 8))
    # the definition, kernel A's dispatch, fused_nll_shapes and the table kernel's dispatch
    assert text.count("FUSED_NLL_SHAPES(") == 4


# --------------------------------------------------------------------------- #
# the s-optimizer's paired table (fused_nll.table_paired)
# --------------------------------------------------------------------------- #
def _table_operands(rng, n_blocks, b_max, O, D, s_log=None):
    """Flat (N = n_blocks * b_max) operands of the s-optimizer's table, the
    optimizer's padding included: a block's lanes past its first repeat it."""
    ys, m0, S0, A, Q, C, r = _problem(rng, n_blocks * b_max, 3, O, D)
    ops = [torch.as_tensor(x) for x in (ys[:, 0], m0, S0, A, Q, C, r)]
    if b_max > 1:  # the last block holds one member and b_max - 1 padding lanes
        ops = [x.clone() for x in ops]
        for x in ops:
            x[-b_max + 1:] = x[-b_max]
    if s_log is None:
        s_log = rng.uniform(-1.0, 1.0, size=n_blocks)
    return [torch.as_tensor(np.asarray(s_log, np.float32))] + ops


def _table_composition(s_log, y0, m0, S0, A, Q, C, r, b_max, s_lo, s_hi):
    """The s-optimizer's loss before the table kernel: forward mode of the
    scaled process noise, then of ``_pack_scalars`` along it."""
    N, D = Q.shape[0], Q.shape[-1]
    QB = Q.reshape(-1, b_max, D, D)

    def scaled_q(sl):
        s = torch.exp(torch.clamp(sl, s_lo, s_hi))
        return (s[:, None, None, None] * QB).reshape(N, D, D)

    sQ, dsQ = torch.func.jvp(scaled_q, (s_log,), (torch.ones_like(s_log),))
    return torch.func.jvp(lambda q: pkalman._pack_scalars(y0, m0, S0, A, q, C, r), (sQ,), (dsQ,))


# kernel A's instances, beyond them (five cameras, n_latent 4), and padded blocks
TABLE_SHAPES = [(5, 1, 2, 2), (3, 3, 2, 2), (2, 2, 4, 3), (4, 1, 8, 1), (2, 1, 8, 3), (2, 1, 12, 3), (2, 2, 4, 4)]


@pytest.mark.parametrize("n_blocks,b_max,O,D", TABLE_SHAPES)
def test_plain_table_paired_is_the_forward_mode_composition_bit_for_bit(n_blocks, b_max, O, D):
    """On CPU tensors ``table_paired`` is its plain version, which is the
    optimizer's former loss prologue to the bit, bounds included; no launch
    is counted."""
    rng = np.random.default_rng(n_blocks * 10 + O)
    s_log = rng.uniform(-9.0, 9.0, size=n_blocks)
    s_log[0] = -8.0
    ops = _table_operands(rng, n_blocks, b_max, O, D, s_log)
    before = tracing.snapshot()
    table, dtable = fused_nll.table_paired(*ops, b_max, -8.0, 8.0)
    want, dwant = _table_composition(*ops, b_max, -8.0, 8.0)
    assert tracing.since(before) == {}
    assert table.shape == (n_blocks * b_max, pkalman._scalar_offsets(D, O)[1])
    assert torch.equal(table, want) and torch.equal(dtable, dwant)


@pytest.mark.parametrize("n_blocks,b_max,O,D", TABLE_SHAPES)
def test_table_tangent_matches_a_float64_central_difference(n_blocks, b_max, O, D):
    """d table / d log s of the plain version, float32, against a float64
    central difference of ``_pack_scalars`` in log s (step 1e-4: the float64
    jvp is within 1.1e-9 of it), entry by entry relative to 1 + |difference|:
    float32 rounding of the table's solves, measured at most 2.0e-7 on these
    operands; the limit sits ten times above."""
    rng = np.random.default_rng(n_blocks + O)
    s_log, y0, m0, S0, A, Q, C, r = _table_operands(rng, n_blocks, b_max, O, D)
    _, dtable = fused_nll.table_paired(s_log, y0, m0, S0, A, Q, C, r, b_max, -8.0, 8.0)
    p64 = [x.double() for x in (y0, m0, S0, A, Q, C, r)]
    s_lane = s_log.double().repeat_interleave(b_max)[:, None, None]
    h = 1e-4

    def pack(sl):
        return pkalman._pack_scalars(p64[0], p64[1], p64[2], p64[3], torch.exp(sl) * p64[4], p64[5], p64[6])

    fd = (pack(s_lane + h) - pack(s_lane - h)) / (2 * h)
    err = float(((dtable.double() - fd).abs() / (1 + fd.abs())).max())
    assert err <= 2e-6, err


def test_table_tangent_is_zero_outside_the_bounds():
    """The clamp's forward mode passes the tangent where s_lo <= log s <=
    s_hi, bounds included, and zero outside: a block beyond a bound has the
    bound's table and no tangent."""
    rng = np.random.default_rng(0)
    s_log = [-9.0, -8.0, -7.5, 7.5, 8.0, 9.0, float(np.nextafter(np.float32(-8.0), np.float32(-9.0)))]
    ops = _table_operands(rng, len(s_log), 1, 2, 2, s_log)
    table, dtable = fused_nll.table_paired(*ops, 1, -8.0, 8.0)
    for i in (0, 5, 6):
        assert torch.equal(dtable[i], torch.zeros_like(dtable[i]))
    for i in (1, 2, 3, 4):
        assert bool((dtable[i] != 0).any())
    at_bounds = _table_operands(np.random.default_rng(0), len(s_log), 1, 2, 2, [-8.0, -8.0, 0, 0, 8.0, 8.0, -8.0])
    clamped, _ = fused_nll.table_paired(*at_bounds, 1, -8.0, 8.0)
    for i in (0, 5, 6):
        assert torch.equal(table[i], clamped[i])


@pytest.mark.parametrize("D,O,route", [(2, 2, "kernel"), (3, 8, "kernel"), (3, 12, "plain"), (4, 4, "plain")])
def test_optimizer_takes_the_table_kernel_at_kernel_a_shapes(monkeypatch, D, O, route):
    """The s-optimizer's linear loss asks ``table_paired`` for its table at
    kernel A's (D, O) instances (singlecam; two to four cameras) and the
    forward-mode plain version beyond them (five cameras and more, n_latent
    4), once per Adam iteration."""
    from eks_tpu_torch import core

    taken = []
    plain = fused_nll.table_paired_plain

    def spy(name):
        def fn(*args):
            taken.append(name)
            return plain(*args)
        return fn

    monkeypatch.setattr(fused_nll, "table_paired", spy("kernel"))
    monkeypatch.setattr(fused_nll, "table_paired_plain", spy("plain"))
    n_blocks, b_max, T = 2, 1, 6
    ys, m0, S0, A, Q, C, r = _problem(np.random.default_rng(D * O), n_blocks, T, O, D)
    t = torch.as_tensor
    B = (n_blocks, b_max)
    _, _, iters = core._optimize_blocks_joint(
        t(ys).reshape(*B, T, O), t(r).reshape(*B, O), t(m0).reshape(*B, D), t(S0).reshape(*B, D, D),
        t(A).reshape(*B, D, D), t(Q).reshape(*B, D, D), t(C).reshape(*B, O, D), torch.ones(B),
        torch.zeros(n_blocks), lr=0.25, s_lo=-8.0, s_hi=8.0, tol=1e-2, safety_cap=2)
    assert taken == [route] * int(iters.max())


def test_table_paired_refuses_cuda_without_a_card():
    """A CUDA request for the table reaches the kernel path and fails there,
    never returning the plain version's answer; a (D, O) kernel A does not
    take, or lanes that are not whole blocks, are refused first."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; tests/test_torch_cuda_kernels.py runs the kernel")
    before = tracing.snapshot()
    for D, O in ((2, 2), (3, 8), (4, 4), (3, 12)):
        ops = [_FakeCuda(x) for x in _table_operands(np.random.default_rng(0), 2, 1, O, D)]
        err = (RuntimeError, AssertionError) if (D, O) in fused_nll._CUDA_SHAPES else NotImplementedError
        with pytest.raises(err):
            fused_nll.table_paired(*ops, 1, -8.0, 8.0)
    with pytest.raises(ValueError):
        fused_nll.table_paired(*[_FakeCuda(x) for x in _table_operands(np.random.default_rng(0), 2, 1, 2, 2)],
                               3, -8.0, 8.0)
    assert tracing.snapshot() == before


def test_adam_step_refuses_cuda_without_a_card():
    """A CUDA float32 state for the s-optimizer's Adam step reaches the
    kernel path and fails there, never stepping through the plain version;
    a log s in another float type, a mask of the wrong shape, type or
    device, and blocks of no member are refused first."""
    from eks_tpu_torch.ops import adam_step

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; tests/test_torch_cuda_kernels.py runs the kernel")
    s_log, mask = torch.zeros(3), torch.ones(6)
    before = tracing.snapshot()
    with pytest.raises((RuntimeError, AssertionError)):
        adam_step.AdamStep(_FakeCuda(s_log), _FakeCuda(mask), 2, 0.25, 1e-2, 10)
    for bad_s, bad_mask, b_max, err in (
        (s_log.half(), mask, 2, TypeError),
        (s_log, torch.ones(5), 2, ValueError),
        (s_log, mask.double(), 2, TypeError),
        (s_log, torch.ones(3), 0, ValueError),
    ):
        with pytest.raises(err):
            adam_step.AdamStep(_FakeCuda(bad_s), _FakeCuda(bad_mask), b_max, 0.25, 1e-2, 10)
    with pytest.raises(ValueError):  # the mask on another device
        adam_step.AdamStep(_FakeCuda(s_log), mask, 2, 0.25, 1e-2, 10)
    assert tracing.snapshot() == before
