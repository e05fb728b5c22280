"""Kernel B of the PyTorch port (eks_tpu_torch/ops/fused_filter.py) and the
parallel filter and smoother around it (ops/pkalman.py): the plain prefix
scan against the JAX package's Pallas prefix-scan kernel (interpret mode)
and against the port's float64 sequential filter; the plain smoother suffix
scan against the Pallas smoother kernel and the float64 sequential RTS pass;
the plain paired scans against ``jax.jvp`` of the lane-batched Pallas scan;
the element builders and the parallel smoother against their JAX
counterparts. The CUDA kernel runs only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import vmap

from eks_tpu.ops import pkalman as jax_pk
from eks_tpu.ops.pallas_filter import _scan_fn_batched, filter_prefix_pallas, smoother_suffix_pallas
from eks_tpu_torch import tracing
from eks_tpu_torch.convert import params_from_numpy, smoother_planes_from_numpy
from eks_tpu_torch.ops import fused_filter, pkalman
from eks_tpu_torch.ops.kalman import kalman_filter, kalman_smoother
from tests.test_torch_fused_nll import _FakeCuda

# float32 prefix combinations of a few hundred elements in two association
# orders (Pallas: 128 sequential chunks + a log sweep; here: a log-depth
# tree), relative to the largest entry of each compared table
RTOL = 2e-5


def _lanes(rng, N, T, O=2, D=2):
    ys = (rng.normal(size=(N, T, O)).cumsum(axis=1) * 0.1).astype(np.float32)
    m0 = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    S0 = np.tile(np.eye(D, dtype=np.float32) * 1.3, (N, 1, 1))
    A = np.tile(np.eye(D, dtype=np.float32), (N, 1, 1))
    Q = np.tile(np.eye(D, dtype=np.float32) * 0.7, (N, 1, 1))
    C = (np.tile(np.eye(O, D), (N, 1, 1)) + 0.05 * rng.normal(size=(N, O, D))).astype(np.float32)
    r_tv = (np.abs(rng.normal(size=(N, T, O))) * 0.5 + 0.2).astype(np.float32)
    return ys, m0, S0, A, Q, C, r_tv


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("T", [256, 300, 97])
def test_plain_scan_matches_pallas_prefix_kernel(T):
    """Identical elements (built by the JAX package) through the Pallas
    prefix kernel and through the port's plain scan: aligned (256) and
    unaligned T."""
    ys, m0, S0, A, Q, C, r = _lanes(np.random.default_rng(T), 1, T)
    elems = jax_pk._make_filter_elements(*(jnp.asarray(x[0]) for x in (ys, m0, S0, A, Q, C, r)))
    ms_j, Ps_j = filter_prefix_pallas(elems, interpret=True)
    planes = pkalman._aos_planes(*(torch.tensor(np.asarray(leaf))[None] for leaf in elems))
    out = fused_filter.filter_prefix(planes)
    dd = 4
    _close(out[0, dd:dd + 2].T.numpy(), ms_j)
    _close(out[0, dd + 2:2 * dd + 2].T.reshape(T, 2, 2).numpy(), Ps_j)


@pytest.mark.parametrize("T", [97])
def test_plain_scan_matches_pallas_prefix_kernel_at_d3(T):
    """The pupil family's shape (D = 3, O = 8: 33 planes) through the Pallas
    prefix kernel and through the port's plain scan."""
    ys, m0, S0, A, Q, C, r = _lanes(np.random.default_rng(T), 1, T, O=8, D=3)
    elems = jax_pk._make_filter_elements(*(jnp.asarray(x[0]) for x in (ys, m0, S0, 0.95 * A, Q, C, r)))
    ms_j, Ps_j = filter_prefix_pallas(elems, interpret=True)
    planes = pkalman._aos_planes(*(torch.tensor(np.asarray(leaf))[None] for leaf in elems))
    assert planes.shape == (1, 33, T)
    out = fused_filter.filter_prefix(planes)
    _close(out[0, 9:12].T.numpy(), ms_j)
    _close(out[0, 12:21].T.reshape(T, 3, 3).numpy(), Ps_j)


@pytest.mark.parametrize("O,D", [(2, 2), (8, 3), (2, 1), (8, 4)])
def test_plain_scan_matches_float64_sequential_filter(O, D):
    ys, m0, S0, A, Q, C, r = _lanes(np.random.default_rng(1), 3, 173, O=O, D=D)
    params = params_from_numpy(m0, S0, A, Q, C, r)
    y_t = torch.as_tensor(ys)
    ms, Ps = pkalman._run_filter_prefix(pkalman._make_filter_elements(y_t, *params))
    seq = kalman_filter(y_t.double(), *(p.double() for p in params))
    _close(ms.numpy(), seq.filtered_means.numpy())
    _close(Ps.numpy(), seq.filtered_covs.numpy())


@pytest.mark.parametrize("D", [4, 5])
def test_plain_scan_beyond_d3_matches_jax_associative_scan(D):
    """Beyond D = 3 the JAX package has no Pallas scan and runs
    ``lax.associative_scan`` over its matrix-form combine; the port's plain
    scan there (what the card runs too) takes the same combine in matrix
    form."""
    ys, m0, S0, A, Q, C, r = _lanes(np.random.default_rng(D), 2, 120, O=2 * D, D=D)
    A = (0.95 * A).astype(np.float32)
    elems = vmap(jax_pk._make_filter_elements)(*(jnp.asarray(x) for x in (ys, m0, S0, A, Q, C, r)))
    ms_j, Ps_j = vmap(jax_pk._run_filter_prefix)(elems)
    planes = pkalman._aos_planes(*(torch.tensor(np.asarray(leaf)) for leaf in elems))
    assert planes.shape == (2, 3 * D * D + 2 * D, 120)
    ms, Ps = pkalman._run_filter_prefix(planes)
    _close_entrywise(ms.numpy(), ms_j)
    _close_entrywise(Ps.numpy(), Ps_j)


@pytest.mark.parametrize("time_varying,O,D", [(True, 2, 2), (False, 2, 2), (True, 8, 3)])
def test_filter_elements_match_jax(time_varying, O, D):
    """The element builder, both branches (constant R: the optimizer's
    table; time-varying R: the final pass's per-step solve, an 8 x 8 one in
    the pupil family)."""
    ys, m0, S0, A, Q, C, r = _lanes(np.random.default_rng(2), 3, 64, O=O, D=D)
    if not time_varying:
        r = r[:, 0]
    e = vmap(jax_pk._make_filter_elements)(*(jnp.asarray(x) for x in (ys, m0, S0, A, Q, C, r)))
    want = np.asarray(pkalman._aos_planes(*(torch.tensor(np.asarray(leaf)) for leaf in e)))
    got = pkalman._make_filter_elements(torch.as_tensor(ys), *params_from_numpy(m0, S0, A, Q, C, r))
    _close(got.numpy(), want, rtol=1e-5)


def test_parallel_filter_and_smoother_match_jax():
    """The port's parallel filter and smoother (plain scans on the CPU)
    against the JAX package's sequential filter and smoother, and against
    the port's own float64 sequential oracle."""
    from eks_tpu.ops.kalman import kalman_smoother as jax_kalman_smoother

    ys, m0, S0, A, Q, C, r = _lanes(np.random.default_rng(4), 3, 150)
    jr = vmap(lambda y, m, s, a, q, c, rr: jax_kalman_smoother(y, m, s, a, q, C=c, r_diag=rr))(
        *(jnp.asarray(x) for x in (ys, m0, S0, A, Q, C, r))
    )
    params = params_from_numpy(m0, S0, A, Q, C, r)
    res = pkalman.kalman_smoother_parallel(torch.as_tensor(ys), *params)
    _close(res.filtered_means.numpy(), jr.filtered_means)
    _close(res.smoothed_means.numpy(), jr.smoothed_means)
    _close(res.smoothed_covs.numpy(), jr.smoothed_covs)
    fr = pkalman.kalman_filter_parallel(torch.as_tensor(ys), *params)
    np.testing.assert_allclose(fr.log_likelihood.numpy(), np.asarray(jr.log_likelihood), rtol=RTOL)
    seq = kalman_smoother(torch.as_tensor(ys).double(), *(p.double() for p in params))
    _close(res.smoothed_means.numpy(), seq.smoothed_means.numpy())
    _close(res.smoothed_covs.numpy(), seq.smoothed_covs.numpy())


def _close_entrywise(got, want, tol=1e-5):
    """Entry by entry, within ``tol`` of 1 + |value|."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= tol, err.max()


def _smoother_elements(T, D, seed, N=2):
    """Smoothing-element planes (N, 2D² + D, T) of a filtered random walk at
    state size D (O = 2D observations), the filter's operands, and the
    filtered moments. Built by the port; the JAX package's element builder is
    held against the port's in test_parallel_filter_and_smoother_match_jax."""
    ys, m0, S0, A, Q, C, r = _lanes(np.random.default_rng(seed), N, T, O=2 * D, D=D)
    A = (0.95 * A).astype(np.float32)
    params = params_from_numpy(m0, S0, A, Q, C, r)
    fr = pkalman.kalman_filter_parallel(torch.as_tensor(ys), *params, compute_ll=False)
    planes = pkalman._make_smoother_elements(fr.filtered_means, fr.filtered_covs, params[2], params[3])
    return planes, (ys, m0, S0, A, Q, C, r), fr


def _aos(planes, D):
    """(N, P, T) smoothing planes -> numpy E (N, T, D, D), g (N, T, D), L."""
    N, _, T = planes.shape
    dd = D * D
    rows = planes.transpose(1, 2).numpy()
    return (rows[..., :dd].reshape(N, T, D, D), rows[..., dd:dd + D],
            rows[..., dd + D:].reshape(N, T, D, D))


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("T", [1, 255, 256, 257])
def test_plain_smoother_suffix_matches_pallas_kernel_and_sequential_rts(T, D):
    """Identical smoothing elements through the JAX package's Pallas smoother
    kernel (interpret mode) and through the port's plain suffix scan, and the
    port's result against its float64 sequential RTS smoother; T = 1 and T
    on either side of 256, the CUDA kernel's block."""
    planes, (ys, m0, S0, A, Q, C, r), fr = _smoother_elements(T, D, seed=10 * T + D)
    E, g, L = _aos(planes, D)
    # convert.py carries the JAX package's (E, g, L) layout to these planes
    np.testing.assert_array_equal(smoother_planes_from_numpy(E, g, L).numpy(), planes.numpy())
    assert planes.shape == (2, 2 * D * D + D, T)
    out = fused_filter.smoother_suffix(planes)
    sm_all, sP_all = _aos(out, D)[1:]
    sm_j, sP_j = smoother_suffix_pallas(*(jnp.asarray(x[0]) for x in (E, g, L)), interpret=True)
    _close_entrywise(sm_all[0], sm_j)
    _close_entrywise(sP_all[0], sP_j)
    # the last step carries the filtered terminal moments untouched
    np.testing.assert_array_equal(sm_all[:, -1], g[:, -1])
    seq = kalman_smoother(torch.as_tensor(ys).double(), *(p.double() for p in params_from_numpy(m0, S0, A, Q, C, r)))
    # elements and filter are float32, the oracle float64 throughout
    _close_entrywise(sm_all, seq.smoothed_means.numpy(), tol=2e-5)
    _close_entrywise(sP_all, seq.smoothed_covs.numpy(), tol=2e-5)
    # the smoother of ops/pkalman.py goes through the same wrapper
    sm_p, sP_p = pkalman._rts_from_filtered(
        fr.filtered_means, fr.filtered_covs, torch.as_tensor(A), torch.as_tensor(Q))
    np.testing.assert_array_equal(sm_p.numpy(), sm_all)
    np.testing.assert_array_equal(sP_p.numpy(), sP_all)


def _paired_operands(kind, D, N=3, T=130):
    """(planes, tangents, paired scan, plain scan) for one instance. The
    filter's tangent is its elements' derivative in log s, which keeps C and
    J symmetric as every real tangent does (the filter combine is
    associative only on such elements); the smoother's is random."""
    rng = np.random.default_rng(7 + D)
    if kind == "filter":
        ys, m0, S0, A, Q, C, r = _lanes(rng, N, T, O=2 * D, D=D)
        params = params_from_numpy(m0, S0, A, Q, C, r)
        sl = torch.zeros(N)

        def elems(s_log):
            return pkalman._make_filter_elements(
                torch.as_tensor(ys), params[0], params[1], params[2],
                torch.exp(s_log)[:, None, None] * params[3], params[4], params[5])

        planes, tangents = torch.func.jvp(elems, (sl,), (torch.ones_like(sl),))
        return planes, tangents, fused_filter.filter_prefix_paired, fused_filter.filter_prefix
    planes, _, _ = _smoother_elements(T, D, seed=D, N=N)
    tangents = torch.as_tensor((0.1 * rng.normal(size=planes.shape)).astype(np.float32))
    return planes, tangents, fused_filter.smoother_suffix_paired, fused_filter.smoother_suffix


@pytest.mark.parametrize("kind,D", [("filter", 3), ("smoother", 2), ("smoother", 3), ("filter", 1), ("smoother", 1)])
def test_plain_paired_scans_match_jax_jvp_of_lane_batched_kernel(kind, D):
    """(N, P, T) planes and a tangent through ``jax.jvp`` of the JAX
    package's lane-batched Pallas scan (its paired instance, interpret mode)
    and through the port's plain paired scans. The smoother scan of the JAX
    package runs on time-reversed planes; the port's takes forward time."""
    import jax

    planes, tangents, scan, _ = _paired_operands(kind, D)
    out, dout = scan(planes, tangents)
    flip = (lambda a: a[..., ::-1]) if kind == "smoother" else (lambda a: a)
    out_j, dout_j = jax.jvp(
        _scan_fn_batched(kind, D, planes.shape[-1], True),
        (jnp.asarray(flip(planes.numpy())),), (jnp.asarray(flip(tangents.numpy())),))
    _close_entrywise(out.numpy(), flip(np.asarray(out_j)))
    _close_entrywise(dout.numpy(), flip(np.asarray(dout_j)))


@pytest.mark.parametrize("kind,D", [(k, d) for d in (1, 2, 3, 4) for k in ("filter", "smoother")])
def test_plain_paired_scans_match_finite_differences(kind, D):
    """Every paired instance's plain version: its value is the plain scan's,
    and its tangent is the central difference of the float64 plain scan."""
    planes, tangents, scan, plain = _paired_operands(kind, D, T=70)
    out, dout = scan(planes, tangents)
    np.testing.assert_array_equal(out.numpy(), plain(planes).numpy())
    h = 1e-6
    fd = (plain(planes.double() + h * tangents.double()) - plain(planes.double() - h * tangents.double())) / (2 * h)
    _close_entrywise(dout.numpy(), fd.numpy(), tol=1e-4)


@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_associative_scan_matches_sequential_fold(T):
    """The log-depth scan is an inclusive prefix, forward and reverse, for a
    non-commutative combine (2x2 matrix products carried as planes), up to
    float64 reassociation."""
    rng = np.random.default_rng(T)
    x = torch.as_tensor(rng.normal(size=(3, 4, T)))

    def matmul(a, b):  # planes of 2x2 matrices, a applied first
        return pkalman._flat(pkalman._pmatmul(pkalman._mat_planes(b, 0, 2), pkalman._mat_planes(a, 0, 2)))

    fwd = pkalman.associative_scan(matmul, x)
    rev = pkalman.associative_scan(matmul, x, reverse=True)
    acc_f, acc_r = x[..., 0], x[..., T - 1]
    np.testing.assert_allclose(fwd[..., 0], acc_f)
    for t in range(1, T):
        acc_f = matmul(acc_f[..., None], x[..., t:t + 1])[..., 0]
        np.testing.assert_allclose(fwd[..., t], acc_f, rtol=1e-10)
    for t in range(T - 2, -1, -1):
        acc_r = matmul(acc_r[..., None], x[..., t:t + 1])[..., 0]
        np.testing.assert_allclose(rev[..., t], acc_r, rtol=1e-10)


def test_kernel_b_wrapper_refuses_cuda_without_a_card():
    """A CUDA request reaches the kernel path and fails there; it never
    silently returns the plain version's answer."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; chip_smoke.py runs the kernel")
    ys, m0, S0, A, Q, C, r = _lanes(np.random.default_rng(0), 2, 16)
    planes = pkalman._make_filter_elements(torch.as_tensor(ys), *params_from_numpy(m0, S0, A, Q, C, r))
    before = tracing.launches("scan")
    with pytest.raises((RuntimeError, AssertionError)):
        fused_filter.filter_prefix(_FakeCuda(planes))
    assert tracing.launches("scan") == before
    with pytest.raises(ValueError):
        fused_filter._scan_cuda(planes, "filter", False)  # a CPU tensor is never launched
    with pytest.raises(RuntimeError):
        fused_filter.filter_prefix(planes.to("meta"))  # nor is any other device
    with pytest.raises(ValueError):
        fused_filter.filter_prefix(torch.zeros(2, 7, 16))  # not 3D²+2D planes
    for P in (5, 33):  # D = 1 and D = 3 go on to the card
        with pytest.raises((RuntimeError, AssertionError)):
            fused_filter.filter_prefix(_FakeCuda(torch.zeros(2, P, 16)))
    with pytest.raises(NotImplementedError):  # the kernel itself is built for D <= 3 only
        fused_filter._scan_cuda(_FakeCuda(torch.zeros(2, 56, 16)), "filter", False)
    assert tracing.launches("scan") == before and tracing.launches("scan", "filter", False, 3) == 0


def test_smoother_and_paired_wrappers_refuse_cuda_without_a_card():
    """The smoother and paired scans, like the filter scan: a CUDA request
    reaches the kernel path and fails there, shapes the kernel is not built
    for are refused before any launch, and no count moves."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; chip_smoke.py runs the kernels")
    before = tracing.snapshot()
    for P in (10, 21):  # D = 2, 3 go on to the card
        with pytest.raises((RuntimeError, AssertionError)):
            fused_filter.smoother_suffix(_FakeCuda(torch.zeros(2, P, 16)))
    with pytest.raises((RuntimeError, AssertionError)):  # D = 1 as well
        fused_filter.smoother_suffix(_FakeCuda(torch.zeros(2, 3, 16)))
    with pytest.raises(NotImplementedError):  # the kernel itself stops at D = 3
        fused_filter._scan_cuda(_FakeCuda(torch.zeros(2, 36, 16)), "smoother", False)
    with pytest.raises(ValueError):  # 16 planes is a filter element
        fused_filter.smoother_suffix(torch.zeros(2, 16, 16))
    with pytest.raises(RuntimeError):
        fused_filter.smoother_suffix(torch.zeros(2, 10, 16).to("meta"))
    with pytest.raises(ValueError):  # a CPU tensor is never launched
        fused_filter._scan_cuda(torch.zeros(2, 20, 16), "smoother", True)
    with pytest.raises(ValueError):  # 33 planes cannot be P primal + P tangent
        fused_filter._scan_cuda(_FakeCuda(torch.zeros(2, 33, 16)), "filter", True)
    assert tracing.since(before) == {}
    assert fused_filter._CUDA_D == (1, 2, 3)  # the instances: (kind, paired, D) for D in these


@pytest.mark.parametrize("kind", ["filter", "smoother"])
def test_scans_beyond_d3_take_the_counted_plain_route_on_the_card(monkeypatch, kind):
    """On a CUDA tensor the scans launch the kernel at D <= 3 and, beyond,
    run the plain version (the JAX package's XLA associative scan there),
    chosen by shape and counted as ("scan_plain_route", kind); paired too."""
    taken = []
    monkeypatch.setattr(fused_filter, "_scan_cuda", lambda planes, k, paired: taken.append(("kernel", paired)))
    plain_name = "filter_prefix_plain" if kind == "filter" else "smoother_suffix_plain"
    monkeypatch.setattr(fused_filter, plain_name, lambda planes: taken.append(("plain", False)))
    scan, scan_paired = {"filter": (fused_filter.filter_prefix, fused_filter.filter_prefix_paired),
                         "smoother": (fused_filter.smoother_suffix, fused_filter.smoother_suffix_paired)}[kind]
    dim = pkalman.filter_state_dim if kind == "filter" else pkalman.smoother_state_dim
    before = tracing.launches("scan_plain_route")
    for P in ((5, 16, 33, 56, 85) if kind == "filter" else (3, 10, 21, 36, 55)):
        scan(_FakeCuda(torch.zeros(2, P, 16)))
        assert taken[-1] == (("kernel", False) if dim(P) <= 3 else ("plain", False))
    assert tracing.launches("scan_plain_route") == before + 2
    # paired: on to the kernel's Dual instance up to D = 3 (whose operand
    # a CPU stand-in for a CUDA tensor cannot build); beyond, the plain
    # version's jvp, which it cannot enter either: only the route is read
    P_small, P_large = (33, 56) if kind == "filter" else (21, 36)
    with pytest.raises(TypeError):
        scan_paired(_FakeCuda(torch.zeros(2, P_small, 16)), _FakeCuda(torch.zeros(2, P_small, 16)))
    assert tracing.launches("scan_plain_route") == before + 2
    with pytest.raises(Exception):
        scan_paired(_FakeCuda(torch.zeros(2, P_large, 16)), _FakeCuda(torch.zeros(2, P_large, 16)))
    assert tracing.launches("scan_plain_route") == before + 3
