"""The port's multi-device smoothing (eks_tpu_torch/ops/shards.py, parallel/ and the
``devices`` / ``partition`` paths) against the JAX package, case by case of
tests/test_parallel.py, on the CPU: the JAX package on its eight virtual CPU
devices (tests/conftest.py), the port on a mesh of the CPU named up to eight
times, whose shards run one after another. Same numpy inputs, the JAX tests'
own limits. Where the JAX test of a case is marked slow (its SPMD compile
takes minutes), the port's sharded run is held against the JAX package's
one-device run at that test's limits instead, the JAX test itself holding the
JAX mesh to that run. Besides: the port sharded against the port unsharded,
the sharded scans and the carry combine against the plain unsharded scan,
worker threads, the two repaired faults, and the mesh's refusal to put work
on the CPU when a card was asked for."""

import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eks_tpu.core import run_kalman_smoother as jax_run_kalman_smoother
from eks_tpu.ops.kalman import kalman_smoother as jax_kalman_smoother
from eks_tpu.parallel import make_mesh as jax_make_mesh
from eks_tpu.parallel import optimize_and_smooth_sharded as jax_optimize_and_smooth_sharded
from eks_tpu.parallel.mesh import smooth_time_sharded as jax_smooth_time_sharded
from eks_tpu_torch.core import run_kalman_smoother
from eks_tpu_torch.ops import filters, fused_filter, pkalman
from eks_tpu_torch.parallel import (
    filter_prefix_paired_sharded,
    filter_prefix_sharded,
    make_mesh,
    optimize_and_smooth_sharded,
    pad_and_shard_leading,
    shard_leading,
    shard_time,
    smooth_time_sharded,
    smoother_suffix_paired_sharded,
    smoother_suffix_sharded,
)
from eks_tpu_torch.ops.shards import TimeShards, map_shards
from tests.test_parallel import _toy


def _t(*arrays, dtype=torch.float32):
    return [torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays]


def _smoother_problem(rng, K, T):
    """The inputs of tests/test_parallel.py's run_kalman_smoother cases, made the same
    way from the same seed: ys (K, T, 2), identity model, variances (T, K, 2)."""
    eye = np.tile(np.eye(2), (K, 1, 1))
    ys = rng.normal(size=(K, T, 2)).cumsum(axis=1).astype(np.float32) * 0.1
    ev = np.abs(rng.normal(size=(T, K, 2))).astype(np.float32) + 0.05
    return ys, dict(m0s=np.zeros((K, 2)), S0s=eye.copy(), As=eye.copy(), Cs=eye.copy(), Qs=eye.copy(),
                    ensemble_vars=ev)


def _port_smoother(ys, args, **kw):
    """The port's run_kalman_smoother on the JAX test's keyword arguments,
    on the CPU; (s, ms, Vs) as numpy."""
    s, ms, Vs = run_kalman_smoother(*_t(ys, args["m0s"], args["S0s"], args["As"], args["Cs"], args["Qs"],
                                        args["ensemble_vars"]), **kw)
    return s, ms.numpy(), Vs.numpy()


# --------------------------------------------------------------------------- #
# the mesh
# --------------------------------------------------------------------------- #
def test_mesh_creation():
    """make_mesh on the CPU names the CPU n times (one by default); the JAX
    package's make_mesh(4) has four devices, so has the port's."""
    assert make_mesh(device="cpu") == (torch.device("cpu"),)
    mesh4 = make_mesh(4, "cpu")
    assert len(mesh4) == len(jax_make_mesh(4).devices.flat) == 4
    assert all(d == torch.device("cpu") for d in mesh4)


def test_cuda_mesh_never_falls_back_to_the_cpu(monkeypatch):
    """A CUDA mesh larger than the host's cards raises the JAX package's
    message and returns no CPU device (the JAX package falls back to its CPU
    devices there); with enough cards it names cuda:0 .. cuda:n-1."""
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="requested 2 devices but only"):
            make_mesh(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        make_mesh(2, "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert make_mesh(3, "cuda") == tuple(torch.device("cuda", i) for i in range(3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="only 0 available"):
        make_mesh(2, "cuda")


def test_shard_leading_and_padding():
    """shard_leading cuts an axis that divides the mesh, and refuses one that
    does not; pad_and_shard_leading repeats element 0, as the JAX package."""
    mesh = make_mesh(4, "cpu")
    x = torch.arange(8.0)
    assert [p.tolist() for p in shard_leading(mesh, x)] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="divisible"):
        shard_leading(mesh, torch.arange(5.0))
    shards, n = pad_and_shard_leading(mesh, [torch.arange(5.0)])
    assert n == 5 and [p.tolist() for p in shards[0]] == [[0, 1], [2, 3], [4, 0], [0, 0]]
    chunks = shard_time(mesh, [torch.arange(10.0)[None], torch.ones(3)], [1, None])
    assert [c.shape[1] for c in chunks[0]] == [3, 3, 2, 2] and len(chunks[1]) == 4


# --------------------------------------------------------------------------- #
# keypoint axis
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("K", [8, 5])  # even and uneven shards
def test_sharded_matches_single_device(rng, K):
    """optimize_and_smooth_sharded on four shards against the JAX package's
    on its four-device mesh: s at rtol 1e-4, the moments at atol 1e-4; and
    its moments against the port's one-device run at its s (1e-6)."""
    ys, m0s, S0s, As, Qs, Cs, ev = _toy(rng, K)
    s_j, ms_j, Vs_j = jax_optimize_and_smooth_sharded(ys, m0s, S0s, As, Qs, Cs, ev, mesh=jax_make_mesh(4))
    s_p, ms_p, Vs_p = optimize_and_smooth_sharded(ys, m0s, S0s, As, Qs, Cs, ev, mesh=make_mesh(4, "cpu"))
    assert s_p.shape == (K,) and np.isfinite(s_p).all() and (s_p > 0).all()
    np.testing.assert_allclose(s_p, np.asarray(s_j), rtol=1e-4)
    np.testing.assert_allclose(ms_p, np.asarray(ms_j), atol=1e-4)
    np.testing.assert_allclose(Vs_p, np.asarray(Vs_j), atol=1e-4)
    _, ms_1, Vs_1 = run_kalman_smoother(*_t(ys, m0s, S0s, As, Cs, Qs, np.swapaxes(ev, 0, 1)),
                                        smooth_param=list(map(float, s_p)))
    np.testing.assert_allclose(ms_p, ms_1.numpy(), atol=1e-6)
    np.testing.assert_allclose(Vs_p, Vs_1.numpy(), atol=1e-6)


def test_sharded_outputs_are_distributed(rng):
    """Eight shards of one keypoint each: the shapes and finite values of
    the JAX test, and the JAX package's four-device results on the same
    inputs (the sharding does not change a lane's result)."""
    ys, m0s, S0s, As, Qs, Cs, ev = _toy(rng, 8)
    s, ms, Vs = optimize_and_smooth_sharded(ys, m0s, S0s, As, Qs, Cs, ev, mesh=make_mesh(8, "cpu"))
    assert ms.shape == (8, 80, 2) and np.isfinite(ms).all()
    s_j, ms_j, _ = jax_optimize_and_smooth_sharded(ys, m0s, S0s, As, Qs, Cs, ev, mesh=jax_make_mesh(4))
    np.testing.assert_allclose(s, np.asarray(s_j), rtol=1e-4)
    np.testing.assert_allclose(ms, np.asarray(ms_j), atol=1e-4)


@pytest.fixture(scope="module")
def problem_k5():
    """The K = 5, T = 120 run_kalman_smoother problem of tests/test_parallel.py, with the
    JAX package's one-device and eight-device results."""
    ys, args = _smoother_problem(np.random.default_rng(0), 5, 120)
    one = jax_run_kalman_smoother(ys=ys, **args)
    mesh8 = jax_run_kalman_smoother(ys=ys, **args, devices=8)
    return ys, args, [tuple(np.asarray(x) for x in r) for r in (one, mesh8)]


def test_devices_flag_in_run_kalman_smoother(problem_k5):
    """run_kalman_smoother(devices=8) (five keypoints over eight shards:
    three shards stay empty) against the JAX package's devices=8 at the JAX
    test's limits, and bit for bit against the port's one-device run."""
    ys, args, (_, (s_j, m_j, v_j)) = problem_k5
    s8, m8, v8 = _port_smoother(ys, args, devices=8)
    s1, m1, v1 = _port_smoother(ys, args)
    np.testing.assert_allclose(s8, s_j, rtol=1e-4)
    np.testing.assert_allclose(m8, m_j, atol=1e-4)
    np.testing.assert_allclose(v8, v_j, atol=1e-4)
    assert m8.shape == (5, 120, 2)
    np.testing.assert_array_equal(s8, s1)
    np.testing.assert_array_equal(m8, m1)
    np.testing.assert_array_equal(v8, v1)


def test_devices_with_forced_pallas(problem_k5):
    """The JAX test forces its Pallas kernels under the mesh; the port's
    kernels on CPU tensors are their plain versions, which every sharded
    path runs here. The port's devices=8 with the per-shard timings against
    the JAX package's one-device run at the JAX test's limits."""
    ys, args, ((s_j, m_j, v_j), _) = problem_k5
    timings = {}
    s8, m8, v8 = _port_smoother(ys, args, devices=8, timings=timings)
    np.testing.assert_allclose(s8, s_j, rtol=1e-4)
    np.testing.assert_allclose(m8, m_j, atol=1e-4)
    np.testing.assert_allclose(v8, v_j, atol=1e-4)
    assert len(timings["adam_iters_per_shard"]) == 5
    assert timings["adam_iters"] == max(timings["adam_iters_per_shard"]) > 0


def test_devices_with_correlated_blocks(rng):
    """Blocks of keypoints that share s are never split over shards: the
    members share s, and s and the means match the JAX package's devices=8
    at the JAX test's limits."""
    ys, args = _smoother_problem(rng, 5, 80)
    args["blocks"] = [[0, 2], [1], [3, 4]]
    s_j, m_j, _ = jax_run_kalman_smoother(ys=ys, **args, devices=8)
    blocks = args.pop("blocks")
    s8, m8, _ = _port_smoother(ys, args, devices=8, blocks=blocks)
    assert s8[0] == s8[2] and s8[3] == s8[4]
    np.testing.assert_allclose(s8, np.asarray(s_j), rtol=1e-4)
    np.testing.assert_allclose(m8, np.asarray(m_j), atol=1e-4)


# --------------------------------------------------------------------------- #
# time axis
# --------------------------------------------------------------------------- #
def _time_problem(rng, T=512):
    ys = (rng.normal(size=(T, 2)).cumsum(0) * 0.1).astype(np.float32)
    r = rng.uniform(0.1, 1.0, (T, 2)).astype(np.float32)
    eye = np.eye(2, dtype=np.float32)
    return ys, np.zeros(2, np.float32), eye, (0.95 * eye).astype(np.float32), (0.3 * eye).astype(np.float32), eye, r


def test_time_axis_sharded_smoother_matches(rng):
    """smooth_time_sharded over eight shards against the JAX package's
    sequential smoother (ll rtol 1e-4, moments atol 2e-3) and its eight-
    device smooth_time_sharded."""
    ys, m0, S0, A, Q, C, r = _time_problem(rng)
    ll, sm, sP = smooth_time_sharded(ys, m0, S0, A, Q, C, r, mesh=make_mesh(8, "cpu"))
    ref = jax_kalman_smoother(jnp.asarray(ys), jnp.asarray(m0), jnp.asarray(S0), jnp.asarray(A),
                              jnp.asarray(Q), C=jnp.asarray(C), r_diag=jnp.asarray(r))
    np.testing.assert_allclose(float(ll), float(ref.log_likelihood), rtol=1e-4)
    np.testing.assert_allclose(sm, np.asarray(ref.smoothed_means), atol=2e-3)
    np.testing.assert_allclose(sP, np.asarray(ref.smoothed_covs), atol=2e-3)
    ll_j, sm_j, sP_j = jax_smooth_time_sharded(ys, m0, S0, A, Q, C, r, mesh=jax_make_mesh(8))
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-4)
    np.testing.assert_allclose(sm, sm_j, atol=2e-3)
    np.testing.assert_allclose(sP, sP_j, atol=2e-3)


def test_time_axis_sharding_requires_divisible_T():
    with pytest.raises(ValueError, match="divisible"):
        smooth_time_sharded(
            np.zeros((100, 2), np.float32), np.zeros(2, np.float32), *[np.eye(2, dtype=np.float32)] * 4,
            np.ones((100, 2), np.float32), mesh=make_mesh(8, "cpu"),
        )


def test_time_partition_through_run_kalman_smoother(rng):
    """run_kalman_smoother(devices=8, partition="time") through optimizer and
    final pass: against the JAX package's one-device run, both capped at ten
    Adam iterations (on the CPU every shard's plain scan costs its own tens
    of milliseconds an iteration), at the JAX test's limits (s rtol 1e-4,
    moments atol 2e-3); and, in float64, against the port's one-device run
    at 1e-6 (only the chunked scans' order differs)."""
    ys, args = _smoother_problem(rng, 2, 256)
    s1, m1, v1 = jax_run_kalman_smoother(ys=ys, **args, safety_cap=10)
    st, mt, vt = _port_smoother(ys, args, devices=8, partition="time", safety_cap=10)
    np.testing.assert_allclose(st, s1, rtol=1e-4)
    np.testing.assert_allclose(mt, np.asarray(m1), atol=2e-3)
    np.testing.assert_allclose(vt, np.asarray(v1), atol=2e-3)
    t64 = _t(ys, args["m0s"], args["S0s"], args["As"], args["Cs"], args["Qs"], args["ensemble_vars"],
             dtype=torch.float64)
    one = run_kalman_smoother(*t64, safety_cap=5)
    sharded = run_kalman_smoother(*t64, safety_cap=5, devices=8, partition="time")
    np.testing.assert_allclose(sharded[0], one[0], rtol=1e-6)
    for a, b in zip(sharded[1:], one[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("devices", [None, 8])
def test_time_partition_rejects_unknown(devices):
    """An unknown partition raises ValueError naming the partition, with or
    without a mesh, as in the JAX package (the port raised
    NotImplementedError)."""
    kw = dict(ys=np.zeros((1, 8, 2), np.float32), m0s=np.zeros((1, 2)), S0s=np.eye(2)[None], As=np.eye(2)[None],
              Cs=np.eye(2)[None], Qs=np.eye(2)[None], ensemble_vars=np.ones((8, 1, 2), np.float32))
    with pytest.raises(ValueError, match="partition"):
        jax_run_kalman_smoother(**kw, devices=devices, partition="banana")
    with pytest.raises(ValueError, match="partition"):
        _port_smoother(kw.pop("ys"), kw, devices=devices, partition="banana")


def test_time_partition_without_a_mesh_is_ignored(problem_k5):
    """partition="time" with devices None or 1 runs (the JAX package ignores
    the axis without a mesh; the port raised), with the one-device result."""
    ys, args, ((s_j, m_j, _), _) = problem_k5
    s1, m1, v1 = _port_smoother(ys, args)
    for devices in (None, 1):
        s, m, v = _port_smoother(ys, args, devices=devices, partition="time")
        np.testing.assert_array_equal(s, s1)
        np.testing.assert_array_equal(m, m1)
        np.testing.assert_array_equal(v, v1)
    np.testing.assert_allclose(s1, s_j, rtol=1e-4)
    np.testing.assert_allclose(m1, m_j, atol=1e-4)


# --------------------------------------------------------------------------- #
# the sharded scans and the carry combine
# --------------------------------------------------------------------------- #
def _elements(kind, N, T, D, q=0.2):
    """Valid float64 filtering or smoothing elements (N, P, T) from random
    observations, noise and moments, with process noise q I."""
    g = torch.Generator().manual_seed(0)
    dt = torch.float64
    eye = torch.eye(D, dtype=dt)
    A, Q = eye.expand(N, D, D) * 0.9, eye.expand(N, D, D) * q
    if kind == "smoother":
        ms = torch.randn(N, T, D, generator=g, dtype=dt)
        L = torch.randn(N, T, D, D, generator=g, dtype=dt) * 0.3 + eye
        return pkalman._make_smoother_elements(ms, L @ L.transpose(-1, -2) + 0.1 * eye, A, Q)
    ys = torch.randn(N, T, D, generator=g, dtype=dt).cumsum(1)
    r = torch.rand(N, T, D, generator=g, dtype=dt) + 0.5
    return pkalman._make_filter_elements_tv(ys, torch.zeros(N, D, dtype=dt), eye.expand(N, D, D), A, Q,
                                            eye.expand(N, T, D, D), r)


@pytest.mark.parametrize("kind", ["filter", "smoother"])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("sizes", [(40,), (13, 13, 14), (1, 30, 7, 2)])
def test_sharded_scan_matches_the_unsharded_plain_scan(kind, D, sizes):
    """Chunks of uneven length (one step, too), scanned locally and combined
    with their carries (the carry combine's plain version on the CPU),
    against the plain scan of the whole sequence, float and paired, in
    float64 at 1e-9 relative (only the association order differs)."""
    # the tangent along the process noise, as the optimizers differentiate:
    # it keeps C and J symmetric, which the filter combine assumes
    x, dx = torch.func.jvp(lambda q: _elements(kind, 2, sum(sizes), D, q), (torch.tensor(0.2, dtype=torch.float64),),
                           (torch.tensor(1.0, dtype=torch.float64),))
    plain = fused_filter.filter_prefix_plain if kind == "filter" else fused_filter.smoother_suffix_plain
    want, dwant = torch.func.jvp(plain, (x,), (dx,))
    chunks, dchunks = list(torch.split(x, list(sizes), -1)), list(torch.split(dx, list(sizes), -1))
    sharded = filter_prefix_sharded if kind == "filter" else smoother_suffix_sharded
    paired = filter_prefix_paired_sharded if kind == "filter" else smoother_suffix_paired_sharded
    got = torch.cat(sharded([c.contiguous() for c in chunks]), -1)
    got_p = paired([c.contiguous() for c in chunks], [c.contiguous() for c in dchunks])
    for a, b in ((got, want), (torch.cat([p[0] for p in got_p], -1), want),
                 (torch.cat([p[1] for p in got_p], -1), dwant)):
        assert float(((a - b).abs() / (1 + b.abs())).max()) < 1e-9


@pytest.mark.parametrize("kind", ["filter", "smoother"])
def test_carry_combine_plain_is_the_algebras_combine(kind):
    """carry_combine_plain(carry, local) is the algebra's combine of the
    carry with every step, and scan_carried_plain of a chunk from the
    prefix of the steps before it gives the whole scan (the smoother's carry
    is the suffix of the steps after it, the later element)."""
    x = _elements(kind, 3, 25, 2)
    combine = pkalman._combine_filter if kind == "filter" else pkalman._combine_smoother
    carry = x[:, :, 0]
    got = fused_filter.carry_combine_plain(carry, x[:, :, 1:].contiguous(), kind)
    for t in (0, 11, 23):
        assert torch.equal(got[:, :, t:t + 1], combine(carry[..., None], x[:, :, t + 1:t + 2]))
    plain = fused_filter.filter_prefix_plain if kind == "filter" else fused_filter.smoother_suffix_plain
    whole = plain(x)
    if kind == "filter":
        rest = fused_filter.scan_carried_plain(x[:, :, 10:].contiguous(), whole[:, :, 9], kind)
        torch.testing.assert_close(rest, whole[:, :, 10:], rtol=1e-10, atol=1e-10)
    else:
        head = fused_filter.scan_carried_plain(x[:, :, :10].contiguous(), whole[:, :, 10], kind)
        torch.testing.assert_close(head, whole[:, :, :10], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", ["filter", "smoother"])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("paired", [False, True])
def test_chunk_phases_are_their_plain_versions_on_the_cpu(kind, D, paired):
    """On a CPU tensor the two phases of a chunk's carried scan run their
    plain versions: scan_total is the edge of the plain scan (its last step
    for the filter, its first for the smoother), scan_carried is
    carry_combine_plain of the plain scan, and both agree with the plain
    scan of the whole sequence that the chunk and its carry cut; paired,
    torch.func.jvp of the plain versions. Float64, 1e-9 relative."""
    x, dx = torch.func.jvp(lambda q: _elements(kind, 2, 31, D, q), (torch.tensor(0.2, dtype=torch.float64),),
                           (torch.tensor(1.0, dtype=torch.float64),))
    plain = fused_filter.filter_prefix_plain if kind == "filter" else fused_filter.smoother_suffix_plain
    whole, dwhole = torch.func.jvp(plain, (x,), (dx,))
    # the chunk is 24 steps; its carry the 7 steps before it (filter) or after it (smoother)
    cut, edge = (slice(7, None), 6) if kind == "filter" else (slice(None, 24), 24)
    chunk, dchunk = x[..., cut].contiguous(), dx[..., cut].contiguous()
    carry, dcarry = whole[..., edge], dwhole[..., edge]

    def close(a, b):
        assert float(((a - b).abs() / (1 + b.abs())).max()) < 1e-9

    if paired:
        total = fused_filter.scan_total(chunk, kind, dchunk)
        got = fused_filter.scan_carried(chunk, carry, kind, dchunk, dcarry)
        want_total = torch.func.jvp(lambda c: fused_filter.scan_total_plain(c, kind), (chunk,), (dchunk,))
        want = torch.func.jvp(lambda c, a: fused_filter.scan_carried_plain(c, a, kind), (chunk, carry),
                              (dchunk, dcarry))
        edge_of_scan = torch.func.jvp(plain, (chunk,), (dchunk,))
        pairs = [(total[i], want_total[i]) for i in range(2)] + [(got[i], want[i]) for i in range(2)]
        pairs += [(total[i], edge_of_scan[i][..., 0 if kind == "smoother" else -1]) for i in range(2)]
        pairs += [(got[0], whole[..., cut]), (got[1], dwhole[..., cut])]
    else:
        total = fused_filter.scan_total(chunk, kind)
        got = fused_filter.scan_carried(chunk, carry, kind)
        pairs = [(total, fused_filter.scan_total_plain(chunk, kind)),
                 (total, plain(chunk)[..., 0 if kind == "smoother" else -1]),
                 (got, fused_filter.carry_combine_plain(carry, plain(chunk), kind)),
                 (got, whole[..., cut])]
    for a, b in pairs:
        close(a, b)


def _linear_problem(T, D, O, dt=torch.float64, N=2):
    g = torch.Generator().manual_seed(5)
    eye = torch.eye(D, dtype=dt)
    ys = torch.randn(N, T, O, generator=g, dtype=dt).cumsum(1) * 0.3
    C = torch.randn(N, O, D, generator=g, dtype=dt)
    r = torch.rand(N, T, O, generator=g, dtype=dt) + 0.5
    return ys, torch.zeros(N, D, dtype=dt), eye.expand(N, D, D), eye.expand(N, D, D) * 0.9, C, r


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("r_form", ["constant", "time_varying"])
def test_sharded_linear_filter_and_smoother_match_one_shard(n_shards, r_form):
    """kalman_filter_parallel and kalman_smoother_parallel over uneven time
    shards (the prior in the first chunk only, each chunk's first prediction
    from the moments before it, the terminal smoother element in the last
    chunk) against the whole sequence as one shard, with both element
    builders (constant R: the scalar table's planes; time-varying R: the
    covariance form), float64 at 1e-9."""
    ys, m0, S0, A, C, r = _linear_problem(37, 2, 3)
    r = r[:, 0] if r_form == "constant" else r
    Q = 0.2 * S0
    shards = TimeShards(make_mesh(n_shards, "cpu"), ys.shape[1])
    one_f = filters.kalman_filter_parallel(ys, m0, S0, A, Q, C, r)
    one_s = filters.kalman_smoother_parallel(ys, m0, S0, A, Q, C, r, compute_ll=True)
    got_f = filters.kalman_filter_parallel(ys, m0, S0, A, Q, C, r, shards=shards)
    got_s = filters.kalman_smoother_parallel(ys, m0, S0, A, Q, C, r, shards=shards, compute_ll=True)
    for a, b in zip((*got_f, *got_s), (*one_f, *one_s)):
        assert float(((a - b).abs() / (1 + b.abs())).max()) < 1e-9
    torch.testing.assert_close(one_s.log_likelihood, one_f.log_likelihood, rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_sharded_pupil_loss_matches_kernel_c_plain_version(n_shards):
    """The pupil optimizer's time-varying-R loss and its derivative along
    log s over uneven time shards (information-form elements and the
    epilogue in matrix form, paired sharded scan) against kernel C's plain
    version on the whole sequence (the unrolled planes), float64 at 1e-9."""
    from eks_tpu_torch.ops.fused_nll import fused_nll_tv_paired

    ys, m0, S0, A, C, r = _linear_problem(41, 3, 8)

    def table(ls):
        return pkalman._pack_scalars_tv(m0, S0, A, torch.exp(ls) * 0.1 * S0, C)

    tab, dtab = torch.func.jvp(table, (torch.tensor(0.3, dtype=torch.float64),),
                               (torch.tensor(1.0, dtype=torch.float64),))
    yr = torch.cat([ys.transpose(1, 2), r.transpose(1, 2)], dim=1)
    want = fused_nll_tv_paired(tab, dtab, yr)
    got = filters.table_nll_tv_paired_sharded(tab, dtab, yr, TimeShards(make_mesh(n_shards, "cpu"), ys.shape[1]))
    for a, b in zip(got, want):
        assert float(((a - b).abs() / (1 + b.abs())).max()) < 1e-9


def test_time_shards_cut_nearly_equal_chunks():
    """T that does not divide the mesh is split into nearly equal chunks
    (not replicated); a T shorter than the mesh takes fewer shards."""
    shards = TimeShards(make_mesh(4, "cpu"), 10)
    assert shards.bounds == ((0, 3), (3, 6), (6, 8), (8, 10))
    assert len(TimeShards(make_mesh(8, "cpu"), 3)) == 3
    x = torch.arange(20.0).reshape(2, 10)
    assert torch.equal(shards.gather(shards.split(x, 1), 1, "cpu"), x)


# --------------------------------------------------------------------------- #
# threads
# --------------------------------------------------------------------------- #
def test_a_worker_thread_gives_the_main_threads_bits():
    """The paired staged loss over four time shards (torch.func.jvp around
    the sharded scans), evaluated by eight worker threads at once with the
    interpreter switching threads every microsecond, gives the bits of the
    main thread: forward-mode AD keeps one dual level per process, and
    ``ops/linalg.py::jvp`` makes the threads take turns at it (without the
    lock a thread fails with "no level exists"). map_shards runs shards in
    turn, in shard order."""
    rng = np.random.default_rng(0)
    N, T = 3, 60
    y = torch.as_tensor(rng.normal(size=(N, T, 2)).cumsum(1), dtype=torch.float32)
    eye = torch.eye(2).expand(N, 2, 2).contiguous()
    table, dtable = torch.func.jvp(
        lambda q: pkalman._pack_scalars(y[:, 0], torch.zeros(N, 2), eye, eye, q, eye, torch.ones(N, 2)),
        (eye * 0.5,), (eye * 0.5,))
    planes = y.transpose(1, 2).contiguous()
    shards = TimeShards(make_mesh(4, "cpu"), T)

    def work():
        return filters._staged_nll_paired(table, dtable, planes, shards)

    main = work()
    seen, errors = [], []

    def worker():
        try:
            seen.append(work())
        except Exception as exc:  # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=worker) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert not errors and len(seen) == 8
    for got in seen:
        assert all(torch.equal(a, b) for a, b in zip(got, main))
    order = []
    assert map_shards(lambda i, x: order.append(i) or x * 2, ["cpu"] * 3, [1, 2, 3]) == [2, 4, 6]
    assert order == [0, 1, 2]


def test_importing_the_parallel_package_loads_no_jax():
    """A fresh interpreter that imports eks_tpu_torch.parallel has loaded
    nothing of JAX or of the JAX package."""
    code = ("import sys, eks_tpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'eks_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                          cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stdout + proc.stderr
