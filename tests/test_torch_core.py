"""The PyTorch port's linalg, sequential oracle, ensemble statistics and
s-optimizer (eks_tpu_torch/ops/linalg.py, ops/kalman.py, core.py) against
the JAX package, on identical numpy operands."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eks_tpu import core as jax_core
from eks_tpu.ops import kalman as jax_kalman
from eks_tpu.ops import linalg as jax_linalg
from eks_tpu_torch import core
from eks_tpu_torch.convert import params_from_numpy
from eks_tpu_torch.ops import fused_nll, kalman, linalg


def _spd(rng, *batch, d):
    a = rng.normal(size=(*batch, d, d))
    return (a @ np.swapaxes(a, -1, -2) + d * np.eye(d)).astype(np.float32)


# --------------------------------------------------------------------------- #
# linalg and the sequential oracle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [1, 2, 3, 6, 8])
def test_linalg_matches_jax(d):
    """psd_solve (vector and matrix right-hand sides), small_inv and
    mvn_logpdf in float32; the JAX package solves through LAPACK on the CPU
    and the port through the unrolled Cholesky, hence rtol 1e-5."""
    rng = np.random.default_rng(d)
    a = _spd(rng, 5, d=d)
    bv = rng.normal(size=(5, d)).astype(np.float32)
    bm = rng.normal(size=(5, d, 3)).astype(np.float32)
    y = rng.normal(size=(5, d)).astype(np.float32)
    mu = rng.normal(size=(5, d)).astype(np.float32)
    t = torch.as_tensor
    for got, want in [
        (linalg.psd_solve(t(a), t(bv)), jax_linalg.psd_solve(a, bv)),
        (linalg.psd_solve(t(a), t(bm)), jax_linalg.psd_solve(a, bm)),
        (linalg.small_inv(t(a)), jax_linalg.small_inv(a)),
        (linalg.mvn_logpdf(t(y), t(mu), t(a)), jax_linalg.mvn_logpdf(y, mu, a)),
        (linalg.symmetrize(t(a @ a)), jax_linalg.symmetrize(a @ a)),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_sequential_filter_and_smoother_match_jax():
    rng = np.random.default_rng(5)
    N, T, O, D = 3, 60, 2, 2
    ys = (rng.normal(size=(N, T, O)).cumsum(axis=1) * 0.3).astype(np.float32)
    m0 = rng.normal(size=(N, D)).astype(np.float32)
    S0 = _spd(rng, N, d=D)
    A = np.tile(np.eye(D, dtype=np.float32), (N, 1, 1))
    Q = _spd(rng, N, d=D) * 0.2
    C = (np.tile(np.eye(O, D), (N, 1, 1)) + 0.1 * rng.normal(size=(N, O, D))).astype(np.float32)
    r = (np.abs(rng.normal(size=(N, T, O))) + 0.1).astype(np.float32)
    jr = jax.vmap(lambda y, m, s, a, q, c, rr: jax_kalman.kalman_smoother(y, m, s, a, q, C=c, r_diag=rr))(
        *(jnp.asarray(x) for x in (ys, m0, S0, A, Q, C, r))
    )
    res = kalman.kalman_smoother(torch.as_tensor(ys), *params_from_numpy(m0, S0, A, Q, C, r))
    np.testing.assert_allclose(res.log_likelihood.numpy(), np.asarray(jr.log_likelihood), rtol=1e-5)
    for got, want in [
        (res.filtered_means, jr.filtered_means), (res.filtered_covs, jr.filtered_covs),
        (res.smoothed_means, jr.smoothed_means), (res.smoothed_covs, jr.smoothed_covs),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# ensemble statistics: bit-equal to the JAX package
# --------------------------------------------------------------------------- #
def test_nanmedian_small_bit_parity_with_jnp():
    """Every ensemble size (odd and even), NaN pattern and inf placement:
    bit-identical to jnp.nanmedian (which averages the two middle values;
    torch.nanmedian would return the lower one)."""
    rng = np.random.default_rng(0)
    for m in (1, 2, 3, 4, 5, 6, 8, 16):
        for nan_frac in (0.0, 0.35, 0.9, 1.0):
            a = (rng.normal(size=(m, 23, 7)) * 50).astype(np.float32)
            a[rng.uniform(size=a.shape) < nan_frac] = np.nan
            a[0, 0, 0] = np.inf
            a[-1, 1, 1] = -np.inf
            got = core._nanmedian_small(torch.as_tensor(a), dim=0).numpy()
            want = np.asarray(jnp.nanmedian(jnp.asarray(a), axis=0))
            np.testing.assert_array_equal(got, want)


def _ensemble_planes(rng, M, T=40, K=3):
    x = (rng.normal(size=(M, T, K)) * 30 + 100).astype(np.float32)
    y = (rng.normal(size=(M, T, K)) * 30 - 50).astype(np.float32)
    lh = rng.uniform(0.2, 1.0, size=(M, T, K)).astype(np.float32)
    x[:, 3] = np.nan  # a frame every model dropped
    y[:, 3] = np.nan
    x[0, 5:9, 1] = np.nan  # one model dropped a few frames
    y[M - 1, 7, 2] = np.nan
    return x, y, lh


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("avg_mode,var_mode", [
    ("median", "confidence_weighted_var"), ("median", "var"), ("mean", "confidence_weighted_var"),
])
def test_ensemble_kernel_bit_parity(M, avg_mode, var_mode):
    """NaN rows, an even model count, and the n_models = 1 fallback."""
    x, y, lh = _ensemble_planes(np.random.default_rng(M), M)
    want = np.asarray(jax_core._ensemble_kernel(x, y, lh, M, avg_mode, var_mode, 1000.0))
    got = core._ensemble_kernel(
        torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(lh), M, avg_mode, var_mode, 1000.0
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_nanvar_is_ddof0_like_jnp():
    a = np.array([[1.0, np.nan, 3.0, 4.0], [np.nan] * 4, [2.0, 2.0, 2.0, 5.0]], np.float32)
    got = core._nanvar(torch.as_tensor(a), 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.nanvar(jnp.asarray(a), axis=1)))


def test_device_constant_r_bit_parity_on_even_t():
    rng = np.random.default_rng(3)
    ev = np.abs(rng.normal(size=(4, 250, 2))).astype(np.float32) * 1e-3  # (K, T, O), T even
    ev[0, ::7, 0] = np.nan
    ev[1, :, 1] = 1e-20  # below both floors
    ev[2, :125, 0] = np.nan  # leaves an odd count
    got = core._device_constant_r(torch.as_tensor(ev), 1e-4).numpy()
    want = np.asarray(jax_core._device_constant_r(jnp.asarray(ev), 1e-4))
    np.testing.assert_array_equal(got, want)


def test_device_s_guesses_match_jax():
    rng = np.random.default_rng(4)
    ev = np.abs(rng.normal(size=(2500, 3, 2))).astype(np.float32)  # (T, K, O), > 2000 frames
    ev[10:20, 1, 0] = np.nan
    got = core._device_s_guesses(torch.as_tensor(ev)).numpy()
    want = np.asarray(jax_core._device_s_guesses(jnp.asarray(ev)))
    # the std is summed in another order; after rounding to 5 dp it agrees
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-5)


# --------------------------------------------------------------------------- #
# the s-optimizer
# --------------------------------------------------------------------------- #
def _adam_problem():
    """tests/test_core.py::test_joint_optimizer_loop_matches_vmapped_semantics's
    operands."""
    n_blocks, b_max, T, O, D = 3, 2, 7, 2, 2
    rng = np.random.default_rng(0)
    yB = rng.normal(size=(n_blocks, b_max, T, O)).astype(np.float32)
    rB = rng.uniform(0.5, 1.0, size=(n_blocks, b_max, O)).astype(np.float32)
    m0B = np.zeros((n_blocks, b_max, D), np.float32)
    S0B = np.broadcast_to(np.eye(D, dtype=np.float32), (n_blocks, b_max, D, D)).copy()
    QB = S0B * rng.uniform(0.5, 2.0, size=(n_blocks, b_max, 1, 1)).astype(np.float32)
    mask = np.array([[1.0, 0.0], [1.0, 1.0], [1.0, 1.0]], np.float32)
    s0 = np.array([0.4, -0.3, 0.1], np.float32)
    return yB, rB, m0B, S0B, QB, mask, s0


def test_joint_masked_adam_matches_jax_optimizer_loop(monkeypatch):
    """The port's Adam loop (per-lane state, masked carries, stop rule)
    against the JAX package's joint optimizer with the same injected
    quadratic loss in place of the filter NLL. Iteration counts are equal.
    s is not bit-equal and cannot be: on the CPU, XLA's float32 exp and log
    differ from torch's in the last bit on about a tenth of all inputs
    (torch's are the correctly rounded ones far more often), the loss sees
    exp(log s) from the first iteration on, and 50 Adam steps carry those
    bits along; measured, s ends within 6 ulp (1.8e-7) of the JAX loop's."""
    yB, rB, m0B, S0B, QB, mask, s0 = _adam_problem()

    def fake_batched(yF, m0F, S0F, AF, sQF, CF, rF):
        target = jnp.mean(rF, axis=-1)
        s_log = jnp.log(sQF[:, 0, 0])
        return -(100.0 * (s_log - target) ** 2 + jnp.mean(yF, axis=(1, 2)) ** 2)

    monkeypatch.setattr(jax_core, "filter_nll_parallel_planes_batched", fake_batched)
    fn = jax_core._optimize_blocks.__wrapped__.__wrapped__
    kw = dict(h_fn=None, sequential=False, lr=0.25, s_lo=-8.0, s_hi=8.0, tol=1e-2, safety_cap=50)
    jargs = [jnp.asarray(a) for a in (yB, rB, m0B, S0B, S0B, QB, S0B, mask, s0)]
    sj, lj, ij = fn(*jargs, joint=True, **kw)

    # the port: the same quadratic, reached through the real optimizer with
    # the table packer and the paired kernel replaced
    def fake_pack(y0, m0, S0, A, sQ, C, r):
        return torch.stack([torch.log(sQ[:, 0, 0]), r.mean(dim=-1)], dim=-1)

    def fake_paired(table, dtable, y_planes):
        def ll(tab):
            return -(100.0 * (tab[:, 0] - tab[:, 1]) ** 2 + y_planes.mean(dim=(1, 2)) ** 2)

        return torch.func.jvp(ll, (table,), (dtable,))

    monkeypatch.setattr(fused_nll, "_pack_scalars", fake_pack)
    monkeypatch.setattr(fused_nll, "fused_nll_paired", fake_paired)
    t = torch.as_tensor
    sp, lp, ip = core._optimize_blocks_joint(
        t(yB), t(rB), t(m0B), t(S0B), t(S0B), t(QB), t(S0B), t(mask), t(s0),
        lr=0.25, s_lo=-8.0, s_hi=8.0, tol=1e-2, safety_cap=50,
    )
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=0, atol=4 * np.finfo(np.float32).eps)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-6)


def test_non_finite_member_nll_counts_as_penalty(monkeypatch):
    """A block whose member NLL is not finite sees loss 1e12 and a zero
    gradient: its s stays at the initial guess and it stops after two
    iterations (reference guard eks/core.py:471)."""
    yB, rB, m0B, S0B, QB, mask, s0 = _adam_problem()

    def fake_pack(y0, m0, S0, A, sQ, C, r):
        return torch.stack([torch.log(sQ[:, 0, 0]), r.mean(dim=-1)], dim=-1)

    def fake_paired(table, dtable, y_planes):
        ll = -100.0 * (table[:, 0] - table[:, 1]) ** 2
        dll = -200.0 * (table[:, 0] - table[:, 1]) * (dtable[:, 0] - dtable[:, 1])
        bad = torch.zeros_like(ll, dtype=torch.bool)
        bad[0] = True  # block 0's only member
        return torch.where(bad, float("nan"), ll), dll

    monkeypatch.setattr(fused_nll, "_pack_scalars", fake_pack)
    monkeypatch.setattr(fused_nll, "fused_nll_paired", fake_paired)
    t = torch.as_tensor
    s, loss, iters = core._optimize_blocks_joint(
        t(yB), t(rB), t(m0B), t(S0B), t(S0B), t(QB), t(S0B), t(mask), t(s0),
        lr=0.25, s_lo=-8.0, s_hi=8.0, tol=1e-2, safety_cap=50,
    )
    assert float(loss[0]) == float(np.float32(1e12))
    assert int(iters[0]) == 2
    assert float(s[0]) == float(s0[0])
    assert int(iters[1]) > 2


def _block_sums_then_update(s_log, mu, nu, count, prev_loss, iters, done, lls, dlls, mask, b_max, lr, tol, cap):
    """One iteration of the s-optimizer as its loop ran it before the Adam
    step was one function: the stop test's lanes, ``_block_nll_sums``, then
    the update and the masked commits, each line as it stood."""
    n_blocks = s_log.shape[0]
    b1, b2, eps = 0.9, 0.999, 1e-8
    dt, dev = s_log.dtype, s_log.device
    floor = torch.tensor(1e-12, dtype=dt, device=dev)
    b1_t = torch.tensor(b1, dtype=dt, device=dev)
    b2_t = torch.tensor(b2, dtype=dt, device=dev)
    active = ~done & (iters < cap)
    finite = torch.isfinite(lls)
    nll = torch.where(finite, -lls, torch.full_like(lls, 1e12))
    dnll = torch.where(finite, -dlls, torch.zeros_like(dlls))
    loss = (nll * mask).reshape(n_blocks, b_max).sum(dim=1)
    grad = (dnll * mask).reshape(n_blocks, b_max).sum(dim=1)
    g = grad * lr
    mu_new = (1 - b1) * g + b1 * mu
    nu_new = (1 - b2) * (g * g) + b2 * nu
    count_new = count + 1
    cf = count_new.to(dt).reshape((n_blocks,))
    mu_hat = mu_new / (1 - torch.pow(b1_t, cf))
    nu_hat = nu_new / (1 - torch.pow(b2_t, cf))
    s_new = s_log + -1.0 * (mu_hat / (torch.sqrt(nu_hat + 0.0) + eps))
    rel_tol = tol * torch.abs(torch.log(torch.maximum(prev_loss, floor)))
    stop = torch.isfinite(prev_loss) & (torch.abs(loss - prev_loss) < rel_tol + 1e-6)
    return (torch.where(active, s_new, s_log), torch.where(active, mu_new, mu), torch.where(active, nu_new, nu),
            torch.where(active, count_new, count), torch.where(active, loss, prev_loss),
            torch.where(active, iters + 1, iters), torch.where(active, stop, done))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bits (NaN, inf and the sign of zero too)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}.get(a.dtype)
    return torch.equal(a.view(bits), b.view(bits)) if bits else torch.equal(a, b)


@pytest.mark.parametrize("b_max,dtype", [(1, torch.float32), (3, torch.float32), (3, torch.float64)])
def test_plain_adam_step_is_the_former_loop_body_bit_for_bit(b_max, dtype):
    """``adam_step.adam_step_plain`` against the loop body it replaced, on
    recorded member sequences (a NaN member, padded blocks at b_max = 3, a
    block that reaches the cap, blocks that stop at other iterations):
    every state tensor, at every iteration, bit for bit; and
    ``_joint_masked_adam`` on the same sequence ends where the former loop
    ends."""
    from eks_tpu_torch.ops import adam_step

    from tests.adam_sequences import member_sequences, replay

    cap, lr, tol = 30, 0.25, 1e-2
    lls, dlls, mask, s0 = (torch.as_tensor(a).to(dtype) for a in member_sequences(6, b_max, cap, seed=b_max))
    former = adam_step.adam_state(s0)
    step = adam_step.AdamStep(s0, mask, b_max, lr, tol, cap)
    n_iter = 0
    while step.running():
        former = _block_sums_then_update(*former, lls[n_iter], dlls[n_iter], mask, b_max, lr, tol, cap)
        step.step(lls[n_iter], dlls[n_iter])
        n_iter += 1
        for name, a, b in zip(adam_step.AdamState._fields, step.state, former):
            assert _same_bits(a, b), (n_iter, name)
    iters = former[5]
    assert int(iters[1]) == cap and bool(former[6][2]) and float(former[4][2]) > 0.99e12
    assert len(set(iters.tolist())) >= 3  # blocks stopped at other iterations
    timings = {}
    got = core._joint_masked_adam(adam_step.MemberNLL(replay(lls, dlls, "cpu"), mask, b_max), s0, lr, tol, cap,
                                  timings)
    assert timings["adam_iters"] == n_iter == int(iters.max())
    for a, b in zip(got, (former[0], former[4], former[5])):
        assert _same_bits(a, b)


def test_adam_step_takes_the_plain_version_on_the_cpu_and_in_float64(monkeypatch):
    """CPU tensors, float32 or float64, step through ``adam_step_plain``,
    once an iteration, and count no kernel launch."""
    from eks_tpu_torch import tracing
    from eks_tpu_torch.ops import adam_step

    from tests.adam_sequences import member_sequences, replay

    calls = []
    plain = adam_step.adam_step_plain
    monkeypatch.setattr(adam_step, "adam_step_plain", lambda *a: calls.append(a[1].dtype) or plain(*a))
    before = tracing.snapshot()
    for dtype in (torch.float32, torch.float64):
        lls, dlls, mask, s0 = (torch.as_tensor(a).to(dtype) for a in member_sequences(4, 1, 5))
        timings = {}
        core._joint_masked_adam(adam_step.MemberNLL(replay(lls, dlls, "cpu"), mask, 1), s0, 0.25, 1e-2, 5, timings)
        assert calls.count(dtype) == timings["adam_iters"] == 5
    assert tracing.snapshot() == before


def _toy_smoother_problem(rng, K=3, T=80):
    ys = (rng.normal(size=(K, T, 2)).cumsum(axis=1)).astype(np.float32)
    ev = (np.abs(rng.normal(size=(T, K, 2))) * 0.5 + 0.1).astype(np.float32)
    S0s = np.tile(np.eye(2, dtype=np.float32) * 4.0, (K, 1, 1))
    eye = np.tile(np.eye(2, dtype=np.float32), (K, 1, 1))
    return ys, np.zeros((K, 2), np.float32), S0s, eye, ev


def test_run_kalman_smoother_auto_s_with_blocks_matches_jax():
    """Auto-s with a partial block list (keypoint 1 becomes a singleton
    block) and an s_frames crop, against the JAX package on the CPU (whose
    loss there is its generic parallel filter, not the fused kernel): s at
    rtol 5e-4, smoothed means at atol 1e-4."""
    ys, m0s, S0s, eye, ev = _toy_smoother_problem(np.random.default_rng(7))
    blocks, s_frames = [[0, 2]], [(0, 60)]
    s_j, ms_j, _ = jax_core.run_kalman_smoother(
        ys, m0s, S0s, eye, eye, eye, ev, s_frames=s_frames, blocks=blocks
    )
    t = torch.as_tensor
    s_p, ms_p, _ = core.run_kalman_smoother(
        t(ys), t(m0s), t(S0s), t(eye), t(eye), t(eye), t(ev), s_frames=s_frames, blocks=blocks
    )
    assert s_p[0] == s_p[2] and s_p[1] != s_p[0]
    np.testing.assert_allclose(s_p, np.asarray(s_j), rtol=5e-4)
    np.testing.assert_allclose(ms_p.numpy(), np.asarray(ms_j), rtol=0, atol=1e-4)


def test_run_kalman_smoother_sequential_matches_parallel():
    """``sequential=True`` (the sequential filter's NLL and smoother) and the
    parallel path tune s to the same optimum."""
    ys, m0s, S0s, eye, ev = _toy_smoother_problem(np.random.default_rng(8), K=2, T=40)
    t = torch.as_tensor
    args = (t(ys), t(m0s), t(S0s), t(eye), t(eye), t(eye), t(ev))
    s_par, ms_par, _ = core.run_kalman_smoother(*args)
    s_seq, ms_seq, _ = core.run_kalman_smoother(*args, sequential=True)
    np.testing.assert_allclose(s_par, s_seq, rtol=1e-3)
    np.testing.assert_allclose(ms_par.numpy(), ms_seq.numpy(), atol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(devices=2), dict(partition="time"), dict(h_fn=lambda x: x, devices=2),
])
def test_unported_options_raise(kw):
    """The options that raised before the multi-device slice was ported now
    run: two keypoint shards on the CPU, and ``partition="time"`` without a
    mesh (not read there, as in the JAX package), give the one-device
    result bit for bit."""
    ys, m0s, S0s, eye, ev = _toy_smoother_problem(np.random.default_rng(0), T=10)
    t = torch.as_tensor
    args = (t(ys), t(m0s), t(S0s), t(eye), t(eye), t(eye), t(ev))
    h_fn = kw.pop("h_fn", None)
    s1, ms1, Vs1 = core.run_kalman_smoother(*args, smooth_param=1.0, h_fn=h_fn)
    s, ms, Vs = core.run_kalman_smoother(*args, smooth_param=1.0, h_fn=h_fn, **kw)
    np.testing.assert_array_equal(s, s1)
    assert torch.equal(ms, ms1) and torch.equal(Vs, Vs1)
