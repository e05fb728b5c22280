"""The plain reference against float64 computations made another way, and
the control that the check has to refuse."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from check import control_outputs, judge
from harness import judged, load_cell
from reference.ensemble import ensemble_stats
from reference.kalman import kalman_filter, rts_smoother
from reference.precision import FLOAT64, TF32, round_tf32


def _model(rng, N, D, O):
    A = np.stack([np.eye(D) + 0.1 * rng.normal(size=(D, D)) for _ in range(N)])
    Lq = rng.normal(size=(N, D, D))
    Q = Lq @ Lq.transpose(0, 2, 1) + 0.5 * np.eye(D)
    Ls = rng.normal(size=(N, D, D))
    S0 = Ls @ Ls.transpose(0, 2, 1) + np.eye(D)
    C = rng.normal(size=(N, O, D))
    m0 = rng.normal(size=(N, D))
    return m0, S0, A, Q, C


def _dense(m0, S0, A, Q, C, r, ys):
    """The joint Gaussian of the states x_0..x_{T-1} and the observations,
    conditioned on the observations by dense float64 algebra: the
    log-likelihood, and the posterior means and covariances."""
    T, O = ys.shape
    D = m0.shape[0]
    mean_x, cov_x = [m0], [[None] * T for _ in range(T)]
    Ak = [np.eye(D)]
    for _ in range(T):
        Ak.append(A @ Ak[-1])
    for t in range(1, T):
        mean_x.append(A @ mean_x[-1])
    # Cov(x_s, x_t) for s <= t: A^(t-s) Cov(x_s)
    var = [S0]
    for t in range(1, T):
        var.append(A @ var[-1] @ A.T + Q)
    big = np.zeros((T * D, T * D))
    for s in range(T):
        for t in range(s, T):
            blk = Ak[t - s] @ var[s]
            big[t * D:(t + 1) * D, s * D:(s + 1) * D] = blk
            big[s * D:(s + 1) * D, t * D:(t + 1) * D] = blk.T
    H = np.kron(np.eye(T), C)
    mx = np.concatenate(mean_x)
    my = H @ mx
    Syy = H @ big @ H.T + np.diag(r.reshape(-1))
    resid = ys.reshape(-1) - my
    _, logdet = np.linalg.slogdet(Syy)
    ll = -0.5 * (resid @ np.linalg.solve(Syy, resid) + logdet + T * O * math.log(2 * math.pi))
    gain = big @ H.T @ np.linalg.inv(Syy)
    post_m = mx + gain @ resid
    post_c = big - gain @ H @ big
    return ll, post_m.reshape(T, D), np.stack([post_c[t * D:(t + 1) * D, t * D:(t + 1) * D] for t in range(T)])


@pytest.mark.parametrize("D,O", [(2, 2), (3, 4), (1, 3)])
def test_sequential_filter_and_smoother_match_the_dense_gaussian(D, O):
    rng = np.random.default_rng(D * 10 + O)
    N, T = 3, 7
    m0, S0, A, Q, C = _model(rng, N, D, O)
    r = rng.uniform(0.2, 1.5, size=(N, T, O))
    ys = rng.normal(size=(N, T, O)) * 2.0
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    ll, ms, Ps = kalman_filter(t(ys), t(m0), t(S0), t(A), t(Q), t(C), t(r), FLOAT64, keep=N)
    sm, sP = rts_smoother(ms, Ps, t(A), t(Q), FLOAT64)
    for n in range(N):
        want_ll, want_m, want_P = _dense(m0[n], S0[n], A[n], Q[n], C[n], r[n], ys[n])
        assert float(ll[n]) == pytest.approx(want_ll, rel=1e-11, abs=1e-10)
        np.testing.assert_allclose(sm[n].numpy(), want_m, rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(sP[n].numpy(), want_P, rtol=1e-9, atol=1e-10)


def test_constant_noise_is_the_per_step_noise_held():
    rng = np.random.default_rng(3)
    m0, S0, A, Q, C = (torch.as_tensor(x) for x in _model(rng, 2, 2, 2))
    ys = torch.as_tensor(rng.normal(size=(2, 20, 2)))
    r = torch.as_tensor(rng.uniform(0.3, 1.0, size=(2, 2)))
    a = kalman_filter(ys, m0, S0, A, Q, C, r, FLOAT64)
    b = kalman_filter(ys, m0, S0, A, Q, C, r[:, None, :].expand(2, 20, 2), FLOAT64)
    assert torch.equal(a, b)


def test_ensemble_statistics_match_numpy():
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=(2, 5, 30, 4)) * 10
    lh = rng.uniform(0.5, 1.0, size=(5, 30, 4))
    x[1, 3, 2] = np.nan
    x[:, 7, 1] = np.nan
    st = ensemble_stats(*(torch.as_tensor(a) for a in (x, y, lh)), FLOAT64).numpy()
    conf = lh.sum(axis=0) / 5
    with np.errstate(invalid="ignore"), pytest.warns(RuntimeWarning):
        want_vx = np.nan_to_num(np.nanvar(x, axis=0) / conf, nan=1000.0)
        want_mx = np.nanmedian(x, axis=0)
    np.testing.assert_allclose(st[..., 0], want_mx, rtol=1e-14)
    np.testing.assert_allclose(st[..., 1], np.median(y, axis=0), rtol=1e-14)
    np.testing.assert_allclose(st[..., 2], want_vx, rtol=1e-12)
    np.testing.assert_allclose(st[..., 3], np.var(y, axis=0) / conf, rtol=1e-12)
    np.testing.assert_allclose(st[..., 4], conf, rtol=1e-15)
    assert st[7, 1, 2] == 1000.0


def test_tf32_rounding():
    one = 1.0
    vals = torch.tensor([one + 2**-11, one + 3 * 2**-11, one + 2**-10 + 2**-12, -3.0, float("inf"), 1e-30],
                        dtype=torch.float32)
    got = round_tf32(vals).tolist()
    assert got[:4] == [1.0, one + 2**-9, one + 2**-10, -3.0]
    assert got[4] == float("inf")
    assert got[5] == pytest.approx(1e-30, rel=2**-10)
    assert TF32.q(torch.tensor([1 / 3], dtype=torch.float64)).dtype == torch.float32


def _small_cell(name, frames=240, keypoints=3):
    cell = load_cell(name)
    cell.cfg.update(frames=frames, keypoints=keypoints)
    return cell


@pytest.mark.parametrize("name", ["singlecam-auto", "singlecam-fixed-s"])
def test_the_tf32_control_is_refused_and_the_reference_passes(name):
    """The control, the reference in the program's place computed in TF32,
    fails the cell's limits; in float64 it reads 0 and passes."""
    from generators.sessions import session_pool

    cell = _small_cell(name)
    tuned = cell.traffic["smooth_param"] is None
    arrs = session_pool(12345, cell.cfg, 2)
    ctl = judge(cell.cfg, arrs, control_outputs(cell.cfg, arrs, cell.traffic["smooth_param"], TF32, "cpu"),
                tuned, "cpu")
    ok, checks = judged(ctl, cell.limits)
    assert not ok, checks
    same = judge(cell.cfg, arrs, control_outputs(cell.cfg, arrs, cell.traffic["smooth_param"], FLOAT64, "cpu"),
                 tuned, "cpu")
    assert judged(same, cell.limits)[0] and max(same.values()) < 1e-9


@pytest.mark.cuda
def test_the_reference_on_the_card_matches_the_cpu(card):
    from generators.sessions import session_pool

    cell = _small_cell("singlecam-fixed-s")
    arrs = session_pool(7, cell.cfg, 1)
    outs = control_outputs(cell.cfg, arrs, 2.0, FLOAT64, "cpu")
    assert judge(cell.cfg, arrs, outs, False, card)["mean_gap"] < 1e-9
