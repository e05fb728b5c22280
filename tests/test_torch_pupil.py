"""The PyTorch port's pupil slice end to end (eks_tpu_torch/models/
ibl_pupil.py): against the committed reference golden and against the JAX
package on the bundled session cropped to 200 frames, the three packaging
quirks, the estimators, the optimizer loop against optax, and the sessions
twin against solo runs. Everything runs on the CPU, through the plain
versions of kernels C and B."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import eks_tpu
import eks_tpu_torch
from eks_tpu.marker_array import MarkerArray as JaxMarkerArray
from eks_tpu.models import ibl_pupil as jax_pupil
from eks_tpu_torch import core
from eks_tpu_torch.marker_array import MarkerArray, input_dfs_to_markerArray
from eks_tpu_torch.models import ibl_pupil
from eks_tpu_torch.utils import format_data, make_dlc_pandas_index
from tests.integration.conftest import DATA, GOLDEN_DIR
from tests.integration.cropping import make_cropped_session

pytestmark = pytest.mark.skipif(not os.path.isdir(DATA), reason="bundled example data missing")

NAMES = ibl_pupil.BODYPART_LIST


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """The bundled pupil session cropped to its first 200 frames (the
    fast-tier goldens' inputs)."""
    return make_cropped_session(
        os.path.join(DATA, "pupil"), str(tmp_path_factory.mktemp("torch_pupil") / "pupil")
    )


@pytest.fixture(scope="module")
def session_array(session):
    dfs, _ = format_data(session)
    return input_dfs_to_markerArray([dfs], NAMES, [""])


def _columns(df):
    return [tuple(map(str, c)) for c in df.columns]


def _dlc_dict(rng, T=50, center=(60.0, 40.0), diam=10.0):
    cx, cy = center
    base = {
        "pupil_top_r": (cx, cy - diam / 2), "pupil_bottom_r": (cx, cy + diam / 2),
        "pupil_right_r": (cx + diam / 2, cy), "pupil_left_r": (cx - diam / 2, cy),
    }
    d = {}
    for kp, (x, y) in base.items():
        d[f"{kp}_x"] = np.full(T, x) + rng.normal(size=T) * 0.1
        d[f"{kp}_y"] = np.full(T, y) + rng.normal(size=T) * 0.1
    return d


def _marker_array(rng, M=4, T=60):
    d = _dlc_dict(rng, T=T)
    arr = np.zeros((M, 1, T, 4, 3))
    for k, kp in enumerate(NAMES):
        base = np.stack([d[f"{kp}_x"], d[f"{kp}_y"]], axis=-1)
        arr[:, 0, :, k, :2] = base[None] + rng.normal(size=(M, T, 2)) * 0.2
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(M, 1, T, 4))
    return MarkerArray(arr, data_fields=["x", "y", "likelihood"])


# --------------------------------------------------------------------------- #
# the whole slice
# --------------------------------------------------------------------------- #
def test_fit_fixed_s_matches_reference_golden_and_jax(session, tmp_path):
    """Fixed [0.99, 0.98] against the reference implementation's output on
    the same 200 frames at its own contract (atol 1e-4), and against the JAX
    package; the saved CSV reads back as the returned table."""
    out = tmp_path / "out.csv"
    df, s_finals, dfs, keypoints = eks_tpu_torch.fit_eks_pupil(
        session, str(out), smooth_params=[0.99, 0.98], device="cpu"
    )
    ref = pd.read_csv(os.path.join(GOLDEN_DIR, "fast_pupil_fixed.csv"), header=[0, 1, 2], index_col=0)
    assert _columns(df) == _columns(ref) and keypoints == NAMES and len(dfs) > 1
    np.testing.assert_allclose(df.to_numpy(), ref.to_numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(s_finals, [0.99, 0.98], atol=1e-6)
    saved = pd.read_csv(out, header=[0, 1, 2], index_col=0)
    np.testing.assert_allclose(saved.to_numpy(), df.to_numpy(), rtol=1e-6)
    df_j, s_j, _, _ = eks_tpu.fit_eks_pupil(session, str(tmp_path / "j.csv"), smooth_params=[0.99, 0.98])
    assert _columns(df) == _columns(df_j)
    # measured on the CPU: 2.0e-6
    np.testing.assert_allclose(df.to_numpy(), df_j.to_numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(s_finals, s_j, atol=1e-7)


def test_fit_auto_s_matches_jax(session_array):
    """Auto-tuned parameters under a small iteration cap (the same on both
    sides; the JAX package runs its generic loss on the CPU, the port the
    plain version of kernel C): [s_diam, s_com] within 5e-4 and the table
    within 1e-2, the reference's contract for this family. Measured on the
    CPU after 40 iterations: 6e-8 and 1.6e-6. ``s_frames`` crops the loss."""
    kw = dict(safety_cap=8, s_frames=[(0, 150)])
    ma_j = JaxMarkerArray(session_array.array, data_fields=session_array.data_fields)
    df_j, s_j = jax_pupil.ensemble_kalman_smoother_ibl_pupil(ma_j, NAMES, **kw)
    timings = {}
    df_p, s_p = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
        session_array, NAMES, device="cpu", timings=timings, **kw
    )
    assert timings["adam_iters"] == 8
    assert set(timings) == {"prep", "optimizer", "final_pass", "package", "adam_iters"}
    assert np.abs(np.asarray(s_p) - [0.98902, 0.97904]).max() > 1e-5  # the optimizer moved
    np.testing.assert_allclose(s_p, s_j, rtol=0, atol=5e-4)
    assert _columns(df_p) == _columns(df_j)
    np.testing.assert_allclose(df_p.to_numpy(), df_j.to_numpy(), rtol=0, atol=1e-2)


def test_sequential_final_pass_matches_parallel(session_array):
    prep = ibl_pupil._pupil_prep(session_array, NAMES, "median", "confidence_weighted_var")
    kw = dict(ys=prep[3], m0=prep[4], S0=prep[5], C=ibl_pupil.PUPIL_C, ensemble_vars=prep[1],
              diameters_var=prep[8], x_var=prep[9], y_var=prep[10], smooth_params=[0.9, 0.95],
              device="cpu")
    s_a, ms_a, Vs_a = ibl_pupil.run_pupil_kalman_smoother(**kw)
    s_b, ms_b, Vs_b = ibl_pupil.run_pupil_kalman_smoother(sequential=True, **kw)
    assert s_a == s_b and ms_a.shape == (200, 3) and Vs_a.shape == (200, 3, 3)
    np.testing.assert_allclose(ms_a, ms_b, atol=2e-4)
    np.testing.assert_allclose(Vs_a, Vs_b, atol=2e-5)


# --------------------------------------------------------------------------- #
# prep, estimators, packaging
# --------------------------------------------------------------------------- #
def test_prep_matches_jax(session_array):
    """Host prep: the ensemble statistics are bit-equal, and the float64
    numpy estimators on top of them therefore are too."""
    ma_j = JaxMarkerArray(session_array.array, data_fields=session_array.data_fields)
    want = jax_pupil._pupil_prep(ma_j, NAMES, "median", "confidence_weighted_var")
    got = ibl_pupil._pupil_prep(session_array, NAMES, "median", "confidence_weighted_var")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("avg_mode,var_mode", [("median", "confidence_weighted_var"), ("mean", "var")])
def test_ensemble_wrapper_matches_jax(session_array, avg_mode, var_mode):
    from eks_tpu.core import ensemble as jax_ensemble

    ma_j = JaxMarkerArray(session_array.array, data_fields=session_array.data_fields)
    want = jax_ensemble(ma_j, avg_mode=avg_mode, var_mode=var_mode)
    got = core.ensemble(session_array, avg_mode=avg_mode, var_mode=var_mode)
    assert got.data_fields == want.data_fields and got.shape == want.shape
    np.testing.assert_array_equal(got.array, want.array)


def test_estimators_with_nans_match_jax():
    rng = np.random.default_rng(0)
    d = _dlc_dict(rng)
    d["pupil_top_r_x"][5] = d["pupil_top_r_y"][5] = np.nan
    d["pupil_right_r_y"][7] = np.nan
    diam, loc = ibl_pupil.get_pupil_diameter(d), ibl_pupil.get_pupil_location(d)
    assert np.isfinite(diam[5]) and np.isfinite(loc[5, 0]) and np.isfinite(loc[7, 1])
    np.testing.assert_allclose(np.delete(diam, 5), 10.0, atol=0.5)
    np.testing.assert_array_equal(diam, jax_pupil.get_pupil_diameter(d))
    np.testing.assert_array_equal(loc, jax_pupil.get_pupil_location(d))
    out = ibl_pupil.add_mean_to_array(np.zeros((4, 4)), ["a_x", "a_y", "b_x", "b_y"], 10.0, 20.0)
    np.testing.assert_array_equal(out["a_x"], np.full(4, 10.0))
    np.testing.assert_array_equal(out["b_y"], np.full(4, 20.0))
    np.testing.assert_array_equal(ibl_pupil.PUPIL_C, jax_pupil.PUPIL_C)
    assert ibl_pupil.BODYPART_LIST == jax_pupil.BODYPART_LIST


def test_packaging_keeps_the_three_reference_quirks():
    rng = np.random.default_rng(1)
    T = 7
    ms, preds, evars = rng.normal(size=(T, 3)), rng.normal(size=(T, 8)), rng.uniform(size=(T, 8))
    a = rng.normal(size=(T, 3, 3))
    Vs = a @ a.transpose(0, 2, 1)
    likes = rng.uniform(size=(T, 4))
    df = ibl_pupil._pupil_package(NAMES, ms, Vs, preds, evars, likes, 3.0, 5.0)
    want = jax_pupil._pupil_package(NAMES, ms, Vs, preds, evars, likes, 3.0, 5.0)
    assert _columns(df) == _columns(want)
    np.testing.assert_array_equal(df.to_numpy(), want.to_numpy())

    def col(kp, label):
        return df[("ensemble-kalman_tracker", kp, label)].to_numpy()

    y_m = ms @ ibl_pupil.PUPIL_C.T
    y_v = np.einsum("ij,tjl,ml->tim", ibl_pupil.PUPIL_C, Vs, ibl_pupil.PUPIL_C)
    # 1. blocks are packed [top, right, bottom, left] under the labels
    #    [top, bottom, right, left]: the block labelled bottom holds right
    np.testing.assert_array_equal(col("pupil_bottom_r", "x"), y_m[:, 4] + 3.0)
    np.testing.assert_array_equal(col("pupil_bottom_r", "x_ens_median"), preds[:, 4])
    np.testing.assert_array_equal(col("pupil_right_r", "y"), y_m[:, 3] + 5.0)
    # 2. block i's likelihood is keypoint i's, not the block's
    np.testing.assert_array_equal(col("pupil_bottom_r", "likelihood"), likes[:, 1])
    # 3. posterior variances are read at (i, i) and (i+1, i+1)
    np.testing.assert_array_equal(col("pupil_right_r", "x_posterior_var"), y_v[:, 2, 2])
    np.testing.assert_array_equal(col("pupil_right_r", "y_posterior_var"), y_v[:, 3, 3])


def test_fixed_params_are_clipped_into_the_model_range(session_array):
    _, s = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
        session_array, NAMES, smooth_params=[1.5, 0.0], device="cpu"
    )
    np.testing.assert_allclose(s, [1 - 1e-3, 1e-3], atol=1e-7)


# --------------------------------------------------------------------------- #
# the optimizer loop
# --------------------------------------------------------------------------- #
def test_masked_adam_on_raw_gradients_matches_optax():
    """``scale_gradient=False`` is ``optax.adam(lr)`` with the pupil stop rule
    on an (N, 2) parameter, lane by lane: a lane that stops freezes while
    the others go on. A quadratic stands in for the filter NLL."""
    target = np.array([[4.0, 3.5], [4.59, 3.9], [1.0, -2.0]], np.float32)
    scale = np.array([30.0, 0.02, 5.0], np.float32)
    u0 = np.tile(np.array([4.59512, 3.89182], np.float32), (3, 1))
    lr, tol, cap = 5e-3, 1e-6, 60

    def loss_and_grad_t(u):
        f = lambda x: (torch.as_tensor(scale) * ((x - torch.as_tensor(target)) ** 2).sum(dim=1)) + 1.0
        loss, vjp = torch.func.vjp(f, u)
        return loss, vjp(torch.ones_like(loss))[0]

    u_p, loss_p, it_p = core._joint_masked_adam(
        loss_and_grad_t, torch.as_tensor(u0), lr, tol, cap, scale_gradient=False
    )
    for i in range(3):
        f = lambda x: scale[i] * jnp.sum((x - target[i]) ** 2) + 1.0
        opt = optax.adam(lr)
        u, state, prev, done, iters = jnp.asarray(u0[i]), None, jnp.inf, False, 0
        state = opt.init(u)
        while not done and iters < cap:
            loss, grad = jax.value_and_grad(f)(u)
            updates, state = opt.update(grad, state)
            u = optax.apply_updates(u, updates)
            rel = tol * abs(np.log(max(float(prev), 1e-12)))
            done = bool(np.isfinite(prev)) and abs(float(loss) - float(prev)) < rel + 1e-6
            prev, iters = loss, iters + 1
        assert int(it_p[i]) == iters
        np.testing.assert_allclose(u_p[i].numpy(), np.asarray(u), rtol=0, atol=2e-6)
        np.testing.assert_allclose(float(loss_p[i]), float(prev), rtol=1e-6)
    assert int(it_p[1]) < cap and int(it_p[0]) == cap  # the flat lane stopped early


def test_non_finite_pupil_nll_counts_as_penalty(monkeypatch):
    """A session whose NLL is not finite sees 1e12 with a zero gradient: its
    parameters stay at the start and it stops after two iterations."""
    def fake_paired(table, dtable, yr):
        ll = -(table[:, 0] ** 2)
        ll = torch.where(torch.arange(ll.shape[0]) < 2, torch.full_like(ll, float("nan")), ll)
        return ll, -2 * table[:, 0] * dtable[:, 0]

    monkeypatch.setattr(ibl_pupil, "fused_nll_tv_paired", fake_paired)
    N, T = 2, 5
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    s, loss, iters = ibl_pupil._pupil_optimize(
        t(np.zeros((N, T, 8))), t(np.ones((N, T, 8))), t(np.zeros((N, 3))), t(np.tile(np.eye(3), (N, 1, 1))),
        t(ibl_pupil.PUPIL_C), ibl_pupil._initial_u(N, "cpu"), t(np.ones(N)), t(np.ones(N)), t(np.ones(N)),
        lr=5e-3, tol=1e-6, safety_cap=6,
    )
    start = ibl_pupil._to_s(ibl_pupil._initial_u(1, "cpu"))[0]  # [0.99, 0.98] squeezed by eps
    np.testing.assert_array_equal(s[0].numpy(), start.numpy())
    assert float(loss[0]) == float(np.float32(1e12)) and int(iters[0]) == 2 and int(iters[1]) == 6
    assert abs(float(s[1, 0]) - float(start[0])) > 1e-5


# --------------------------------------------------------------------------- #
# sessions
# --------------------------------------------------------------------------- #
def test_sessions_batched_match_solo():
    """Equal-length sessions in one joint loop reproduce the per-session
    runs: same loss lanes, same per-lane stop rule."""
    rng = np.random.default_rng(0)
    mas = [_marker_array(rng) for _ in range(3)]
    timings = {}
    batched = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil_sessions(
        mas, safety_cap=6, device="cpu", timings=timings
    )
    assert len(batched) == 3 and timings["adam_iters"] == 6
    for (df_b, s_b), ma in zip(batched, mas):
        df_s, s_s = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(ma, NAMES, safety_cap=6, device="cpu")
        np.testing.assert_allclose(s_b, s_s, rtol=0, atol=1e-6)
        np.testing.assert_allclose(df_b.to_numpy(), df_s.to_numpy(), rtol=1e-5, atol=1e-5)


def test_sessions_fixed_params_and_fallbacks():
    rng = np.random.default_rng(1)
    mas = [_marker_array(rng, T=40) for _ in range(2)]
    run = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil_sessions
    for _, s in run(mas, smooth_params=[0.9, 0.95], device="cpu"):
        np.testing.assert_allclose(s, [0.9, 0.95], atol=1e-6)
    res = run(mas, smooth_params=[[0.9, 0.95], [0.8, 0.85]], device="cpu")
    np.testing.assert_allclose(res[1][1], [0.8, 0.85], atol=1e-6)
    for (df_i, s_i), ma in zip(res, mas):
        df_solo, _ = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
            ma, NAMES, smooth_params=list(s_i), device="cpu"
        )
        np.testing.assert_allclose(df_i.to_numpy(), df_solo.to_numpy(), rtol=1e-5, atol=1e-5)
    # against the JAX package's sessions path at the same fixed parameters
    mas_j = [JaxMarkerArray(ma.array, data_fields=ma.data_fields) for ma in mas]
    res_j = jax_pupil.ensemble_kalman_smoother_ibl_pupil_sessions(
        mas_j, smooth_params=[[0.9, 0.95], [0.8, 0.85]]
    )
    for (df_i, _), (df_j, _) in zip(res, res_j):
        np.testing.assert_allclose(df_i.to_numpy(), df_j.to_numpy(), rtol=0, atol=1e-4)
    # unequal frame counts and a single session fall back to solo runs
    uneven = [_marker_array(rng, T=30), _marker_array(rng, T=45)]
    res = run(uneven, smooth_params=[0.9, 0.95], device="cpu")
    assert res[0][0].shape == (30, 36) and res[1][0].shape == (45, 36)
    assert len(run(mas[:1], smooth_params=[0.9, 0.95], device="cpu")) == 1
    assert run([], device="cpu") == []
    with pytest.raises(ValueError, match="session count"):
        run(mas, smooth_params=[[0.9, 0.95]], device="cpu")


def test_sessions_mixed_fixed_and_tuned_fall_back():
    rng = np.random.default_rng(2)
    mas = [_marker_array(rng, T=40) for _ in range(2)]
    res = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil_sessions(
        mas, smooth_params=[[0.9, 0.95], [None, None]], safety_cap=3, device="cpu"
    )
    np.testing.assert_allclose(res[0][1], [0.9, 0.95], atol=1e-6)
    _, s_solo = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(mas[1], NAMES, safety_cap=3, device="cpu")
    assert res[1][1] == s_solo and np.abs(np.asarray(s_solo) - [0.98902, 0.97904]).max() > 1e-5


def test_fit_sessions_writes_one_csv_per_session(tmp_path):
    rng = np.random.default_rng(3)
    T, sources, saves = 30, [], []
    for s in range(2):
        d = tmp_path / f"sess{s}"
        d.mkdir()
        dlc = _dlc_dict(rng, T=T)
        for m in range(3):
            block = np.zeros((T, 12))
            for k, kp in enumerate(NAMES):
                block[:, 3 * k] = dlc[f"{kp}_x"] + rng.normal(size=T) * 0.2
                block[:, 3 * k + 1] = dlc[f"{kp}_y"] + rng.normal(size=T) * 0.2
                block[:, 3 * k + 2] = rng.uniform(0.8, 1.0, size=T)
            cols = make_dlc_pandas_index(NAMES, labels=["x", "y", "likelihood"])
            pd.DataFrame(block, columns=cols).to_csv(d / f"seed{m}.csv")
        sources.append(str(d))
        saves.append(str(tmp_path / "out" / f"out{s}.csv"))
    results = eks_tpu_torch.fit_eks_pupil_sessions(sources, saves, smooth_params=[0.9, 0.95], device="cpu")
    assert len(results) == 2
    for (df, s_final, input_dfs, names), save in zip(results, saves):
        assert os.path.exists(save) and df.shape == (T, 36)
        assert names == NAMES and len(input_dfs) == 3
        np.testing.assert_allclose(s_final, [0.9, 0.95], atol=1e-6)
    with pytest.raises(ValueError, match="one save_file"):
        eks_tpu_torch.fit_eks_pupil_sessions(sources, saves[:1], device="cpu")


# --------------------------------------------------------------------------- #
# guards
# --------------------------------------------------------------------------- #
def test_cuda_request_without_a_card_raises(session, session_array, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the CUDA request is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eks_tpu_torch.fit_eks_pupil(session, str(tmp_path / "o.csv"), smooth_params=[0.99, 0.98])
    assert not (tmp_path / "o.csv").exists()
    with pytest.raises(RuntimeError, match="is_available"):
        eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(session_array, NAMES)
    with pytest.raises(RuntimeError, match="is_available"):
        eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil_sessions([session_array, session_array])
    with pytest.raises(RuntimeError, match="is_available"):
        eks_tpu_torch.fit_eks_pupil_sessions([session], [str(tmp_path / "p.csv")])


def test_multi_device_request_raises(session_array):
    """``devices=2``, which raised before the multi-device slice was ported,
    now shards the frame axis (two shards of the CPU here) and gives the
    one-device table within 1e-5 (only the chunked scans' order differs)."""
    kw = dict(smooth_params=[0.99, 0.98], device="cpu")
    df1, s1 = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(session_array, NAMES, **kw)
    df2, s2 = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(session_array, NAMES, devices=2, **kw)
    assert s2 == s1
    np.testing.assert_allclose(df2.to_numpy(), df1.to_numpy(), rtol=0, atol=1e-5)
