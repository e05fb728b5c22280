"""The PyTorch port's calibrated multi-camera family against the JAX package
and the committed reference goldens, on identical numpy inputs made from a
seed: the iterated-EKF loss with its hand-paired derivative
(ops/filters.py), the iterated parallel EKF filter and smoother, the device
prep and packaging (models/multicam.py), and the family end to end on the
bundled data/multicam session cropped to 200 frames. On the CPU the scans
run as their plain versions."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eks_tpu
import eks_tpu_torch
from eks_tpu.core import run_kalman_smoother as jax_run_kalman_smoother
from eks_tpu.geometry import CameraGroup as JaxCameraGroup
from eks_tpu.geometry import make_projection_from_camgroup as jax_projection
from eks_tpu.geometry import stack_camera_params as jax_stack_camera_params
from eks_tpu.models import multicam as jax_multicam
from eks_tpu.ops import pkalman as jax_pkalman
from eks_tpu_torch.core import run_kalman_smoother
from eks_tpu_torch.geometry import CameraGroup, make_projection_from_camgroup, stack_camera_params
from eks_tpu_torch.marker_array import MarkerArray
from eks_tpu_torch.models import multicam
from eks_tpu_torch.ops import filters
from eks_tpu_torch.ops.kalman import kalman_filter, kalman_smoother
from tests.integration.conftest import DATA, GOLDEN_DIR
from tests.integration.cropping import make_cropped_session

pytestmark = pytest.mark.skipif(not os.path.isdir(DATA), reason="bundled example data missing")

CALIBRATION = os.path.join(DATA, "multicam", "calibration.toml")
FIELDS = ["x", "y", "likelihood"]


@pytest.fixture(scope="module")
def rig():
    """The bundled two-camera calibration: the port's projector (float32
    and float64, on the CPU) and the JAX package's."""
    group = CameraGroup.load(CALIBRATION)
    h32, _ = make_projection_from_camgroup(group, device="cpu")
    h64, _ = make_projection_from_camgroup(group, device="cpu", dtype=torch.float64)
    hj, _ = jax_projection(JaxCameraGroup.load(CALIBRATION))
    return {"group": group, "h32": h32, "h64": h64, "hj": hj}


@pytest.fixture(scope="module")
def cropped(tmp_path_factory):
    return make_cropped_session(os.path.join(DATA, "multicam"), str(tmp_path_factory.mktemp("cal") / "multicam"))


def _lanes(h64, N=2, T=64, D=3):
    """N lanes of a 3-D random walk seen through the rig (O = 4) with pixel
    noise: ys, m0, S0, A, Q, the constant R, and the walk itself (the warm
    linearization trajectory), float32 numpy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, T, D)).cumsum(axis=1) * 0.02
    ys = h64(torch.as_tensor(x)).numpy() + rng.normal(size=(N, T, 4)) * 2.0
    eye = np.tile(np.eye(D), (N, 1, 1))
    ops = (ys, x[:, :10].mean(axis=1), eye * 0.01, eye, eye * 4e-4, np.abs(rng.normal(size=(N, 4))) + 1.0, x)
    return tuple(a.astype(np.float32) for a in ops)


def _rel(got, want):
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


# --------------------------------------------------------------------------- #
# the EKF loss and its hand-paired derivative
# --------------------------------------------------------------------------- #
def test_ekf_warm_loss_and_paired_derivative_match_jax(rig):
    """ll and d ll / d log s (the tangent dQ = Q) of the iterated-EKF plane
    NLL at N = 2, T = 64, D = 3, O = 4, 3 sweeps from the true walk (the
    warm schedule), against the JAX package's
    ekf_nll_parallel_planes_batched and jax.jvp of it, float32 on both
    sides. Measured gaps per lane against 1 + |JAX|: ll 0, d ll 1.1e-6
    (|ll| ~ 730, |d ll| ~ 20-30); the limits are 2e-6 and 1e-5. The
    unpaired ll is the paired one's computation, bit for bit."""
    ys, m0, S0, A, Q, r, x = _lanes(rig["h64"])
    f = lambda q: jax_pkalman.ekf_nll_parallel_planes_batched(ys, m0, S0, A, q, rig["hj"], r, x)  # noqa: E731
    ll_j, dll_j = jax.jvp(f, (jnp.asarray(Q),), (jnp.asarray(Q),))
    t = [torch.as_tensor(a) for a in (ys, m0, S0, A, Q, r, x)]
    ll, dll = filters.ekf_nll_paired_batched(*t[:5], t[4], rig["h32"], t[5], t[6], n_sweeps=3)
    ll_plain = filters.ekf_nll_parallel_planes_batched(*t[:5], rig["h32"], t[5], t[6], n_sweeps=3)
    np.testing.assert_array_equal(ll_plain.numpy(), ll.numpy())
    assert _rel(ll.numpy(), np.asarray(ll_j)) <= 2e-6
    assert _rel(dll.numpy(), np.asarray(dll_j)) <= 1e-5


def test_ekf_cold_loss_filter_and_smoother_match_jax_and_sequential(rig):
    """From the broadcast prior (the cold schedule), on the lanes of the
    warm test:
      * the EKF loss at 13 sweeps, ll and the hand-paired d ll / d log s,
        against jax.jvp of the JAX package's ekf_parallel with 12
        relinearizations, the loss its CPU optimizer evaluates (the same
        fixed point in the covariance form): ll 2e-6, d ll 1e-5 per lane
        against 1 + |JAX| (measured 2.5e-7 and 2.4e-6);
      * ekf_parallel and eks_parallel (12 relinearizations, covariance-form
        elements, the final pass) against the JAX package's in float32: ll
        2e-6 relative, means 1e-4 and covariances 1e-7 absolute (measured
        1.7e-7, 2.5e-7, 2.4e-9);
      * in float64, against the port's sequential EKF filter and smoother,
        the fixed point: ll 1e-9 relative, moments 1e-9 absolute."""
    ys, m0, S0, A, Q, r, x = _lanes(rig["h64"])
    r_tv = np.broadcast_to(r[:, None], ys.shape).copy()

    @jax.jit
    def jax_cold(q):
        def run(qq):
            res = jax.vmap(lambda y, m, s, a, qv, rv: jax_pkalman.eks_parallel(y, m, s, a, qv, rig["hj"], rv))(
                ys, m0, S0, A, qq, r_tv)
            return res.log_likelihood, res.filtered_means, res.filtered_covs, res.smoothed_means, res.smoothed_covs
        return jax.jvp(run, (q,), (q,))

    want, (dll_j, *_) = jax_cold(jnp.asarray(Q))
    want = [np.asarray(w) for w in want]
    t = [torch.as_tensor(a) for a in (ys, m0, S0, A, Q, r, r_tv)]
    x_prior = t[1][:, None].expand(-1, ys.shape[1], -1)
    ll, dll = filters.ekf_nll_paired_batched(*t[:5], t[4], rig["h32"], t[5], x_prior, n_sweeps=13)
    assert _rel(ll.numpy(), want[0]) <= 2e-6
    assert _rel(dll.numpy(), np.asarray(dll_j)) <= 1e-5
    fr = filters.ekf_parallel(*t[:5], rig["h32"], t[6])
    sr = filters.eks_parallel(*t[:5], rig["h32"], t[6])
    assert sr.log_likelihood is None
    assert _rel(fr.log_likelihood.numpy(), want[0]) <= 2e-6
    for got, w, atol in ((fr.filtered_means, want[1], 1e-4), (fr.filtered_covs, want[2], 1e-7),
                         (sr.smoothed_means, want[3], 1e-4), (sr.smoothed_covs, want[4], 1e-7)):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=atol)

    t64 = [a.double() for a in t]
    seq = kalman_smoother(*t64[:5], None, t64[6], h_fn=rig["h64"])
    seq_f = kalman_filter(*t64[:5], None, t64[5], h_fn=rig["h64"])
    np.testing.assert_array_equal(seq_f.log_likelihood.numpy(), seq.log_likelihood.numpy())
    fr64 = filters.ekf_parallel(*t64[:5], rig["h64"], t64[6], n_iters=30)
    sr64 = filters.eks_parallel(*t64[:5], rig["h64"], t64[6], n_iters=30)
    np.testing.assert_allclose(fr64.log_likelihood.numpy(), seq.log_likelihood.numpy(), rtol=1e-9)
    for got, w in ((fr64.filtered_means, seq.filtered_means), (fr64.filtered_covs, seq.filtered_covs),
                   (sr64.smoothed_means, seq.smoothed_means), (sr64.smoothed_covs, seq.smoothed_covs)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-9)


def test_ekf_paired_derivative_is_the_whole_loss_float64(rig):
    """In float64 the hand-paired d ll / d log s is the derivative of the
    whole loss, the relinearization trajectories' dependence on s included
    (3 sweeps from the walk, 6 from the broadcast prior): against a central
    difference of the loss in log s at rtol 1e-6."""
    ys, m0, S0, A, Q, r, x = (torch.as_tensor(a, dtype=torch.float64) for a in _lanes(rig["h64"]))
    h = rig["h64"]
    for x_init, n_sweeps in ((x, 3), (m0[:, None].expand_as(x), 6)):
        _, dll = filters.ekf_nll_paired_batched(ys, m0, S0, A, Q, Q, h, r, x_init, n_sweeps=n_sweeps)

        def loss(log_s):
            return filters.ekf_nll_parallel_planes_batched(ys, m0, S0, A, math.exp(log_s) * Q, h, r, x_init,
                                                           n_sweeps=n_sweeps)

        eps = 1e-5
        np.testing.assert_allclose(dll.numpy(), ((loss(eps) - loss(-eps)) / (2 * eps)).numpy(), rtol=1e-6)


# --------------------------------------------------------------------------- #
# prep and packaging
# --------------------------------------------------------------------------- #
def _session(group_np, T=61, K=2, M=3, seed=1):
    """(M, C, T, K, 3) ensemble predictions of a 3-D random walk seen
    through the rig, with per-model pixel jitter."""
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(T, K, 3)).cumsum(axis=0) * 0.01
    h64 = make_projection_from_camgroup(group_np, device="cpu", dtype=torch.float64)[0]
    pix = h64(torch.as_tensor(lat)).numpy().reshape(T, K, -1, 2).transpose(2, 0, 1, 3)  # (C, T, K, 2)
    arr = np.zeros((M,) + pix.shape[:3] + (3,), np.float32)
    arr[..., :2] = pix[None] + rng.normal(size=(M,) + pix.shape) * 0.5
    arr[..., 2] = rng.uniform(0.7, 1.0, size=arr.shape[:-1])
    return arr


def test_prep_and_package_match_jax(rig):
    """The device prep (ensemble statistics, undistortion and triangulation,
    the geometric KF init) at an odd frame count, where the lag-1 median
    averages the two middle values (torch.median would take the lower), and
    the reprojection epilogue with its camera-0 variance quirk, output by
    output against the JAX package's at 1e-5 of each output's scale."""
    arr = _session(rig["group"])
    M = arr.shape[0]
    Ks, dists, extr = jax_stack_camera_params(JaxCameraGroup.load(CALIBRATION))
    want = jax_multicam._prep_multicam_nonlinear(
        arr[..., 0], arr[..., 1], arr[..., 2], M, "median", "confidence_weighted_var", Ks, dists, extr)
    cams = [torch.as_tensor(a, dtype=torch.float32) for a in stack_camera_params(rig["group"])]
    t = torch.as_tensor(arr)
    got = multicam._prep_multicam_nonlinear(t[..., 0], t[..., 1], t[..., 2], M, "median",
                                            "confidence_weighted_var", *cams)
    names = ["ys", "evars", "m0s", "S0s", "As", "Qs", "ys_3d"]
    for name, g, w in zip(names, got[1:], [want[i] for i in (0, 1, 2, 3, 4, 5, 7)]):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)

    rng = np.random.default_rng(2)
    ms = np.asarray(want[7]) + rng.normal(size=np.asarray(want[7]).shape).astype(np.float32) * 1e-3
    L = rng.normal(size=ms.shape + (3,)) * 1e-2
    Vs = (L @ np.swapaxes(L, -1, -2)).astype(np.float32)
    sm4_j = np.asarray(jax_multicam._package_multicam_nonlinear(ms, Vs, np.asarray(want[1]), Ks, dists, extr))
    sm4 = multicam._package_multicam_nonlinear(torch.as_tensor(ms), torch.as_tensor(Vs), got[2], *cams).numpy()
    assert sm4.shape == sm4_j.shape
    np.testing.assert_allclose(sm4, sm4_j, rtol=0, atol=1e-5 * float(np.abs(sm4_j).max()))


def test_initialize_kalman_filter_geometric_matches_jax():
    rng = np.random.default_rng(3)
    ys = rng.normal(size=(3, 41, 3)).cumsum(axis=1)
    ys[1, 5] = np.nan
    got = multicam.initialize_kalman_filter_geometric(ys, device="cpu")
    want = jax_multicam.initialize_kalman_filter_geometric(ys)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, equal_nan=True)


# --------------------------------------------------------------------------- #
# the family end to end
# --------------------------------------------------------------------------- #
def _golden(name):
    import pandas as pd

    return pd.read_csv(os.path.join(GOLDEN_DIR, f"{name}.csv"), header=[0, 1, 2], index_col=0)


def _columns(df):
    return [tuple(map(str, c)) for c in df.columns]


def test_fit_calibrated_fixed_s_matches_reference_goldens(cropped, tmp_path):
    """fit_eks_multicam with the calibration, s = 10, on the 200-frame crop:
    camera 0 at 5e-4 (float32 state drift amplified by the focal lengths,
    the goldens' own stated limit; measured 1.3e-4) and the 3-D latents at
    1e-4 (measured 1.8e-6); the 3-D CSV is saved with the camera CSVs and
    the camera names come from the file."""
    dfs, s, _, _, df3d = eks_tpu_torch.fit_eks_multicam(
        cropped, str(tmp_path), calibration=os.path.join(cropped, "calibration.toml"), smooth_param=10.0,
        camera_names=["ignored"], device="cpu")
    for df, name, atol in ((dfs[0], "fast_multicam_cal_cam0", 5e-4), (df3d, "fast_multicam_cal_3d", 1e-4)):
        ref = _golden(name)
        assert _columns(df) == _columns(ref)
        np.testing.assert_allclose(df.to_numpy(), ref.to_numpy(), rtol=0, atol=atol, err_msg=name)
    assert sorted(os.listdir(tmp_path)) == ["multicam_3d_results.csv", "multicam_cam0_results.csv",
                                           "multicam_cam1_results.csv"]
    np.testing.assert_array_equal(s, [10.0] * len(s))


@pytest.mark.parametrize("kw", [dict(s_frames=[(0, 100)]), dict(inflate_vars=True)])
def test_general_route_matches_jax(cropped, tmp_path, kw):
    """The general route (host ensemble, optional variance inflation,
    triangulation, the geometric init; loss-frame cropping) with the
    calibration and s = 10 against the JAX package's on the crop: cameras
    at 5e-4 (measured 3.1e-4), the 3-D latents at 1e-4 (2.9e-6)."""
    cal = os.path.join(cropped, "calibration.toml")
    got = eks_tpu_torch.fit_eks_multicam(cropped, str(tmp_path / "p"), calibration=cal, smooth_param=10.0,
                                         device="cpu", **kw)
    want = eks_tpu.fit_eks_multicam(cropped, str(tmp_path / "j"), calibration=cal, smooth_param=10.0, **kw)
    for a, b in zip(got[0], want[0]):
        assert _columns(a) == _columns(b)
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=0, atol=5e-4)
    np.testing.assert_allclose(got[4].to_numpy(), want[4].to_numpy(), rtol=0, atol=1e-4)


def test_auto_s_on_a_short_rig_matches_jax(rig):
    """The s-optimizer with the projection as the emission, warm-started
    from the triangulated trajectories, both packages capped at three Adam
    iterations from the JAX package's prep: s at rtol 5e-4 and the smoothed
    latents at atol 1e-4."""
    arr = _session(rig["group"], T=60, K=2)
    M = arr.shape[0]
    Ks, dists, extr = jax_stack_camera_params(JaxCameraGroup.load(CALIBRATION))
    ys, evars, m0s, S0s, As, Qs, Cs, ys_3d = (np.asarray(a) for a in jax_multicam._prep_multicam_nonlinear(
        arr[..., 0], arr[..., 1], arr[..., 2], M, "median", "confidence_weighted_var", Ks, dists, extr))
    ev = np.swapaxes(evars, 0, 1)
    s_j, ms_j, _ = jax_run_kalman_smoother(ys, m0s, S0s, As, Cs, Qs, ev, h_fn=rig["hj"], x_init=ys_3d,
                                           safety_cap=3)
    t = [torch.as_tensor(a) for a in (ys, m0s, S0s, As, Cs, Qs, ev)]
    timings = {}
    s_p, ms_p, _ = run_kalman_smoother(*t, h_fn=rig["h32"], x_init=torch.as_tensor(ys_3d), safety_cap=3,
                                       timings=timings)
    assert timings["adam_iters"] == 3
    np.testing.assert_allclose(s_p, np.asarray(s_j), rtol=5e-4)
    np.testing.assert_allclose(ms_p.numpy(), np.asarray(ms_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(devices=2), dict(devices=2, partition="time")])
def test_devices_and_time_partition_still_raise(rig, kw):
    """Multi-device sharding, which raised here before its slice was
    ported, runs for the calibrated family as for the linear one: two
    keypoint shards give the one-device tables bit for bit, two time shards
    within 1e-4 px (the iterated EKF's chunked scans add in another order)."""
    arr = _session(rig["group"], T=20)
    ma = MarkerArray(arr, data_fields=FIELDS)

    def run(**extra):
        return eks_tpu_torch.ensemble_kalman_smoother_multicam(
            ma, ["a", "b"], ["cam0", "cam1"], smooth_param=10.0, camgroup=rig["group"], device="cpu", **extra)

    one, got = run(), run(**kw)
    atol = 1e-4 if kw.get("partition") == "time" else 0.0
    for a, b in zip(got[0] + [got[2]], one[0] + [one[2]]):
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=0, atol=atol)
