"""The PyTorch port's camera geometry (eks_tpu_torch/geometry/) against the
JAX package and against OpenCV on identical numpy inputs made from a seed:
Rodrigues both ways, distortion and projection, undistortion, the batched
DLT, the stacked camera parameters and the calibration TOML loader (the
bundled data/multicam/calibration.toml). The cv2 comparisons run in float64
at 1e-6, as tests/test_geometry.py holds the JAX package; the JAX
comparisons in float32, the precision both packages compute in."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eks_tpu import geometry as jax_geometry
from eks_tpu_torch import geometry
from eks_tpu_torch.geometry import camera
from eks_tpu_torch.ops.kalman import emission_jacobian
from tests.integration.conftest import DATA

cv2 = pytest.importorskip("cv2")

CALIBRATION = os.path.join(DATA, "multicam", "calibration.toml")
F64 = dict(device="cpu", dtype=torch.float64)


def _camera(seed, n_dist=5):
    """(rvec, tvec, K, dist) of a random camera, distortion scaled per
    coefficient into the invertible regime."""
    rng = np.random.default_rng(seed)
    scale = np.array([0.1, 0.01, 0.001, 0.001, 0.001, 0.01, 0.001, 0.0001, 0.001, 0.001, 0.001, 0.001])
    return (rng.normal(size=3) * 0.5, np.array([0.1, -0.2, 5.0]) + rng.normal(size=3) * 0.1,
            np.array([[800.0, 0.0, 320.0], [0.0, 820.0, 240.0], [0.0, 0.0, 1.0]]),
            rng.normal(size=n_dist) * scale[:n_dist])


def _points(seed, N=100, spread=1.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 3))
    X[:, 2] = np.abs(X[:, 2]) + 0.5
    X[:, :2] *= spread * X[:, 2:3] / 3.0
    return X


def _group(seed, n_cams=3):
    rng = np.random.default_rng(seed)
    cams = []
    for c in range(n_cams):
        K = np.array([[700.0 + 50 * c, 0, 300.0], [0, 700.0 + 50 * c, 250.0], [0, 0, 1]])
        cams.append(geometry.Camera(name=f"cam{c}", matrix=K, dist=np.array([0.05, -0.01, 0.001, 0.001, 0.0]),
                                    rvec=rng.normal(size=3) * 0.3, tvec=np.array([0.5 * c - 0.5, 0.1 * c, 4.0 + c])))
    return geometry.CameraGroup(cams)


# --------------------------------------------------------------------------- #
# Rodrigues
# --------------------------------------------------------------------------- #
def test_rodrigues_matches_cv2_and_jax():
    """Both branches (below and above the 1e-12 angle) against
    cv2.Rodrigues in float64 at 1e-10, a batch of vectors at once, and the
    JAX package's in float32 at 1e-6; inverse_rodrigues round-trips and
    matches cv2 at 1e-8, near pi and at the identity too."""
    rng = np.random.default_rng(0)
    rvecs = np.stack([[1e-11, -2e-11, 3e-11]] + [rng.normal(size=3) for _ in range(5)])
    R = geometry.rodrigues(torch.as_tensor(rvecs)).numpy()
    for rv, R_ours in zip(rvecs, R):
        np.testing.assert_allclose(R_ours, cv2.Rodrigues(rv)[0], atol=1e-10)
        R_jax = np.asarray(jax_geometry.rodrigues(jnp.asarray(rv, dtype=jnp.float32)))
        np.testing.assert_allclose(geometry.rodrigues(torch.as_tensor(rv, dtype=torch.float32)).numpy(),
                                   R_jax, atol=1e-6)
        if np.linalg.norm(rv) > 1e-6:
            np.testing.assert_allclose(geometry.inverse_rodrigues(R_ours), rv, atol=1e-8)
            np.testing.assert_allclose(geometry.inverse_rodrigues(cv2.Rodrigues(rv)[0]), rv, atol=1e-8)
    rv = np.array([np.pi - 1e-8, 0.0, 0.0])
    back = geometry.inverse_rodrigues(geometry.rodrigues(torch.as_tensor(rv)).numpy())
    np.testing.assert_allclose(np.abs(back), rv, atol=1e-5)
    np.testing.assert_allclose(geometry.inverse_rodrigues(np.eye(3)), np.zeros(3))


def test_parse_dist_pads_and_labels():
    d = geometry.parse_dist(np.array([0.1, -0.2, 0.01, -0.01, 0.001]))
    assert float(d["k1"]) == pytest.approx(0.1) and float(d["k3"]) == pytest.approx(0.001)
    assert all(float(d[n]) == 0.0 for n in ["k4", "k5", "k6", "s1", "s2", "s3", "s4"])
    d14 = geometry.parse_dist(np.arange(14) / 100.0)
    assert float(d14["s4"]) == pytest.approx(0.11) and "tx" not in d14
    batched = geometry.parse_dist(torch.arange(28.0).reshape(2, 14))
    np.testing.assert_array_equal(batched["p2"].numpy(), [3.0, 17.0])


# --------------------------------------------------------------------------- #
# projection and undistortion
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_dist", [0, 5, 8, 12])
def test_projection_matches_cv2_and_jax(n_dist):
    """make_projection_fn against cv2.projectPoints in float64 at 1e-6 (the
    rational model at 8 coefficients, thin prism at 12), and against the JAX
    package's projector in float32 at 1e-3 pixels (a pixel of ~800 carries
    float32 rounding of ~1e-4)."""
    rvec, tvec, K, dist = _camera(n_dist, max(n_dist, 5))
    if n_dist == 0:
        dist = np.zeros(5)
    X = _points(n_dist)
    uv_cv, _ = cv2.projectPoints(X, rvec.reshape(3, 1), tvec.reshape(3, 1), K, dist)
    uv = geometry.make_projection_fn(rvec, tvec, K, dist, **F64)(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(uv, uv_cv.reshape(-1, 2), atol=1e-6)
    uv32 = geometry.make_projection_fn(rvec, tvec, K, dist, device="cpu")(torch.as_tensor(X, dtype=torch.float32))
    uv_jax = jax_geometry.make_projection_fn(rvec, tvec, K, dist)(jnp.asarray(X, dtype=jnp.float32))
    np.testing.assert_allclose(uv32.numpy(), np.asarray(uv_jax), atol=1e-3)


def test_projection_with_skew():
    rvec, tvec, K, dist = _camera(1)
    K[0, 1] = 2.5
    X = _points(1, 10)
    Xc = X @ cv2.Rodrigues(rvec)[0].T + tvec
    xn = Xc[:, :2] / Xc[:, 2:3]
    want = np.stack([K[0, 0] * xn[:, 0] + K[0, 1] * xn[:, 1] + K[0, 2], K[1, 1] * xn[:, 1] + K[1, 2]], axis=-1)
    got = geometry.make_projection_fn(rvec, tvec, K, np.zeros(5), **F64)(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-8)


@pytest.mark.parametrize("n_dist", [5, 8])
def test_undistort_points_matches_cv2_and_jax(n_dist):
    """The 5-iteration fixed point against cv2.undistortPoints in float64 at
    1e-6, against the JAX package's in float32 at 1e-6 (normalized
    coordinates of order 1), and converging to the true coordinates at 20
    iterations."""
    _, _, K, dist = _camera(10 + n_dist, n_dist)
    X = _points(n_dist, 50)
    uv = geometry.make_projection_fn(np.zeros(3), np.zeros(3), K, dist, **F64)(torch.as_tensor(X)).numpy()
    und = geometry.undistort_points(torch.as_tensor(uv), K, dist).numpy()
    np.testing.assert_allclose(und, cv2.undistortPoints(uv.reshape(-1, 1, 2), K, dist).reshape(-1, 2), atol=1e-6)
    exact = geometry.undistort_points(torch.as_tensor(uv), K, dist, num_iters=20).numpy()
    np.testing.assert_allclose(exact, X[:, :2] / X[:, 2:3], atol=1e-7)
    und32 = geometry.undistort_points(torch.as_tensor(uv, dtype=torch.float32), K, dist).numpy()
    und_jax = jax_geometry.undistort_points(jnp.asarray(uv, dtype=jnp.float32), K, dist)
    np.testing.assert_allclose(und32, np.asarray(und_jax), atol=1e-6)


def test_multiview_projector_and_its_jacobian_match_jax():
    """The calibrated family's emission h: (..., 3) -> (..., 2C) built from
    the bundled two-camera calibration, against the JAX package's
    make_projection_from_camgroup, and its Jacobian (emission_jacobian)
    against jax.jacfwd: float32 at 1e-3 pixels and 1e-2 pixels per unit
    (focal lengths ~900 amplify float32 rounding); float64 against
    project_multiview's and cv2.projectPoints' at 1e-6, and the per-camera
    heads agree with the combined projector."""
    group, group_j = geometry.CameraGroup.load(CALIBRATION), jax_geometry.CameraGroup.load(CALIBRATION)
    X = _points(2, 40) * 0.3
    h32, heads = geometry.make_projection_from_camgroup(group, device="cpu")
    hj, _ = jax_geometry.make_projection_from_camgroup(group_j)
    x32 = torch.as_tensor(X, dtype=torch.float32)
    np.testing.assert_allclose(h32(x32).numpy(), np.asarray(jax.vmap(hj)(jnp.asarray(x32.numpy()))), atol=1e-3)
    J = emission_jacobian(h32, x32)
    assert J.shape == (40, 4, 3)
    np.testing.assert_allclose(J.numpy(), np.asarray(jax.vmap(jax.jacfwd(hj))(jnp.asarray(x32.numpy()))), atol=1e-2)
    np.testing.assert_allclose(torch.cat([h(x32) for h in heads], dim=-1).numpy(), h32(x32).numpy(), atol=1e-4)

    h64, _ = geometry.make_projection_from_camgroup(group, **F64)
    uv = h64(torch.as_tensor(X)).numpy()
    Ks, dists, _ = geometry.stack_camera_params(group)
    rvecs = np.stack([c.rvec for c in group.cameras])
    tvecs = np.stack([c.tvec for c in group.cameras])
    np.testing.assert_allclose(camera.project_multiview(rvecs, tvecs, Ks, dists, torch.as_tensor(X)).numpy(),
                               uv, atol=1e-9)
    for c, cam in enumerate(group.cameras):
        uv_cv, _ = cv2.projectPoints(X, cam.rvec.reshape(3, 1), cam.tvec.reshape(3, 1), cam.matrix, cam.dist)
        np.testing.assert_allclose(uv[:, 2 * c:2 * c + 2], uv_cv.reshape(-1, 2), atol=1e-6)
        R, t = torch.as_tensor(cam.extrinsics()[:, :3]), torch.as_tensor(cam.tvec)
        pp = geometry.project_point(torch.as_tensor(X), R, t, torch.as_tensor(Ks[c]), torch.as_tensor(dists[c]))
        np.testing.assert_allclose(pp.numpy(), uv[:, 2 * c:2 * c + 2], atol=1e-9)


# --------------------------------------------------------------------------- #
# triangulation and the calibration container
# --------------------------------------------------------------------------- #
def test_triangulate_recovers_points_and_masks_nans():
    """CameraGroup.triangulate (undistortion + batched DLT) recovers
    distorted three-camera views to 1e-5 in float64; a point seen by two
    views is still triangulated, one seen by one comes back NaN."""
    group = _group(3)
    X = _points(3, 40) * 0.3
    pix = np.stack([cam.projection_fn(**F64)(torch.as_tensor(X)).numpy() for cam in group.cameras])
    pix[0, 2] = np.nan
    pix[0, 5] = pix[1, 5] = np.nan
    X_rec = group.triangulate(pix, **F64)
    assert np.isnan(X_rec[5]).all()
    keep = np.arange(40) != 5
    np.testing.assert_allclose(X_rec[keep], X[keep], atol=1e-5)


def test_triangulate_dlt_matches_jax_and_an_svd_oracle():
    """triangulate_dlt on normalized coordinates of noisy views: against an
    SVD null-space oracle in float64 at 1e-6, and against the JAX package's
    in float32 at 1e-5 (the inverse iteration's rounding)."""
    group = _group(4)
    rng = np.random.default_rng(4)
    X = _points(4, 30) * 0.3
    extr = np.stack([c.extrinsics() for c in group.cameras])
    norm = []
    for c in range(3):
        Xc = X @ extr[c, :, :3].T + extr[c, :, 3]
        norm.append(Xc[:, :2] / Xc[:, 2:3] + rng.normal(size=(30, 2)) * 1e-3)
    norm = np.stack(norm)
    got = geometry.triangulate_dlt(torch.as_tensor(norm), torch.as_tensor(extr)).numpy()
    oracle = np.zeros_like(X)
    for n in range(30):
        A = np.concatenate([norm[:, n, :1] * extr[:, 2] - extr[:, 0], norm[:, n, 1:] * extr[:, 2] - extr[:, 1]])
        p = np.linalg.svd(A)[2][-1]
        oracle[n] = p[:3] / p[3]
    np.testing.assert_allclose(got, oracle, atol=1e-6)
    got32 = geometry.triangulate_dlt(torch.as_tensor(norm, dtype=torch.float32),
                                     torch.as_tensor(extr, dtype=torch.float32)).numpy()
    want32 = jax_geometry.triangulate_dlt(jnp.asarray(norm, dtype=jnp.float32), jnp.asarray(extr, dtype=jnp.float32))
    np.testing.assert_allclose(got32, np.asarray(want32), atol=1e-5)


def test_camgroup_load_and_stack_camera_params_match_jax():
    """The bundled calibration: names, sizes, metadata and every camera
    parameter as the JAX package loads them, the stacked (Ks, dists, extr)
    equal to its stack_camera_params, and the aniposelib-style getters."""
    group, group_j = geometry.CameraGroup.load(CALIBRATION), jax_geometry.CameraGroup.load(CALIBRATION)
    assert [c.name for c in group.cameras] == [c.name for c in group_j.cameras] == ["cam0", "cam1"]
    assert group.metadata == group_j.metadata and group.cameras[0].size == (640, 480)
    for cam, cam_j in zip(group.cameras, group_j.cameras):
        for field in ("matrix", "dist", "rvec", "tvec"):
            np.testing.assert_array_equal(getattr(cam, field), getattr(cam_j, field))
        np.testing.assert_allclose(cam.extrinsics(), cam_j.extrinsics(), atol=1e-15)
        assert cam.get_name() == cam.name and cam.get_camera_matrix() is cam.matrix
    Ks, dists, extr = geometry.stack_camera_params(group)
    assert Ks.shape == (2, 3, 3) and dists.shape == (2, 14) and extr.shape == (2, 3, 4)
    for got, want in zip((Ks, dists, extr), jax_geometry.stack_camera_params(group_j)):
        np.testing.assert_allclose(got, want, atol=1e-15)


def test_camgroup_load_reads_rotation_matrices(tmp_path):
    """A TOML whose rotation is a 3 x 3 matrix loads through
    inverse_rodrigues, as the JAX package's loader does."""
    rv = np.array([0.2, -0.1, 0.3])
    R = cv2.Rodrigues(rv)[0]
    text = open(CALIBRATION).read().replace(
        "rotation = [-0.09144132341582424, 0.015847697302323518, -0.1320625886194994]",
        "rotation = " + str([list(map(float, row)) for row in R]))
    path = tmp_path / "calibration.toml"
    path.write_text(text)
    group, group_j = geometry.CameraGroup.load(str(path)), jax_geometry.CameraGroup.load(str(path))
    np.testing.assert_allclose(group.cameras[0].rvec, rv, atol=1e-12)
    np.testing.assert_array_equal(group.cameras[0].rvec, group_j.cameras[0].rvec)
