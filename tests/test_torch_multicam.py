"""The PyTorch port's linear multi-camera family (eks_tpu_torch/models/
multicam.py and the host code under it) against the JAX package on identical
numpy inputs, and against the committed reference goldens on the bundled
mirrored session cropped to 200 frames. On the CPU the port's kernels run as
their plain versions: kernel A's at (D, O) = (3, 4) for two cameras, the
staged plane NLL with the plain paired scan for six."""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import eks_tpu
import eks_tpu_torch
from eks_tpu.core import run_kalman_smoother as jax_run_kalman_smoother
from eks_tpu.marker_array import MarkerArray as JaxMarkerArray
from eks_tpu.models import multicam as jax_multicam
from eks_tpu_torch.convert import multicam_params_from_numpy
from eks_tpu_torch.core import run_kalman_smoother
from eks_tpu_torch.marker_array import MarkerArray
from eks_tpu_torch.models import multicam
from eks_tpu_torch.utils import format_data
from tests.integration.conftest import DATA, GOLDEN_DIR
from tests.integration.cropping import make_cropped_session

FIELDS = ["x", "y", "likelihood"]
T, K, M = 200, 2, 4


def _session(C, seed=None):
    """(M, C, T, K, 3) ensemble predictions: a 3-D random-walk latent seen
    through random loadings by C cameras, plus per-seed jitter."""
    rng = np.random.default_rng(C if seed is None else seed)
    lat = rng.normal(size=(T, K, 3)).cumsum(axis=0)
    load = rng.normal(size=(K, 2 * C, 3))
    base = np.einsum("tkl,kfl->tkf", lat, load).reshape(T, K, C, 2).transpose(2, 0, 1, 3)
    arr = np.zeros((M, C, T, K, 3), np.float32)
    arr[..., :2] = base[None] + rng.normal(size=(M, C, T, K, 2)) * 0.5
    arr[..., 2] = rng.uniform(0.7, 1.0, size=(M, C, T, K))
    return arr


def _names(C):
    return [f"kp{k}" for k in range(K)], [f"cam{c}" for c in range(C)]


def _jax_prep(arr, quantile=50.0):
    out = jax_multicam._prep_multicam_linear(
        arr[..., 0], arr[..., 1], arr[..., 2], M, "median", "confidence_weighted_var", 3, quantile)
    return [np.asarray(x) for x in out]


def _columns(df):
    return [tuple(map(str, c)) for c in df.columns]


def _tables_close(got, want, atol=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _columns(a) == _columns(b)
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("C", [2, 6])
def test_prep_multicam_linear_matches_jax(C):
    """The device prep, output by output: ensemble statistics, centered
    observations, variances, the KF init (S0 from each keypoint's own valid
    frames, Q from the compacted good sequence), the emission, the means."""
    arr = _session(C)
    want = _jax_prep(arr)
    t = torch.as_tensor(arr)
    got = multicam._prep_multicam_linear(
        t[..., 0], t[..., 1], t[..., 2], M, "median", "confidence_weighted_var", 3, 50.0)
    names = ["stats", "ys", "evars", "m0s", "S0s", "As", "Qs", "Cs", "means"]
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale, err_msg=name)
    # the emission through C Cᵀ as well, which no rotation of near-equal
    # components could move
    Cs_g, Cs_w = got[7].numpy(), want[7]
    np.testing.assert_allclose(Cs_g @ Cs_g.transpose(0, 2, 1), Cs_w @ Cs_w.transpose(0, 2, 1), atol=1e-5)


@pytest.mark.parametrize("n", [200, 201, 7])
def test_percentile_matches_jnp(n):
    """The frame filter compares variances with this threshold. Same formula
    as jnp.percentile: bit-equal where the interpolation weights are 0, 1/2
    or 1 (the default quantile 50 at any length). Elsewhere the fractional
    part of the float32 position q/100 * (n - 1) carries that position's
    rounding (1.5e-5 at 179), and XLA's compiled evaluation rounds it
    another way than an op-by-op one (jnp's own eager evaluation differs from
    its compiled one alike): 1.1e-6 relative measured, 3e-6 allowed."""
    x = np.abs(np.random.default_rng(n).normal(size=(n, 64))).astype(np.float32)
    for q in (50.0, 100.0, 0.0, 75.0, 33.3, 90.0):
        want = np.asarray(jnp.percentile(jnp.asarray(x), q, axis=0))
        got = multicam._percentile_linear(torch.as_tensor(x), q).numpy()
        if q in (50.0, 100.0, 0.0):
            np.testing.assert_array_equal(got, want, err_msg=f"n={n} q={q}")
        else:
            np.testing.assert_allclose(got, want, rtol=3e-6, atol=0, err_msg=f"n={n} q={q}")


@pytest.mark.parametrize("C", [2, 6])
def test_smoother_fixed_s_matches_jax(C):
    """Two cameras and six through the fused route with a fixed s: every
    camera's table and the 3-D latent table at atol 1e-4."""
    arr = _session(C)
    kps, cams = _names(C)
    dfs_j, s_j, df3_j = jax_multicam.ensemble_kalman_smoother_multicam(
        JaxMarkerArray(arr.astype(np.float64), data_fields=FIELDS), kps, cams, smooth_param=[3.0, 7.0])
    timings = {}
    dfs_p, s_p, df3_p = eks_tpu_torch.ensemble_kalman_smoother_multicam(
        MarkerArray(arr, data_fields=FIELDS), kps, cams, smooth_param=[3.0, 7.0], device="cpu",
        timings=timings)
    np.testing.assert_array_equal(s_p, np.asarray(s_j))
    _tables_close(dfs_p, dfs_j)
    _tables_close([df3_p], [df3_j])
    assert set(timings) >= {"prep", "optimizer", "final_pass", "package"}


@pytest.mark.parametrize("C", [2, 6])
def test_auto_s_matches_jax(C):
    """The s-optimizer on the multi-camera model (D = 3, O = 2C), both sides
    capped at five Adam iterations from the JAX package's prep, carried
    across with convert.py: two cameras take kernel A's plain version at
    (3, 4), six the staged plane NLL. s within 5e-4 relative, the smoothed
    moments within 1e-4. (Uncapped, the port's plain paired versions cost
    about a second per iteration here.)"""
    _, ys, evars, m0s, S0s, As, Qs, Cs, means = _jax_prep(_session(C))
    s_j, ms_j, Vs_j = jax_run_kalman_smoother(
        jnp.asarray(ys), *(jnp.asarray(x) for x in (m0s, S0s, As, Cs, Qs)),
        jnp.swapaxes(jnp.asarray(evars), 0, 1), safety_cap=5)
    m0_t, S0_t, A_t, Q_t, C_t, _ = multicam_params_from_numpy(m0s, S0s, As, Qs, Cs, means)
    timings = {}
    s_p, ms_p, Vs_p = run_kalman_smoother(
        torch.as_tensor(ys), m0_t, S0_t, A_t, C_t, Q_t, torch.as_tensor(evars).transpose(0, 1),
        safety_cap=5, timings=timings)
    assert timings["adam_iters"] == 5
    np.testing.assert_allclose(s_p, np.asarray(s_j), rtol=5e-4)
    assert not np.allclose(s_p, s_p[0] * 0 + np.exp(0.0))  # the optimizer moved s
    np.testing.assert_allclose(ms_p.numpy(), np.asarray(ms_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(Vs_p.numpy(), np.asarray(Vs_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(s_frames=[(0, 150)], smooth_param=4.0),
    dict(inflate_vars=True, smooth_param=4.0),
    dict(s_frames=[(20, 180)], smooth_param=[2.0, 5.0], quantile_keep_pca=75.0, avg_mode="mean", var_mode="var"),
], ids=["s_frames", "inflate", "mean_var_q75"])
def test_general_path_matches_jax(kw):
    """The general (host prep) route: the sklearn-exact PCA, the PCA-latent
    init, the Mahalanobis inflation, host packaging."""
    arr = _session(2, seed=11)
    arr[1, 0, 60:70, :, :2] += 30.0  # one seed of one view strays: variance to inflate
    kps, cams = _names(2)
    dfs_j, s_j, df3_j = jax_multicam.ensemble_kalman_smoother_multicam(
        JaxMarkerArray(arr.astype(np.float64), data_fields=FIELDS), kps, cams, **kw)
    dfs_p, s_p, df3_p = eks_tpu_torch.ensemble_kalman_smoother_multicam(
        MarkerArray(arr, data_fields=FIELDS), kps, cams, device="cpu", **kw)
    np.testing.assert_array_equal(s_p, np.asarray(s_j))
    _tables_close(dfs_p, dfs_j)
    _tables_close([df3_p], [df3_j])


def test_injected_pca_object_is_used():
    """``pca_object`` takes the general route and gives every keypoint the
    injected basis; n_latent = 2 leaves the 3-D table zero."""
    arr = _session(2, seed=5)
    kps, cams = _names(2)
    X = arr[0, :, :, 0, :2].transpose(1, 0, 2).reshape(T, 4)
    pca_p = eks_tpu_torch.stats.PCA(2).fit(X - X.mean(axis=0))
    pca_j = eks_tpu.stats.PCA(2).fit(X - X.mean(axis=0))
    kw = dict(smooth_param=3.0, n_latent=2)
    dfs_j, _, df3_j = jax_multicam.ensemble_kalman_smoother_multicam(
        JaxMarkerArray(arr.astype(np.float64), data_fields=FIELDS), kps, cams, pca_object=pca_j, **kw)
    dfs_p, _, df3_p = eks_tpu_torch.ensemble_kalman_smoother_multicam(
        MarkerArray(arr, data_fields=FIELDS), kps, cams, pca_object=pca_p, device="cpu", **kw)
    _tables_close(dfs_p, dfs_j)
    assert not df3_p.to_numpy().any() and df3_p.shape == df3_j.shape


# --------------------------------------------------------------------------- #
# through the files
# --------------------------------------------------------------------------- #
needs_data = pytest.mark.skipif(not os.path.isdir(DATA), reason="bundled example data missing")


@pytest.fixture(scope="module")
def cropped(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mc")

    def get(name):
        dst = root / name
        if not dst.is_dir():
            make_cropped_session(os.path.join(DATA, name), str(dst))
        return str(dst)

    return get


def _read_golden(name):
    return pd.read_csv(os.path.join(GOLDEN_DIR, f"{name}.csv"), header=[0, 1, 2], index_col=0)


@needs_data
@pytest.mark.parametrize("inflate,golden", [(False, "fast_mirrored_fixed"), (True, "fast_mirrored_inflate_fixed")])
def test_fit_mirrored_matches_reference_golden(cropped, tmp_path, inflate, golden):
    """The bundled mirrored session cropped to 200 frames, s = 3.0, against
    the reference implementation's output at its own contract (atol 1e-4):
    the fused route, and the general route with variance inflation."""
    out = tmp_path / "out.csv"
    df, s_finals, _, bodyparts = eks_tpu_torch.fit_eks_mirrored_multicam(
        cropped("mirrored"), str(out), camera_names=["top", "bot"], smooth_param=3.0,
        inflate_vars=inflate, device="cpu")
    ref = _read_golden(golden)
    assert _columns(df) == _columns(ref)
    np.testing.assert_allclose(df.to_numpy(), ref.to_numpy(), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(s_finals, np.full(len(bodyparts), 3.0))
    saved = pd.read_csv(out, header=[0, 1, 2], index_col=0)
    np.testing.assert_allclose(saved.to_numpy(), df.to_numpy(), rtol=1e-6)


@needs_data
def test_fit_multicam_without_calibration_matches_jax(cropped, tmp_path):
    """The bundled two-camera session read per camera (files matched to
    cameras by name), without its calibration: the linear family."""
    src = cropped("multicam")
    kw = dict(camera_names=["cam0", "cam1"], smooth_param=5.0)
    dfs_j, s_j, in_j, kps_j, df3_j = eks_tpu.fit_eks_multicam(src, str(tmp_path / "j"), **kw)
    dfs_p, s_p, in_p, kps_p, df3_p = eks_tpu_torch.fit_eks_multicam(
        src, str(tmp_path / "p"), device="cpu", **kw)
    assert kps_p == kps_j and [len(x) for x in in_p] == [len(x) for x in in_j] == [3, 3]
    # pixel coordinates of a few hundred: the float32 reprojection C m of
    # latents that large differs by several ulp (3e-5 each at 256) between
    # two eigh implementations, so 1e-4 plus 3e-6 of the value
    for a, b in zip(dfs_p, dfs_j):
        assert _columns(a) == _columns(b)
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=3e-6, atol=1e-4)
    # the latent table is not invariant to the basis: it moves with the
    # eigenvectors themselves, which two float32 eigh implementations give to
    # about 1e-5 of their norm on this session (latents up to 30: 2.7e-4
    # measured); the per-camera tables above see only C m
    _tables_close([df3_p], [df3_j], atol=5e-4)
    assert sorted(os.listdir(tmp_path / "p")) == ["multicam_cam0_results.csv", "multicam_cam1_results.csv"]
    # a {camera: [files]} mapping loads the same frames
    mapping = {c: sorted(os.path.join(src, f) for f in os.listdir(src) if c in f) for c in kw["camera_names"]}
    in_m, kps_m = format_data(mapping, camera_names=kw["camera_names"])
    assert kps_m == kps_p
    pd.testing.assert_frame_equal(in_m[1][2], in_p[1][2])
    with pytest.raises(FileNotFoundError):
        format_data(src, camera_names=["cam0", "cam7"])


def test_what_is_not_ported_raises(tmp_path):
    """Multi-device sharding, which raised before its slice was ported, now
    runs: two keypoint shards and two time shards on the CPU give the
    one-device tables (bit for bit on the keypoint axis, 1e-5 on the time
    axis, where only the chunked scans' order differs). Missing camera names
    raise, and so does a CUDA request without a card."""
    arr = _session(2)
    kps, cams = _names(2)
    ma = MarkerArray(arr, data_fields=FIELDS)
    one = eks_tpu_torch.ensemble_kalman_smoother_multicam(ma, kps, cams, smooth_param=2.0, device="cpu")
    for kw, atol in ((dict(devices=2), 0.0), (dict(devices=2, partition="time"), 1e-5)):
        got = eks_tpu_torch.ensemble_kalman_smoother_multicam(ma, kps, cams, smooth_param=2.0, device="cpu", **kw)
        np.testing.assert_array_equal(got[1], one[1])
        for a, b in zip(got[0] + [got[2]], one[0] + [one[2]]):
            np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=0, atol=atol)
    with pytest.raises(ValueError, match="camera_names"):
        eks_tpu_torch.fit_eks_multicam(str(tmp_path), str(tmp_path / "o"), device="cpu")
    with pytest.raises(ValueError, match="camera_names"):
        eks_tpu_torch.ensemble_kalman_smoother_multicam(ma, kps, [], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            eks_tpu_torch.ensemble_kalman_smoother_multicam(ma, kps, cams, smooth_param=2.0)
