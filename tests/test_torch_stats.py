"""The PyTorch port's statistics (eks_tpu_torch/stats.py) against the JAX
package's (eks_tpu/stats.py) on identical numpy inputs. The host half (the
sklearn-exact PCA fit, compute_pca, FactorAnalysis, compute_mahalanobis) is a
copy and must agree exactly; the device half (the batched covariance-eigh PCA
fit) agrees at float32 rounding level, compared through the projector CᵀC so
that near-equal eigenvalues cannot rotate the comparison."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eks_tpu import stats as jax_stats
from eks_tpu.marker_array import MarkerArray as JaxMarkerArray
from eks_tpu.models import multicam as jax_multicam
from eks_tpu.utils.frames import center_predictions as jax_center_predictions
from eks_tpu_torch import stats
from eks_tpu_torch.marker_array import MarkerArray, mA_to_stacked_array, stacked_array_to_mA
from eks_tpu_torch.models import multicam
from eks_tpu_torch.utils import center_predictions


def _views(rng, K, N, C, L=3, noise=0.3):
    """(K, N, 2C) multi-view stacks with an L-dimensional latent."""
    lat = rng.normal(size=(K, N, L)).cumsum(axis=1)
    load = rng.normal(size=(K, L, 2 * C))
    return (lat @ load + noise * rng.normal(size=(K, N, 2 * C))).astype(np.float32)


@pytest.mark.parametrize("C,L", [(2, 3), (6, 3), (3, 2)])
def test_pca_fit_batched_matches_jax(C, L):
    X = _views(np.random.default_rng(C), 3, 400, C)
    means_j, comps_j = jax_stats._pca_fit_batched(jnp.asarray(X), L)
    means_p, comps_p = stats._pca_fit_batched(torch.as_tensor(X), L)
    assert comps_p.shape == (3, L, 2 * C)
    np.testing.assert_allclose(means_p.numpy(), np.asarray(means_j), rtol=1e-5, atol=1e-5)
    # the subspace, sign- and rotation-free
    proj_j = np.einsum("klf,klg->kfg", np.asarray(comps_j), np.asarray(comps_j))
    proj_p = np.einsum("klf,klg->kfg", comps_p.numpy(), comps_p.numpy())
    np.testing.assert_allclose(proj_p, proj_j, atol=1e-5)
    # well-separated eigenvalues here: the components themselves, signs fixed
    # by the svd_flip rule
    np.testing.assert_allclose(comps_p.numpy(), np.asarray(comps_j), atol=1e-4)


@pytest.mark.parametrize("N,F", [(400, 4), (30, 4), (500, 12)])
def test_pca_fit_sklearn_exact_is_the_jax_packages(N, F):
    """Both solver branches (covariance_eigh: N >= 10 F; full SVD below)."""
    X = _views(np.random.default_rng(N), 1, N, F // 2)[0]
    for dtype in (np.float32, np.float64):
        mean_j, comps_j = jax_stats._pca_fit_sklearn_exact(X.astype(dtype), 3)
        mean_p, comps_p = stats._pca_fit_sklearn_exact(X.astype(dtype), 3)
        np.testing.assert_array_equal(mean_p, mean_j)
        np.testing.assert_array_equal(comps_p, comps_j)
        assert comps_p.flags.f_contiguous == comps_j.flags.f_contiguous
    pca_j, pca_p = jax_stats.PCA(3).fit(X), stats.PCA(3).fit(X)
    np.testing.assert_array_equal(pca_p.transform(X), pca_j.transform(X))


@pytest.mark.parametrize("svd_method", ["randomized", "lapack"])
def test_factor_analysis_is_the_jax_packages(svd_method):
    X = _views(np.random.default_rng(3), 1, 300, 2)[0].astype(np.float64)
    fa_j = jax_stats.FactorAnalysis(3, svd_method=svd_method).fit(X)
    fa_p = stats.FactorAnalysis(3, svd_method=svd_method).fit(X)
    assert fa_p.n_iter_ == fa_j.n_iter_ and fa_p.loglike_ == fa_j.loglike_
    np.testing.assert_array_equal(fa_p.components_, fa_j.components_)
    np.testing.assert_array_equal(fa_p.noise_variance_, fa_j.noise_variance_)
    np.testing.assert_array_equal(fa_p.mean_, fa_j.mean_)
    A = np.random.default_rng(0).normal(size=(40, 13))
    np.testing.assert_array_equal(stats._plu_factor(A), jax_stats._plu_factor(A))
    np.testing.assert_array_equal(stats._qr_q(A), jax_stats._qr_q(A))


@pytest.mark.parametrize("C,kwargs", [
    (2, {}),
    (2, dict(v_quantile_threshold=None, likelihood_threshold=0.5, with_likes=True)),
    (3, dict(n_latent=2)),
    (2, dict(with_loading=True)),
])
def test_compute_mahalanobis_is_the_jax_packages(C, kwargs):
    rng = np.random.default_rng(C)
    kwargs = dict(kwargs)
    x = _views(rng, 1, 250, C)[0]
    v = (np.abs(rng.normal(size=x.shape)) + 0.1).astype(np.float32)
    if kwargs.pop("with_likes", False):
        kwargs["likelihoods"] = rng.uniform(0.3, 1.0, size=(250, C))
    if kwargs.pop("with_loading", False):
        kwargs["loading_matrix"] = rng.normal(size=(2 * C, 3))
        kwargs["mean"] = rng.normal(size=2 * C)
    got, want = stats.compute_mahalanobis(x, v, **kwargs), jax_stats.compute_mahalanobis(x, v, **kwargs)
    np.testing.assert_array_equal(got["reconstructed"], want["reconstructed"])
    for view in range(C):
        np.testing.assert_array_equal(got["mahalanobis"][view], want["mahalanobis"][view])
        np.testing.assert_array_equal(got["posterior_variance"][view], want["posterior_variance"][view])
    for L in (1, 2, 3, 4):
        A = rng.normal(size=(5, L, L)) + 3 * np.eye(L)
        np.testing.assert_array_equal(stats._inv_batched_small(A), jax_stats._inv_batched_small(A))


def _ensemble_array(rng, C, T, K):
    """A post-ensemble (1, C, T, K, 5) array [x, y, var_x, var_y, likelihood]."""
    arr = np.zeros((1, C, T, K, 5), np.float32)
    arr[0, ..., :2] = _views(rng, K, T, C).reshape(K, T, C, 2).transpose(2, 1, 0, 3)
    arr[0, ..., 2:4] = np.abs(rng.normal(size=(C, T, K, 2))) + 0.05
    arr[0, ..., 4] = rng.uniform(0.6, 1.0, size=(C, T, K))
    return arr


def test_center_predictions_compute_pca_and_kf_init_are_the_jax_packages():
    """The general path's host prep: frame filter and centering, the PCA per
    keypoint with the transform indexed by each keypoint's own good frames,
    and the PCA-latent Kalman init (float64 on the host, float32 operands)."""
    fields = ["x", "y", "var_x", "var_y", "likelihood"]
    arr = _ensemble_array(np.random.default_rng(9), 2, 300, 3)
    got = center_predictions(MarkerArray(arr, data_fields=fields), 60.0)
    want = jax_center_predictions(JaxMarkerArray(arr, data_fields=fields), 60.0)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.array, w.array)
    pca_p, pcs_p = stats.compute_pca(got[0], got[1], got[2], n_components=3)
    pca_j, pcs_j = jax_stats.compute_pca(want[0], want[1], want[2], n_components=3)
    for a, b in zip(pcs_p, pcs_j):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pca_p, pca_j):
        np.testing.assert_array_equal(a.components_, b.components_)
    # an injected PCA object is shared by every keypoint
    shared_p, _ = stats.compute_pca(got[0], got[1], got[2], n_components=3, pca_object=pca_p[0])
    assert all(p is pca_p[0] for p in shared_p)
    init_p = multicam.initialize_kalman_filter_pca(pcs_p, pca_p, 3, device="cpu")
    init_j = jax_multicam.initialize_kalman_filter_pca(pcs_j, pca_j, 3)
    for g, w in zip(init_p, init_j):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_inflation_is_the_jax_packages():
    """The Mahalanobis variance inflation to its fixed point, and the
    stacked-array round trip under it."""
    fields = ["x", "y", "var_x", "var_y", "likelihood"]
    rng = np.random.default_rng(4)
    arr = _ensemble_array(rng, 2, 250, 2)
    arr[0, 0, 40:50, :, :2] += 25.0  # one view disagrees for ten frames
    ma_p, ma_j = MarkerArray(arr, data_fields=fields), JaxMarkerArray(arr, data_fields=fields)
    cen_p, cen_j = center_predictions(ma_p, 50.0)[1], jax_center_predictions(ma_j, 50.0)[1]
    out_p = multicam.mA_compute_maha(
        cen_p, ma_p.slice_fields("var_x", "var_y"), ma_p.slice_fields("likelihood"), 3)
    out_j = jax_multicam.mA_compute_maha(
        cen_j, ma_j.slice_fields("var_x", "var_y"), ma_j.slice_fields("likelihood"), 3)
    np.testing.assert_array_equal(out_p.array, out_j.array)
    assert (out_p.array > arr[..., 2:4]).any()  # something was inflated
    stacked = mA_to_stacked_array(ma_p.slice_fields("var_x", "var_y"), 1)
    assert stacked.shape == (250, 4)
    back = stacked_array_to_mA(stacked, 2, ["var_x", "var_y"])
    np.testing.assert_array_equal(back.array[0, :, :, 0], arr[0, :, :, 1, 2:4])
    v = np.ones((4, 6))
    maha = {0: np.array([[6.0], [0], [0], [0]]), 1: np.zeros((4, 1)), 2: np.array([[0], [0], [7.0], [0]])}
    got, any_p = multicam.inflate_variance(v, maha)
    want, any_j = jax_multicam.inflate_variance(v, maha)
    np.testing.assert_array_equal(got, want)
    assert any_p and any_j and got.sum() == 24 + 2 * 2 * 9
