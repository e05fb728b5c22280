"""The linear multi-camera family at n_latent 1, 2 and 4 with auto-tuned s:
the port (device="cpu": its kernels' plain versions) against the JAX package
on identical numpy inputs, through the public entry point. At two cameras
(four observations) n_latent 1 and 2 take the fused NLL, kernel A at
(D, O) = (1, 4) and (2, 4), and the scans at D = 1 and 2; n_latent 4 is
beyond both, so the optimizer's loss is the staged plane NLL over the plain
scan, as the JAX package runs XLA's associative scan there. Limits are the
JAX package's own for this family (tests/test_multicam.py): s at rtol 1e-4,
tables at atol 1e-4."""

import numpy as np
import pytest

import eks_tpu_torch
from eks_tpu.marker_array import MarkerArray as JaxMarkerArray
from eks_tpu.models import multicam as jax_multicam
from eks_tpu_torch.marker_array import MarkerArray

FIELDS = ["x", "y", "likelihood"]
KPS, CAMS = ["kp0", "kp1", "kp2"], ["alpha", "beta"]


def _session(seed, M=5, C=2, T=200, K=3, jitter=0.5):
    """(M, C, T, K, 3) predictions: the recipe of tests/test_multicam.py::
    make_multicam_array, a random walk per camera and coordinate plus
    per-seed jitter."""
    rng = np.random.default_rng(seed)
    arr = np.zeros((M, C, T, K, 3))
    base = rng.normal(size=(1, C, T, K, 2)).cumsum(axis=2) * 0.3 + 40
    arr[..., :2] = base + rng.normal(size=(M, C, T, K, 2)) * jitter
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(M, C, T, K))
    return arr


def _tables_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [tuple(map(str, c)) for c in g.columns] == [tuple(map(str, c)) for c in w.columns]
        np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_latent,kw", [
    (1, {}), (2, {}), (4, {}), (2, dict(quantile_keep_pca=50)),
], ids=["n_latent_1", "n_latent_2", "n_latent_4", "n_latent_2_q50"])
def test_auto_s_at_n_latent_matches_jax(n_latent, kw):
    arr = _session(20 + n_latent)
    dfs_j, s_j, df3_j = jax_multicam.ensemble_kalman_smoother_multicam(
        JaxMarkerArray(arr, data_fields=FIELDS), KPS, CAMS, inflate_vars=False, n_latent=n_latent, **kw)
    dfs_p, s_p, df3_p = eks_tpu_torch.ensemble_kalman_smoother_multicam(
        MarkerArray(arr.astype(np.float32), data_fields=FIELDS), KPS, CAMS, inflate_vars=False,
        n_latent=n_latent, device="cpu", **kw)
    np.testing.assert_allclose(s_p, np.asarray(s_j), rtol=1e-4)
    _tables_close(dfs_p, dfs_j)
    _tables_close([df3_p], [df3_j])
