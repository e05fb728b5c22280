"""The recorder on the linear multi-camera path's fused route
(``eks_tpu_torch/models/multicam.py``): the "prep.pca" span (the
centring, the PCA fit and the latent's S0 and Q) nests under "prep" when a
``timings`` dict is passed and is absent without one, and a tuned
two-camera call counts its launches by instance.

The CPU tests run the plain versions of the kernels at a small size. The
test marked ``cuda`` launches the kernels and skips without a card; on the
card (where JAX is not installed, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_multicam.py -q
"""

import numpy as np
import pytest
import torch

import eks_tpu_torch
from eks_tpu_torch import tracing
from eks_tpu_torch.marker_array import MarkerArray
from eks_tpu_torch.models import multicam


def _two_camera_array(rng, M=5, T=200, K=3):
    """One 3-D random walk a keypoint seen by two affine cameras, plus
    per-member jitter."""
    body = rng.normal(size=(T, K, 3)).cumsum(axis=0)
    views = rng.normal(size=(2, 2, 3))
    base = np.einsum("tkl,cfl->ctkf", body, views) + 100.0
    arr = np.zeros((M, 2, T, K, 3), np.float32)
    arr[..., :2] = base[None] + rng.normal(size=(M, 2, T, K, 2)) * 0.5
    arr[..., 2] = rng.uniform(0.7, 1.0, size=(M, 2, T, K))
    return MarkerArray(arr, data_fields=["x", "y", "likelihood"])


def _call(device, timings, smooth_param=2.0, T=200):
    return eks_tpu_torch.ensemble_kalman_smoother_multicam(
        _two_camera_array(np.random.default_rng(5), T=T), ["a", "b", "c"], ["top", "bot"],
        smooth_param=smooth_param, n_latent=3, device=device, timings=timings)


def test_the_pca_span_nests_under_prep_once_a_call():
    timings = {}
    _call("cpu", timings)
    spans = timings["spans"]
    (prep,) = [i for i, s in enumerate(spans) if s[0] == "prep"]
    (pca,) = [s for s in spans if s[0] == "prep.pca"]
    assert pca[3] == prep
    assert spans[prep][1] <= pca[1] <= pca[2] <= spans[prep][2]
    assert "prep.pca" not in timings  # a span, not a stage
    assert [s[0] for s in spans if s[3] == -1] == ["prep", "optimizer", "final_pass", "package", "table"]


def test_without_timings_the_prep_syncs_nothing_and_the_span_changes_no_number(monkeypatch):
    synced = []
    monkeypatch.setattr(tracing, "sync", lambda *devices: synced.append(devices))
    arr = torch.as_tensor(_two_camera_array(np.random.default_rng(5)).array)
    planes = (arr[..., 0], arr[..., 1], arr[..., 2], 5, "median", "confidence_weighted_var", 3, 50.0)
    untimed = multicam._prep_multicam_linear(*planes)
    assert synced == []
    timings = {}
    timed = multicam._prep_multicam_linear(*planes, timings=timings)
    assert len(synced) == 2  # the device is waited for at both ends of the span
    assert [s[0] for s in timings["spans"]] == ["prep.pca"]
    for a, b in zip(untimed, timed):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there; the CPU tests hold their plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_tuned_two_camera_call_counts_its_launches_by_instance(dev):
    timings = {}
    _call("cuda", timings, smooth_param=None, T=500)
    n = timings["adam_iters"]
    assert n > 0
    counts = dict(timings["counts"])
    counts.pop(("frame", "index_built"), None)  # none where the names' index is cached
    assert counts == {("table", 3, 4): n, ("A", 3, 4, True): n, ("adam_step", 1): n,
                      ("scan", "filter", False, 3): 1, ("scan", "smoother", False, 3): 1,
                      ("output_pull",): 1, ("frame", "wrapped"): 3}
    assert [s[0] for s in timings["spans"]].count("prep.pca") == 1
