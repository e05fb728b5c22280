"""The PyTorch port's IBL paw family (eks_tpu_torch/models/ibl_paw.py: the
timestamp alignment, label swap and x-mirror in front of the linear
multi-camera smoother) against the committed reference goldens and the JAX
package, on the bundled paw session cropped to 200 frames."""

import os

import numpy as np
import pandas as pd
import pytest

import eks_tpu
import eks_tpu_torch
from eks_tpu.models import ibl_paw as jax_paw
from eks_tpu_torch.models import ibl_paw
from tests.integration.conftest import DATA, GOLDEN_DIR
from tests.integration.cropping import make_cropped_session

pytestmark = pytest.mark.skipif(not os.path.isdir(DATA), reason="bundled example data missing")


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return make_cropped_session(
        os.path.join(DATA, "paw"), str(tmp_path_factory.mktemp("torch_paw") / "paw"))


def _columns(df):
    return [tuple(map(str, c)) for c in df.columns]


@pytest.mark.parametrize("camera,golden", [(0, "fast_paw_left"), (1, "fast_paw_right")])
def test_fit_paw_fixed_s_matches_reference_golden(session, tmp_path, camera, golden):
    """s = 4.0, var_mode="var", against the reference implementation's
    output on the same 200 frames at its own contract (atol 1e-4); the saved
    CSVs read back as the returned tables."""
    dfs, s_finals, input_dfs, bodyparts = eks_tpu_torch.fit_eks_multicam_ibl_paw(
        session, str(tmp_path), smooth_param=4.0, var_mode="var", device="cpu")
    ref = pd.read_csv(os.path.join(GOLDEN_DIR, f"{golden}.csv"), header=[0, 1, 2], index_col=0)
    assert _columns(dfs[camera]) == _columns(ref)
    np.testing.assert_allclose(dfs[camera].to_numpy(), ref.to_numpy(), rtol=0, atol=1e-4)
    assert bodyparts == ["paw_l", "paw_r"] and len(input_dfs) == 2
    np.testing.assert_array_equal(s_finals, [4.0, 4.0])
    name = ("left", "right")[camera]
    saved = pd.read_csv(tmp_path / f"multicam_{name}_results.csv", header=[0, 1, 2], index_col=0)
    np.testing.assert_allclose(saved.to_numpy(), dfs[camera].to_numpy(), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(smooth_param=4.0, var_mode="var"),
    dict(smooth_param=[2.0, 6.0], var_mode="var", inflate_vars=True, s_frames=[(0, 120)]),
], ids=["fused", "general_inflate"])
def test_fit_paw_matches_jax(session, tmp_path, kw):
    """Both routes of the multi-camera smoother behind the paw prologue,
    against the JAX package: the aligned inputs are identical, the tables
    agree at atol 1e-4."""
    dfs_j, s_j, in_j, _ = eks_tpu.fit_eks_multicam_ibl_paw(session, str(tmp_path / "j"), **kw)
    dfs_p, s_p, in_p, _ = eks_tpu_torch.fit_eks_multicam_ibl_paw(
        session, str(tmp_path / "p"), device="cpu", **kw)
    for cam_p, cam_j in zip(in_p, in_j):
        for a, b in zip(cam_p, cam_j):
            pd.testing.assert_frame_equal(a, b)
    np.testing.assert_array_equal(s_p, np.asarray(s_j))
    for a, b in zip(dfs_p, dfs_j):
        assert _columns(a) == _columns(b)
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=0, atol=1e-4)


def test_paw_needs_both_timestamp_files_and_equal_ensembles(session, tmp_path):
    import shutil

    broken = tmp_path / "no_ts"
    shutil.copytree(session, broken)
    os.remove(broken / "session.timestamps.right.npy")
    with pytest.raises(ValueError, match="timestamps"):
        eks_tpu_torch.fit_eks_multicam_ibl_paw(str(broken), str(tmp_path / "o"), smooth_param=4.0, device="cpu")
    uneven = tmp_path / "uneven"
    shutil.copytree(session, uneven)
    os.remove(uneven / "session.left.rng=2.csv")
    with pytest.raises(ValueError, match="ensemble counts"):
        eks_tpu_torch.fit_eks_multicam_ibl_paw(str(uneven), str(tmp_path / "o"), smooth_param=4.0, device="cpu")


def test_camera_mean_helpers_are_the_jax_packages():
    rng = np.random.default_rng(0)
    stacks = [rng.normal(size=(20, 2)) for _ in range(3)]
    means = [1.5, -2.0]
    removed = ibl_paw.remove_camera_means(stacks, means)
    for a, b in zip(removed, jax_paw.remove_camera_means(stacks, means)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ibl_paw.add_camera_means(removed, means), stacks):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
