"""The PyTorch port's singlecam slice end to end (eks_tpu_torch/models/
singlecam.py and the host code under it) against the committed reference
golden and against the JAX package, on the bundled session cropped to 200
frames; plus the port's guards: it imports nothing of JAX or of the JAX
package, and it never carries on on the CPU when the card was asked for."""

import ast
import os
import pathlib

import numpy as np
import pandas as pd
import pytest
import torch

import eks_tpu
import eks_tpu_torch
from eks_tpu.marker_array import input_dfs_to_markerArray as jax_input_dfs_to_markerArray
from eks_tpu.models import singlecam as jax_singlecam
from eks_tpu.utils import format_data as jax_format_data
from eks_tpu.utils.frames import crop_frames as jax_crop_frames
from eks_tpu_torch.convert import params_from_numpy, scalar_table_from_numpy
from eks_tpu_torch.marker_array import input_dfs_to_markerArray
from eks_tpu_torch.models import singlecam
from eks_tpu_torch.utils import crop_frames, format_data
from tests.integration.conftest import DATA, GOLDEN_DIR
from tests.integration.cropping import make_cropped_session

REPO = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(not os.path.isdir(DATA), reason="bundled example data missing")


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """The bundled singlecam session cropped to its first 200 frames (the
    fast-tier goldens' inputs)."""
    return make_cropped_session(
        os.path.join(DATA, "singlecam"), str(tmp_path_factory.mktemp("torch_sc") / "singlecam")
    )


def _read_golden(name):
    return pd.read_csv(os.path.join(GOLDEN_DIR, f"{name}.csv"), header=[0, 1, 2], index_col=0)


def _columns(df):
    return [tuple(map(str, c)) for c in df.columns]


# --------------------------------------------------------------------------- #
# the whole slice
# --------------------------------------------------------------------------- #
def test_fit_fixed_s_matches_reference_golden(session, tmp_path):
    """Fixed s = 2.0 against the reference implementation's output on the
    same 200 frames, at the reference's own contract (atol 1e-4); the saved
    CSV reads back as the returned table."""
    out = tmp_path / "out.csv"
    df, s_finals, _, keypoints = eks_tpu_torch.fit_eks_singlecam(
        session, str(out), smooth_param=2.0, device="cpu"
    )
    ref = _read_golden("fast_singlecam_fixed")
    assert _columns(df) == _columns(ref)
    np.testing.assert_allclose(df.to_numpy(), ref.to_numpy(), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(s_finals, np.full(len(keypoints), 2.0))
    saved = pd.read_csv(out, header=[0, 1, 2], index_col=0)
    np.testing.assert_allclose(saved.to_numpy(), df.to_numpy(), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(s_frames=[(0, 150)]),
    dict(blocks=[[0, 1]], avg_mode="mean", var_mode="var"),
])
def test_fit_auto_s_matches_jax(session, tmp_path, kw):
    """Auto-tuned s against the JAX package on the same crop: s at rtol
    5e-4 and the table at atol 1e-4. Measured on the CPU: s within 1e-6
    relative, the table within 8e-6."""
    df_j, s_j, _, _ = eks_tpu.fit_eks_singlecam(session, str(tmp_path / "j.csv"), **kw)
    df_p, s_p, _, _ = eks_tpu_torch.fit_eks_singlecam(
        session, str(tmp_path / "p.csv"), device="cpu", **kw
    )
    np.testing.assert_allclose(s_p, np.asarray(s_j), rtol=5e-4)
    assert _columns(df_p) == _columns(df_j)
    np.testing.assert_allclose(df_p.to_numpy(), df_j.to_numpy(), rtol=0, atol=1e-4)


# --------------------------------------------------------------------------- #
# host code: loading, marker arrays, cropping, KF init
# --------------------------------------------------------------------------- #
def test_loading_and_marker_array_match_jax(session):
    """The port reads CSVs through pandas, the JAX package through its
    native parser, whose decimal-to-double rounding differs from pandas' in
    the last bit (measured: 2.5e-16 relative); the marker arrays built from
    one package's frames are identical."""
    dfs_j, names_j = jax_format_data(session)
    dfs_p, names_p = format_data(session)
    assert names_p == names_j and len(dfs_p) == len(dfs_j)
    for a, b in zip(dfs_p, dfs_j):
        pd.testing.assert_frame_equal(a, b, check_exact=False, rtol=1e-15, atol=0)
    ma_j = jax_input_dfs_to_markerArray([dfs_p], names_j, [""])
    ma_p = input_dfs_to_markerArray([dfs_p], names_p, [""])
    assert ma_p.data_fields == ma_j.data_fields
    np.testing.assert_array_equal(ma_p.array, ma_j.array)


@pytest.mark.parametrize("s_frames", [
    None, [], [(None, None)], [(0, 50)], [(10, None)], [(120, 150), (0, 30)], [(None, 5), (7, 9)],
])
def test_crop_frames_matches_jax(s_frames):
    y = np.arange(200 * 3, dtype=np.float32).reshape(200, 3)
    want = jax_crop_frames(y, s_frames)
    np.testing.assert_array_equal(crop_frames(torch.as_tensor(y), s_frames).numpy(), want)
    # the optimizer crops its (K, T, O) observations along time
    np.testing.assert_array_equal(
        crop_frames(torch.as_tensor(y.T.copy()), s_frames, dim=1).numpy(), np.asarray(want).T
    )


@pytest.mark.parametrize("s_frames", [[(0, 300)], [(5, 5)], [(0, 20), (10, 30)], [(0.5, 3)], (0, 5)])
def test_crop_frames_rejects_what_jax_rejects(s_frames):
    y = np.zeros((100, 2), np.float32)
    with pytest.raises((ValueError, TypeError)) as e_jax:
        jax_crop_frames(y, s_frames)
    with pytest.raises(e_jax.type):
        crop_frames(torch.as_tensor(y), s_frames)


def test_initialize_kalman_filter_matches_jax(session):
    dfs, names = format_data(session)
    ma = input_dfs_to_markerArray([dfs], names, [""]).slice("models", [0])
    got = singlecam.initialize_kalman_filter(ma, device="cpu")
    want = jax_singlecam.initialize_kalman_filter(ma)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_convert_carries_operands_exactly():
    rng = np.random.default_rng(0)
    ops = [rng.normal(size=s).astype(np.float32) for s in ((3, 2), (3, 2, 2), (3, 2, 2), (3, 2, 2), (3, 2, 2), (3, 9, 2))]
    for got, want in zip(params_from_numpy(*ops), ops):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    table = scalar_table_from_numpy(rng.normal(size=(4, 46)))
    assert table.dtype == torch.float32 and table.shape == (4, 46) and table.is_contiguous()
    with pytest.raises(ValueError):
        scalar_table_from_numpy(np.zeros(46))


# --------------------------------------------------------------------------- #
# guards
# --------------------------------------------------------------------------- #
def _port_files():
    files = sorted((REPO / "eks_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "optax", "eks_tpu"), f"{path.name} imports {mod}"


def test_cuda_request_without_a_card_raises(session, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the CUDA request is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eks_tpu_torch.fit_eks_singlecam(session, str(tmp_path / "o.csv"), smooth_param=2.0)
    assert not (tmp_path / "o.csv").exists()
    dfs, names = format_data(session)
    ma = input_dfs_to_markerArray([dfs], names, [""])
    with pytest.raises(RuntimeError, match="is_available"):
        eks_tpu_torch.ensemble_kalman_smoother_singlecam(ma, names, device="cuda")
    with pytest.raises(RuntimeError):
        singlecam.initialize_kalman_filter(ma.slice("models", [0]))


def test_tf32_is_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
