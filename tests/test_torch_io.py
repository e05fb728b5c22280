"""The port's SLEAP ``.slp`` reading (eks_tpu_torch/utils/io.py) against the
JAX package's on the same synthetic containers: the dense array, the flat
DataFrame and its ``{file}.csv`` copy in the working directory, and
``format_data`` on a directory of ``.slp`` files and on one that mixes
``.slp`` and ``.csv`` files, with and without camera names."""

import os

import numpy as np
import pandas as pd
import pytest

from eks_tpu.utils import io as jax_io
from eks_tpu_torch.utils import io
from tests.test_utils import _make_slp

h5py = pytest.importorskip("h5py")


def _make_slp_mixed(path, node_names, T, rng):
    """A container with two instances a frame, the first predicted and the
    second a user label (read from ``points``, score 0), except the first
    frame's single instance: the readers keep the first frame's count."""
    import json

    frames_dt = np.dtype([("frame_id", "u8"), ("video", "u4"), ("frame_idx", "u8"),
                          ("instance_id_start", "u8"), ("instance_id_end", "u8")])
    inst_dt = np.dtype([("instance_id", "u8"), ("instance_type", "u1"), ("frame_id", "u8"),
                        ("skeleton", "u4"), ("track", "i4"), ("from_predicted", "i8"), ("score", "f4"),
                        ("point_id_start", "u8"), ("point_id_end", "u8")])
    pt_dt = np.dtype([("x", "f8"), ("y", "f8"), ("visible", "?"), ("complete", "?")])
    pred_dt = np.dtype([("x", "f8"), ("y", "f8"), ("visible", "?"), ("complete", "?"), ("score", "f8")])
    K = len(node_names)
    frames, insts, pts, preds = [], [], [], []
    for t in range(T):
        lo = len(insts)
        insts.append((len(insts), 1, t, 0, -1, -1, 0.9, len(preds), len(preds) + K))
        for _ in range(K):
            preds.append((*rng.normal(size=2), True, False, rng.uniform()))
        if t > 0:
            insts.append((len(insts), 0, t, 0, -1, -1, 0.0, len(pts), len(pts) + K))
            for _ in range(K):
                pts.append((*rng.normal(size=2), True, True))
        frames.append((t, 0, t, lo, len(insts)))
    meta = {"nodes": [{"name": n, "weight": 1.0} for n in node_names]}
    with h5py.File(path, "w") as f:
        f.create_dataset("frames", data=np.array(frames, dtype=frames_dt))
        f.create_dataset("instances", data=np.array(insts, dtype=inst_dt))
        f.create_dataset("points", data=np.array(pts, dtype=pt_dt))
        f.create_dataset("pred_points", data=np.array(preds, dtype=pred_dt))
        f.create_group("metadata").attrs["json"] = json.dumps(meta)


def _write_csv(path, node_names, T, rng):
    """A prediction CSV in the DLC 3-row-header format."""
    cols = pd.MultiIndex.from_product([["scorer"], node_names, ["x", "y", "likelihood"]],
                                      names=["scorer", "bodyparts", "coords"])
    data = rng.normal(size=(T, 3 * len(node_names)))
    data[:, 2::3] = rng.uniform(size=(T, len(node_names)))
    pd.DataFrame(data, columns=cols).to_csv(path)


def _same_frames(got, want):
    assert list(got.columns) == list(want.columns)
    # pandas' float parser and the JAX package's native reader may differ in
    # the last ulp of a CSV value
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-13, atol=0)


@pytest.mark.parametrize("kind", ["predicted", "mixed"])
def test_read_slp_predictions_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "sess.slp")
    if kind == "predicted":
        xy = rng.normal(size=(6, 3, 2))
        xy[2, 1, 0] = np.nan  # a missing coordinate reads 0
        _make_slp(path, ["nose", "ear", "tail"], xy, rng.uniform(size=(6, 3)))
    else:
        _make_slp_mixed(path, ["nose", "ear", "tail"], 6, rng)
    dense, names = io.read_slp_predictions(path)
    dense_j, names_j = jax_io.read_slp_predictions(path)
    assert names == names_j == ["nose", "ear", "tail"]
    np.testing.assert_array_equal(dense, dense_j)
    assert dense.shape == (6, 1, 3, 3)


def test_convert_slp_dlc_matches_jax_and_writes_its_csv_copy(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    _make_slp(data_dir / "preds.slp", ["a", "b"], rng.normal(size=(5, 2, 2)), rng.uniform(size=(5, 2)))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    monkeypatch.chdir(port_dir)
    df, names = io.convert_slp_dlc(str(data_dir), "preds.slp")
    monkeypatch.chdir(jax_dir)
    df_j, names_j = jax_io.convert_slp_dlc(str(data_dir), "preds.slp")
    assert names == names_j == ["a", "b"]
    pd.testing.assert_frame_equal(df, df_j)
    assert list(df.columns) == ["1_a_x", "1_a_y", "1_a_likelihood", "1_b_x", "1_b_y", "1_b_likelihood"]
    # the flat copy lands in the working directory, as the JAX package's does
    assert (port_dir / "preds.slp.csv").read_text() == (jax_dir / "preds.slp.csv").read_text()


def test_format_data_on_a_slp_directory_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    data_dir = tmp_path / "slp"
    data_dir.mkdir()
    for i in range(3):
        _make_slp(data_dir / f"seed{i}.slp", ["a", "b"], rng.normal(size=(7, 2, 2)), rng.uniform(size=(7, 2)))
    dfs, names = io.format_data(str(data_dir))
    dfs_j, names_j = jax_io.format_data(str(data_dir))
    assert names == names_j and len(dfs) == len(dfs_j) == 3
    for got, want in zip(dfs, dfs_j):
        _same_frames(got, want)


@pytest.mark.parametrize("cameras", [None, ["top", "bot"]], ids=["flat", "by_camera"])
def test_format_data_on_a_mixed_directory_matches_jax(tmp_path, monkeypatch, cameras):
    """``.slp`` and ``.csv`` files side by side: every file is loaded, none
    is dropped from the ensemble."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(6)
    data_dir = tmp_path / "mixed"
    data_dir.mkdir()
    for cam in ("top", "bot"):
        _make_slp(data_dir / f"m0_{cam}.slp", ["a", "b"], rng.normal(size=(8, 2, 2)), rng.uniform(size=(8, 2)))
        _write_csv(data_dir / f"m1_{cam}.csv", ["a", "b"], 8, rng)
    (data_dir / "notes_top.txt").write_text("not a prediction file")
    dfs, names = io.format_data(str(data_dir), camera_names=cameras)
    dfs_j, names_j = jax_io.format_data(str(data_dir), camera_names=cameras)
    assert names == names_j == ["a", "b"]
    if cameras is None:
        assert len(dfs) == len(dfs_j) == 4
        pairs = list(zip(dfs, dfs_j))
    else:
        assert [len(d) for d in dfs] == [len(d) for d in dfs_j] == [2, 2]
        pairs = [(g, w) for gs, ws in zip(dfs, dfs_j) for g, w in zip(gs, ws)]
    for got, want in pairs:
        _same_frames(got, want)
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".slp.csv")) == ["m0_bot.slp.csv", "m0_top.slp.csv"]
