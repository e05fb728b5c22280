"""The port's native CSV reader and writer (eks_tpu_torch/native) against the
JAX package's (eks_tpu/native) and against pandas, on the CPU; which path
each read and write took; and the port's CLI and native modules importing
nothing of JAX."""

import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from eks_tpu import native as jax_native
from eks_tpu.utils import format_data as jax_format_data
from eks_tpu_torch import native
from eks_tpu_torch.utils import format_data, save_dlc_csv
from eks_tpu_torch.utils import io
from tests.integration.conftest import DATA

REPO = pathlib.Path(__file__).resolve().parent.parent
BUNDLED_CSVS = sorted(str(p.relative_to(REPO)) for p in (REPO / "data").rglob("*.csv"))
FAMILIES = ("singlecam", "pupil", "mirrored", "multicam", "paw")

needs_native = pytest.mark.skipif(
    not (native.native_available() and native.writer_available()),
    reason="native reader/writer unavailable (no g++)",
)


@pytest.fixture
def counts():
    """READS and WRITES as they change during one test."""
    before = dict(native.READS), dict(native.WRITES)

    def delta():
        return ({k: v - before[0][k] for k, v in native.READS.items()},
                {k: v - before[1][k] for k, v in native.WRITES.items()})

    return delta


@needs_native
@pytest.mark.parametrize("rel", BUNDLED_CSVS)
def test_reader_matches_jax_reader_exactly(rel):
    """Same float64 bits and the same header cells as the JAX package's
    reader, on every bundled CSV."""
    got = native.load_dlc_csv_fast(str(REPO / rel))
    want = jax_native.load_dlc_csv_fast(str(REPO / rel))
    assert got is not None and want is not None
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])


@needs_native
@pytest.mark.parametrize("family", FAMILIES)
def test_format_data_native_matches_pandas_and_jax(family, monkeypatch, counts):
    """format_data through the native reader: within rtol 1e-13 of its
    pandas path (pandas' own float parser may differ in the last ulp), and
    the same bits as the JAX package's format_data."""
    src = os.path.join(DATA, family)
    n_files = sum(f.endswith(".csv") for f in os.listdir(src))
    camera_names = {"mirrored": None, "multicam": ["cam0", "cam1"], "paw": ["left", "right"]}.get(family)
    fast, kps = format_data(src, camera_names)
    assert counts()[0] == {"native": n_files, "pandas": 0}
    monkeypatch.setenv("EKS_TPU_TORCH_NATIVE_CSV", "0")
    slow, kps_slow = format_data(src, camera_names)
    assert counts()[0] == {"native": n_files, "pandas": n_files}
    want, kps_jax = jax_format_data(src, camera_names)
    assert kps == kps_slow == kps_jax

    def flat(dfs):
        return [d for x in dfs for d in (x if isinstance(x, list) else [x])]

    for a, b, c in zip(flat(fast), flat(slow), flat(want), strict=True):
        assert list(a.columns) == list(b.columns) == list(c.columns)
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=1e-13, atol=0)
        np.testing.assert_array_equal(a.to_numpy(), c.to_numpy())


def _frame(dtype, T=97, K=3):
    """An output-shaped table whose first column exercises the formatter's
    branches: integral, tiny, huge, signed zero, NaN, inf."""
    rng = np.random.default_rng(0)
    cols = pd.MultiIndex.from_product(
        [["ensemble-kalman_tracker"], [f"kp{i}" for i in range(K)], ["x", "y", "likelihood"]],
        names=["scorer", "bodyparts", "coords"],
    )
    vals = rng.normal(size=(T, K * 3)).astype(dtype)
    vals[:8, 0] = [2.0, 1e-8, 1.5e16, -0.0, np.nan, 123456.789, np.inf, 0.1]
    return pd.DataFrame(vals, columns=cols)


@needs_native
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_writer_byte_identical_to_pandas(tmp_path, dtype, counts):
    df = _frame(dtype)
    save_dlc_csv(df, str(tmp_path / "fast.csv"))
    df.to_csv(tmp_path / "ref.csv")
    assert (tmp_path / "fast.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    assert counts()[1] == {"native": 1, "pandas": 0}


@needs_native
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_writer_matches_jax_writer_on_random_magnitudes(tmp_path, dtype):
    """Values across 1e-40..1e20: byte-identical to pandas and to the JAX
    package's writer."""
    rng = np.random.default_rng(1)
    exps = rng.uniform(-40, 20, size=(500, 4))
    vals = (rng.choice([-1.0, 1.0], size=exps.shape) * rng.uniform(1, 10, size=exps.shape)
            * 10.0 ** exps).astype(dtype)
    df = pd.DataFrame(vals, index=pd.RangeIndex(3, 503))
    assert native.write_dlc_csv_fast(df, str(tmp_path / "f.csv"))
    assert jax_native.write_dlc_csv_fast(df, str(tmp_path / "j.csv"))
    df.to_csv(tmp_path / "r.csv")
    assert (tmp_path / "f.csv").read_bytes() == (tmp_path / "r.csv").read_bytes()
    assert (tmp_path / "f.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("df", [
    pd.DataFrame({"a": [1, 2], "b": ["x", "y"]}),
    pd.DataFrame({"a": np.float32([1.5, 2.5]), "b": np.float64([0.1, 0.2])}),
    pd.DataFrame({"a": [0.5, 1.5]}, index=[0, 2]),
], ids=["non_float", "mixed_f32_f64", "gapped_index"])
def test_writer_falls_back_to_pandas(tmp_path, df, counts):
    """Tables the native writer does not cover go through pandas, byte for
    byte, and are counted there."""
    path = tmp_path / "t.csv"
    assert not native.write_dlc_csv_fast(df, str(path))
    save_dlc_csv(df, str(path))
    assert path.read_text() == df.to_csv()
    assert counts()[1] == {"native": 0, "pandas": 1}


def test_reader_falls_back_on_a_file_it_does_not_parse(tmp_path, counts):
    """A file the native reader does not take (here a quoted comma in a
    bodypart name, which it splits) is read by pandas, as the JAX package
    reads it, and counted so; a file neither reads gives None natively."""
    df = _frame(np.float64, T=10, K=2)
    df.columns = pd.MultiIndex.from_tuples(
        [("m0", "nose,tip" if kp == "kp0" else kp, c) for _, kp, c in df.columns],
        names=["scorer", "bodyparts", "coords"],
    )
    path = tmp_path / "quoted.csv"
    df.to_csv(path)
    got, kps = io._load_one(str(path))
    assert counts()[0] == {"native": 0, "pandas": 1}
    want, kps_jax = jax_format_data([str(path)])
    assert kps == kps_jax == ["nose,tip", "kp1"]
    assert list(got.columns) == list(want[0].columns)
    np.testing.assert_array_equal(got.to_numpy(), want[0].to_numpy())
    (tmp_path / "bad.csv").write_text("just,one,line\n")
    assert native.load_dlc_csv_fast(str(tmp_path / "bad.csv")) is None
    assert native.load_dlc_csv_fast(str(tmp_path / "missing.csv")) is None


def test_no_compiler_is_logged_once_and_counted_as_pandas(tmp_path, monkeypatch, caplog, counts):
    """Without a compiler the library is not built: one WARNING names the
    source, and every read and write goes through pandas, counted so."""
    monkeypatch.setattr(native, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    with caplog.at_level(logging.WARNING, logger="eks_tpu_torch.native"):
        assert not native.native_available()
        assert not native.native_available()
        assert not native.writer_available()
    warned = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 2
    assert "fast_csv.cpp" in warned[0] and "fast_csv_write.cpp" in warned[1]
    dfs, _ = format_data(os.path.join(DATA, "singlecam"))
    save_dlc_csv(_frame(np.float32), str(tmp_path / "o.csv"))
    assert counts() == ({"native": 0, "pandas": len(dfs)}, {"native": 0, "pandas": 1})
    assert not (tmp_path / "_build").exists() or not list((tmp_path / "_build").glob("*.so"))


@needs_native
def test_libraries_are_named_by_a_hash_of_their_source():
    """Each library sits in eks_tpu_torch/_build/ under a name carrying a
    hash of its source and flags, so an edited source is rebuilt."""
    for stem in ("fast_csv", "fast_csv_write"):
        path = native._library_path(native._DIR / f"{stem}.cpp")
        assert path.parent == REPO / "eks_tpu_torch" / "_build"
        assert path.name.startswith(f"lib{stem}-") and path.exists()


@needs_native
def test_opt_out_takes_pandas_for_reads_and_writes(tmp_path, monkeypatch, counts):
    monkeypatch.setenv("EKS_TPU_TORCH_NATIVE_CSV", "0")
    dfs, _ = format_data(os.path.join(DATA, "pupil"))
    save_dlc_csv(_frame(np.float64), str(tmp_path / "o.csv"))
    assert counts() == ({"native": 0, "pandas": len(dfs)}, {"native": 0, "pandas": 1})


def test_cli_and_native_import_nothing_of_jax():
    """Importing the port's CLI (every subcommand) and native modules, in a
    fresh interpreter, loads no module of JAX or of the JAX package."""
    code = (
        "import sys, importlib, pathlib\n"
        "import eks_tpu_torch.native, eks_tpu_torch.cli.main\n"
        "for p in sorted(pathlib.Path('eks_tpu_torch/cli').glob('cmd_*.py')):\n"
        "    importlib.import_module('eks_tpu_torch.cli.' + p.stem)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'eks_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
