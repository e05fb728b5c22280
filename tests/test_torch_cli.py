"""The port's command line (eks_tpu_torch/cli) against the JAX package's
(eks_tpu/cli), on the CPU.

Dispatch: every case of tests/cli/test_dispatch.py and tests/cli/test_main.py
on the port's CLI with its entry points patched, plus the port's own flag,
``--device``. Parser parity: each subcommand's options against the JAX
package's. End to end: both CLIs on the bundled sessions cropped to 200
frames, their output CSVs compared."""

import argparse
import logging
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

from eks_tpu.cli import _utils as jax_utils
from eks_tpu.cli.main import main as jax_main
from eks_tpu_torch.cli import _utils
from eks_tpu_torch.cli.main import main
from tests.integration.conftest import DATA
from tests.integration.cropping import make_cropped_session

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ("singlecam", "multicam", "mirrored-multicam", "ibl-pupil", "ibl-paw")


def _run(argv, entry=main, prog="eks-tpu-torch"):
    with mock.patch.object(sys, "argv", [prog] + argv):
        entry()


def _run_cpu(argv):
    """The port's CLI on the CPU (``--device`` goes after the subcommand)."""
    _run(argv + ["--device", "cpu"])


def _capture(target, returns):
    """Patch `target` with a recorder returning `returns`."""
    seen = {}

    def fake(**kwargs):
        seen.update(kwargs)
        return returns

    return seen, mock.patch(target, side_effect=fake)


@pytest.fixture(autouse=True)
def _restore_log_level():
    """main() sets the level of the eks_tpu_torch loggers, as a command
    line does; put it back after each test."""
    log = logging.getLogger("eks_tpu_torch")
    level = log.level
    yield
    log.setLevel(level)


DF = mock.MagicMock()
SOLO = (DF, [1.0], [], ["bp"])
MULTI = ([DF], [1.0], [[]], ["bp"], DF)
PAW = ([DF], [1.0], [[]], ["paw_l"])
PUPIL = (DF, (0.9, 0.9), [], ["kp"])
CLI = "eks_tpu_torch.cli."


# --------------------------------------------------------------------------- #
# dispatch (tests/cli/test_dispatch.py and tests/cli/test_main.py)
# --------------------------------------------------------------------------- #
def _forwarding_cases():
    """(name, patched entry point, what it returns, argv after the
    input/save flags, expected kwargs), one per case of
    tests/cli/test_dispatch.py that checks forwarding."""
    return [
        ("singlecam", "cmd_singlecam.fit_eks_singlecam", SOLO, [
            "singlecam", "--save-filename", "out.csv", "--s", "1.5", "2.5", "--blocks", "0,1;2",
            "--s-frames", "(0,100)", "--bodypart-list", "nose", "paw", "--devices", "4",
            "--partition", "time",
        ], dict(save_file="out.csv", smooth_param=[1.5, 2.5], blocks=[[0, 1], [2]], s_frames=[(0, 100)],
                bodypart_list=["nose", "paw"], devices=4, partition="time")),
        ("multicam", "cmd_multicam.fit_eks_multicam", MULTI, [
            "multicam", "--camera-names", "top", "bot", "--quantile-keep-pca", "80", "--n-latent", "2",
            "--no-inflate-vars", "--s", "3.0", "--devices", "4", "--partition", "time",
        ], dict(camera_names=["top", "bot"], quantile_keep_pca=80, n_latent=2, inflate_vars=False,
                smooth_param=[3.0], devices=4, partition="time", calibration=None)),
        ("mirrored-multicam", "cmd_mirrored_multicam.fit_eks_mirrored_multicam", SOLO, [
            "mirrored-multicam", "--camera-names", "top", "bot", "--quantile-keep-pca", "60",
            "--n-latent", "3", "--devices", "2",
        ], dict(camera_names=["top", "bot"], quantile_keep_pca=60, n_latent=3, inflate_vars=True,
                save_file="eks_mirrored_multicam.csv", devices=2, partition="keypoint")),
        ("ibl-pupil", "cmd_ibl_pupil.fit_eks_pupil", PUPIL, [
            "ibl-pupil", "--diameter-s", "0.99", "--com-s", "0.98", "--s-frames", "100", "--devices", "8",
        ], dict(smooth_params=[0.99, 0.98], s_frames=[(1, 100)], save_file="eks_ibl_pupil.csv", devices=8)),
        ("ibl-paw", "cmd_ibl_paw.fit_eks_multicam_ibl_paw", PAW, [
            "ibl-paw", "--s", "4.0", "--quantile-keep-pca", "70", "--no-inflate-vars", "--devices", "4",
        ], dict(smooth_param=[4.0], quantile_keep_pca=70, inflate_vars=False, var_mode="var", devices=4)),
    ]


@pytest.mark.parametrize("case", _forwarding_cases(), ids=lambda c: c[0])
def test_cmd_forwards_args(tmp_path, case):
    _, target, returns, argv, want = case
    seen, patcher = _capture(CLI + target, returns)
    with patcher:
        _run_cpu(argv[:1] + ["--input-dir", str(tmp_path), "--save-dir", str(tmp_path)] + argv[1:])
    assert seen["input_source"] == str(tmp_path)
    for key, value in want.items():
        if key == "save_file":
            value = str(tmp_path / value)
        assert seen[key] == value, key
    assert seen["device"] == "cpu"


@pytest.mark.parametrize("case", _forwarding_cases(), ids=lambda c: c[0])
def test_cmd_forwards_device(tmp_path, case):
    """``--device`` reaches every entry point; without it, ``cuda``."""
    _, target, returns, argv, _ = case
    seen, patcher = _capture(CLI + target, returns)
    with patcher, mock.patch(CLI + target.split(".")[0] + ".prepare_device"):
        _run(argv[:1] + ["--input-dir", str(tmp_path), "--save-dir", str(tmp_path)] + argv[1:])
    assert seen["device"] == "cuda"


def test_cmd_multicam_calibration_exclusivity(tmp_path, caplog):
    # no camera names and no calibration -> hard error
    with pytest.raises(ValueError):
        _run_cpu(["multicam", "--input-dir", str(tmp_path)])

    # calibration + camera names -> warn, calibration wins
    seen, patcher = _capture(CLI + "cmd_multicam.fit_eks_multicam", MULTI)
    with patcher, caplog.at_level("WARNING"):
        _run_cpu([
            "multicam", "--input-dir", str(tmp_path), "--camera-names", "a", "b",
            "--calibration", str(tmp_path / "cal.toml"),
        ])
    assert seen["calibration"] == str(tmp_path / "cal.toml")
    assert any("--calibration" in r.message for r in caplog.records)


@pytest.mark.parametrize("command, target, prefix, flags, want", [
    ("singlecam", "fit_eks_singlecam_sessions", "eks_singlecam",
     ["--s", "2.0", "--blocks", "0,1", "--bodypart-list", "nose", "paw"],
     dict(smooth_param=[[2.0], [2.0]], blocks=[[[0, 1]], [[0, 1]]], bodypart_list=["nose", "paw"])),
    ("ibl-pupil", "fit_eks_pupil_sessions", "eks_ibl_pupil",
     ["--diameter-s", "0.9", "--com-s", "0.95"], dict(smooth_params=[0.9, 0.95])),
])
def test_cmd_sessions_forwards_args(tmp_path, command, target, prefix, flags, want):
    d1, d2 = tmp_path / "sessA", tmp_path / "sessB"
    d1.mkdir(), d2.mkdir()
    module = "cmd_singlecam" if command == "singlecam" else "cmd_ibl_pupil"
    seen, patcher = _capture(f"{CLI}{module}.{target}", [SOLO, SOLO])
    with patcher:
        _run_cpu([command, "--sessions", str(d1), str(d2), "--save-dir", str(tmp_path)] + flags)
    assert seen["input_sources"] == [str(d1), str(d2)]
    assert seen["save_files"] == [str(tmp_path / f"{prefix}_sessA.csv"), str(tmp_path / f"{prefix}_sessB.csv")]
    for key, value in want.items():
        assert seen[key] == value, key
    assert seen["device"] == "cpu"


@pytest.mark.parametrize("command, target, prefix", [
    ("singlecam", "cmd_singlecam.fit_eks_singlecam_sessions", "eks_singlecam"),
    ("ibl-pupil", "cmd_ibl_pupil.fit_eks_pupil_sessions", "eks_ibl_pupil"),
])
def test_cmd_sessions_default_save_next_to_inputs(tmp_path, command, target, prefix):
    """Without --save-dir each session's CSV lands next to its own input
    directory, also when two sessions share a directory basename."""
    d1, d2 = tmp_path / "a" / "session", tmp_path / "b" / "session"
    d1.mkdir(parents=True), d2.mkdir(parents=True)
    seen, patcher = _capture(CLI + target, [SOLO, SOLO])
    with patcher:
        _run_cpu([command, "--sessions", str(d1), str(d2)])
    assert seen["save_files"] == [str(d1 / "outputs" / f"{prefix}.csv"), str(d2 / "outputs" / f"{prefix}.csv")]


def test_cmd_sessions_rejects_missing_directory(tmp_path):
    with pytest.raises(ValueError, match="not a directory"):
        _run_cpu(["singlecam", "--sessions", str(tmp_path / "missing")])


@pytest.mark.parametrize("flags", [["--diameter-s", "0.9"], ["--com-s", "0.95"]])
def test_cmd_ibl_pupil_warns_on_half_specified_s(tmp_path, caplog, flags):
    """Giving only one of --diameter-s/--com-s means fully-auto, and the
    CLI says so, solo and in sessions."""
    seen, patcher = _capture(CLI + "cmd_ibl_pupil.fit_eks_pupil", PUPIL)
    with patcher, caplog.at_level(logging.WARNING, logger="eks_tpu_torch.cli"):
        _run_cpu(["ibl-pupil", "--input-dir", str(tmp_path), "--save-dir", str(tmp_path)] + flags)
    assert any("unsupported" in r.message for r in caplog.records)

    d1 = tmp_path / "s1"
    d1.mkdir()
    caplog.clear()
    seen, patcher = _capture(CLI + "cmd_ibl_pupil.fit_eks_pupil_sessions", [PUPIL])
    with patcher, caplog.at_level(logging.WARNING, logger="eks_tpu_torch.cli"):
        _run_cpu(["ibl-pupil", "--sessions", str(d1)] + flags)
    assert any("unsupported" in r.message for r in caplog.records)


def test_cmd_ibl_pupil_no_warning_when_both_or_neither(tmp_path, caplog):
    seen, patcher = _capture(CLI + "cmd_ibl_pupil.fit_eks_pupil", PUPIL)
    with patcher, caplog.at_level(logging.WARNING, logger="eks_tpu_torch.cli"):
        _run_cpu(["ibl-pupil", "--input-dir", str(tmp_path), "--save-dir", str(tmp_path),
                  "--diameter-s", "0.9", "--com-s", "0.95"])
        _run_cpu(["ibl-pupil", "--input-dir", str(tmp_path), "--save-dir", str(tmp_path)])
    assert not any("unsupported" in r.message for r in caplog.records)


def test_cmd_sessions_save_dir_disambiguates_basename_collisions(tmp_path):
    """With --save-dir, two sessions sharing a directory basename must not
    map to the same output CSV."""
    d1, d2 = tmp_path / "a" / "session", tmp_path / "b" / "session"
    d1.mkdir(parents=True), d2.mkdir(parents=True)
    seen, patcher = _capture(CLI + "cmd_singlecam.fit_eks_singlecam_sessions", [SOLO, SOLO])
    with patcher:
        _run_cpu(["singlecam", "--sessions", str(d1), str(d2), "--save-dir", str(tmp_path), "--s", "2.0"])
    assert seen["save_files"] == [
        str(tmp_path / "eks_singlecam_0_session.csv"),
        str(tmp_path / "eks_singlecam_1_session.csv"),
    ]


def test_resolve_input_empty_file_list_clear_error():
    ns = argparse.Namespace(input_dir=None, input_files=[])
    with pytest.raises(ValueError, match="no input given"):
        _utils.resolve_input(ns)
    src, d = _utils.resolve_input(argparse.Namespace(input_dir="/tmp", input_files=None))
    assert src == "/tmp" and str(d) == "/tmp"


def test_version(capsys):
    import eks_tpu_torch

    with pytest.raises(SystemExit) as exc:
        _run(["--version"])
    assert exc.value.code == 0
    assert capsys.readouterr().out.strip() == f"eks-tpu-torch {eks_tpu_torch.__version__}"


def test_no_subcommand_errors():
    with pytest.raises(SystemExit) as exc:
        _run([])
    assert exc.value.code != 0


def test_all_subcommands_registered(capsys):
    with pytest.raises(SystemExit):
        _run(["--help"])
    out = capsys.readouterr().out
    for sub in SUBCOMMANDS:
        assert sub in out


def test_dispatch_calls_handler(tmp_path):
    seen, patcher = _capture(CLI + "cmd_singlecam.fit_eks_singlecam", SOLO)
    with patcher:
        _run_cpu(["singlecam", "--input-dir", str(tmp_path), "--save-dir", str(tmp_path), "--s", "2.0"])
    assert seen["input_source"] == str(tmp_path)
    assert seen["smooth_param"] == [2.0]


@pytest.mark.parametrize("text", ["100", "[(0,100),(200,300)]", "(0,100)", "[(,100),(250,)]", " ( 0 , 50 ) "])
def test_parse_s_frames_matches_jax(text):
    assert _utils.parse_s_frames(text) == jax_utils.parse_s_frames(text)


@pytest.mark.parametrize("text", ["0,1;2", "3", "a,b"])
def test_parse_blocks_matches_jax(text):
    try:
        want = jax_utils.parse_blocks(text)
    except argparse.ArgumentTypeError:
        with pytest.raises(argparse.ArgumentTypeError):
            _utils.parse_blocks(text)
        return
    assert _utils.parse_blocks(text) == want


# --------------------------------------------------------------------------- #
# --device and --devices
# --------------------------------------------------------------------------- #
@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is visible: the default is valid here")
def test_default_device_without_a_card_fails_before_reading(tmp_path):
    """``--device`` defaults to ``cuda``; without a card the command fails
    before it reads anything, and never carries on on the CPU."""
    seen, patcher = _capture(CLI + "cmd_singlecam.fit_eks_singlecam", SOLO)
    with patcher, pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _run(["singlecam", "--input-dir", os.path.join(DATA, "singlecam"), "--save-dir", str(tmp_path)])
    assert not seen


@pytest.fixture(scope="module")
def cropped(tmp_path_factory):
    """The bundled sessions cropped to 200 frames (the fast goldens' inputs),
    each family cropped once."""
    root = tmp_path_factory.mktemp("torch_cli_sessions")

    def get(name, copy="a"):
        dst = root / copy / name
        if not dst.is_dir():
            make_cropped_session(os.path.join(DATA, name), str(dst))
        return str(dst)

    return get


@pytest.mark.parametrize("argv", [
    ["singlecam", "--s", "2.0"],
    ["ibl-pupil", "--diameter-s", "0.99", "--com-s", "0.98"],
])
def test_devices_beyond_one_fails_with_the_entry_points_message(tmp_path, cropped, argv):
    """``--devices 4``, which failed before the multi-device slice was
    ported, now shards the run (four shards of the CPU here) with the
    one-device table; ``singlecam --sessions`` too. ``ibl-pupil --sessions``
    still refuses it, with its own message: the batched pupil entry point
    takes no devices (the JAX CLI ignores the flag there)."""
    family = "singlecam" if argv[0] == "singlecam" else "pupil"
    tables = {}
    for name, extra in (("one", []), ("four", ["--devices", "4"])):
        out = tmp_path / name
        _run_cpu(argv + ["--input-dir", cropped(family), "--save-dir", str(out)] + extra)
        (csv,) = out.glob("*.csv")
        tables[name] = pd.read_csv(csv, header=[0, 1, 2], index_col=0).to_numpy()
    np.testing.assert_allclose(tables["four"], tables["one"], rtol=0, atol=1e-5)
    sessions = [argv[0], "--sessions", cropped(family), "--save-dir", str(tmp_path / "s"), "--devices", "4"]
    if family == "pupil":
        with pytest.raises(ValueError, match="--devices above 1 is refused"):
            _run_cpu(sessions + argv[1:])
    else:
        _run_cpu(sessions + argv[1:])
        assert list((tmp_path / "s").rglob("*.csv"))


def test_devices_beyond_one_ends_the_process_nonzero(tmp_path, cropped):
    """As a process: ``ibl-pupil --sessions --devices 4`` ends with an exit
    code other than 0, the refusal on stderr and no output written (before
    the multi-device slice, every ``--devices 4`` did)."""
    proc = subprocess.run(
        [sys.executable, "-m", "eks_tpu_torch.cli.main", "ibl-pupil", "--sessions", cropped("pupil"),
         "--save-dir", str(tmp_path), "--diameter-s", "0.99", "--com-s", "0.98", "--device", "cpu",
         "--devices", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "ValueError: ibl-pupil --sessions runs on one device" in proc.stderr
    assert not list(tmp_path.iterdir())


# --------------------------------------------------------------------------- #
# parser parity
# --------------------------------------------------------------------------- #
def _subparsers(module_prefix):
    import importlib

    parser = argparse.ArgumentParser()
    subs = parser.add_subparsers(dest="subcommand")
    for name in ("cmd_singlecam", "cmd_multicam", "cmd_mirrored_multicam", "cmd_ibl_pupil", "cmd_ibl_paw"):
        importlib.import_module(f"{module_prefix}.cli.{name}").register(subs)
    return subs.choices


def _options(subparser):
    return {
        a.option_strings[0]: (tuple(a.option_strings), a.dest, type(a).__name__, a.type, a.nargs, a.default,
                              a.choices, a.required, a.metavar)
        for a in subparser._actions if a.option_strings and a.dest != "help"
    }


@pytest.mark.parametrize("command", SUBCOMMANDS)
def test_parser_matches_jax(command):
    """Same option strings, types, nargs, defaults and choices as the JAX
    package's subcommand; ``--device`` is the one difference."""
    jax_opts = _options(_subparsers("eks_tpu")[command])
    port_opts = _options(_subparsers("eks_tpu_torch")[command])
    device = port_opts.pop("--device")
    assert device[2:6] == ("_StoreAction", str, None, "cuda")
    assert set(port_opts) == set(jax_opts)
    for flag, spec in jax_opts.items():
        port_spec = port_opts[flag]
        if callable(spec[3]) and spec[3] not in (int, float, str):
            # the parser functions are the port's own copies
            assert port_spec[3].__name__ == spec[3].__name__, flag
            port_spec, spec = port_spec[:3] + port_spec[4:], spec[:3] + spec[4:]
        assert port_spec == spec, flag


# --------------------------------------------------------------------------- #
# end to end: both CLIs on the cropped sessions
# --------------------------------------------------------------------------- #
def _read(path):
    return pd.read_csv(path, header=[0, 1, 2], index_col=0)


def _gap(got_path, want_path):
    got, want = _read(got_path), _read(want_path)
    assert [tuple(map(str, c)) for c in got.columns] == [tuple(map(str, c)) for c in want.columns]
    assert got.shape == want.shape
    return float(np.abs(got.to_numpy() - want.to_numpy()).max())


# (family, argv after the input flags, {output file: atol}); fixed s where
# the fast goldens fix it, and the CLI's own defaults otherwise (quantile 95,
# variance inflation on)
E2E = [
    ("singlecam", ["singlecam", "--s", "2.0"], {"eks_singlecam.csv": 1e-4}),
    ("pupil", ["ibl-pupil", "--diameter-s", "0.99", "--com-s", "0.98"], {"eks_ibl_pupil.csv": 1e-4}),
    ("mirrored", ["mirrored-multicam", "--camera-names", "top", "bot", "--s", "3.0"],
     {"eks_mirrored_multicam.csv": 1e-4}),
    ("multicam", ["multicam", "--calibration", "{src}/calibration.toml", "--s", "10.0"],
     {"multicam_cam0_results.csv": 5e-4, "multicam_cam1_results.csv": 5e-4, "multicam_3d_results.csv": 1e-4}),
    ("paw", ["ibl-paw", "--s", "4.0"], {"multicam_left_results.csv": 1e-4, "multicam_right_results.csv": 1e-4}),
]


@pytest.mark.parametrize("family, argv, outputs", E2E, ids=[c[0] for c in E2E])
def test_cli_matches_jax_cli(tmp_path, cropped, family, argv, outputs):
    src = cropped(family)
    argv = [a.format(src=src) for a in argv]
    io = argv[:1] + ["--input-dir", src, "--save-dir"]
    _run(io + [str(tmp_path / "jax")] + argv[1:], entry=jax_main, prog="eks-tpu")
    _run_cpu(io + [str(tmp_path / "port")] + argv[1:])
    for name, atol in outputs.items():
        assert _gap(tmp_path / "port" / name, tmp_path / "jax" / name) <= atol, name


@pytest.mark.parametrize("argv, prefix", [
    (["singlecam", "--s", "2.0"], "eks_singlecam"),
    (["ibl-pupil", "--diameter-s", "0.99", "--com-s", "0.98"], "eks_ibl_pupil"),
])
def test_sessions_cli_matches_jax_cli(tmp_path, cropped, argv, prefix):
    """Two copies of the session in directories with the same basename:
    both CLIs name the outputs by position, and each session's table
    matches."""
    family = "singlecam" if argv[0] == "singlecam" else "pupil"
    srcs = [cropped(family, "a"), cropped(family, "b")]
    io = argv[:1] + ["--sessions", *srcs, "--save-dir"]
    _run(io + [str(tmp_path / "jax")] + argv[1:], entry=jax_main, prog="eks-tpu")
    _run_cpu(io + [str(tmp_path / "port")] + argv[1:])
    for i in range(2):
        name = f"{prefix}_{i}_{family}.csv"
        assert _gap(tmp_path / "port" / name, tmp_path / "jax" / name) <= 1e-4, name


def test_verbose_run_report(tmp_path, cropped, caplog):
    """``--verbose`` ends with the run report: the import's seconds from the
    process record, each stage's span once with its seconds, and every
    read and write on the native path."""
    import json

    with caplog.at_level(logging.DEBUG, logger="eks_tpu_torch.cli.main"):
        _run_cpu(["singlecam", "--input-dir", cropped("singlecam"), "--save-dir", str(tmp_path),
                  "--s", "2.0", "--verbose"])
    line = next(r.getMessage() for r in caplog.records if r.getMessage().startswith("run report: "))
    report = json.loads(line[len("run report: "):])
    assert report["process"]["import"] > 0
    stages = {"read", "prep", "optimizer", "final_pass", "package", "table", "write", "fit"}
    assert stages <= set(report["spans"])
    assert all(report["spans"][k]["n"] == 1 and report["spans"][k]["s"] > 0 for k in stages)
    launches = dict(report["launches"])
    # one pull of the results and one table wrapped around it (its index
    # built where not cached)
    assert launches.pop("output_pull") == 1 and launches.pop("frame/wrapped") == 1
    launches.pop("frame/index_built", None)
    assert launches == {}  # the CPU runs the kernels' plain versions
    assert report["s"] == [[2.0, 2.0, 2.0]]
    assert report["csv_reads"] == {"native": 5, "pandas": 0}
    assert report["csv_writes"] == {"native": 1, "pandas": 0}
