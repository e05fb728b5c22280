"""Shared CLI helpers: IO validation, argument builders, parsers, device
set-up, the run report, plotting.

A copy of the JAX package's ``eks_tpu/cli/_utils.py``: the same flags with
the same types, ``nargs``, defaults and choices, including the bare-integer
``--s-frames`` shorthand (``'100'`` parses to ``[(1, 100)]``). One flag is
the port's own: ``--device`` (default ``cuda``), where the smoother runs,
forwarded to every entry point as ``device=``; with ``cuda`` and no card the
run fails, it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from eks_tpu_torch import tracing
from eks_tpu_torch.ops import cuda_build
from eks_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

_SPAN_RE = re.compile(r"\(([0-9]*),([0-9]*)\)")


def handle_io(input_dir, save_dir) -> Path:
    """Check the input directory exists and resolve the output directory
    (``./outputs`` is created and used when none is given)."""
    if not Path(input_dir).is_dir():
        raise ValueError(
            f"--input-dir points at {input_dir!r}, which is not a directory"
        )
    if save_dir is None:
        out = Path.cwd() / "outputs"
        out.mkdir(parents=True, exist_ok=True)
        return out
    return Path(save_dir)


def resolve_input(args) -> tuple:
    """Resolve a command's ``(input_source, input_dir)`` from --input-dir /
    --input-files (shared by all five subcommands; previously copy-pasted).

    ``input_source`` is what the fit_* wrapper consumes (a directory path or
    the file list); ``input_dir`` anchors the default save directory.
    """
    input_source = (
        args.input_dir if args.input_dir is not None else args.input_files
    )
    if isinstance(input_source, str):
        return input_source, Path(input_source).resolve()
    if not input_source:
        raise ValueError(
            "no input given: pass --input-dir DIR or --input-files FILE..."
        )
    return input_source, Path(input_source[0]).resolve().parent


def sessions_save_files(session_dirs, save_dir, prefix: str) -> list[str]:
    """Resolve per-session output CSV paths for ``--sessions`` mode.

    With ``--save-dir``, every session's CSV goes there as
    ``{prefix}_{dirname}.csv`` — unless two sessions share a directory
    basename, in which case every file gains the session's position
    (``{prefix}_{i}_{dirname}.csv``) so no session silently overwrites
    another. Without ``--save-dir``, each session's CSV is written next to
    its own input directory (``<session_dir>/outputs/{prefix}.csv``), which
    cannot collide.
    """
    for d in session_dirs:
        if not Path(d).is_dir():
            raise ValueError(
                f"--sessions entry {str(d)!r} is not a directory"
            )
    if save_dir is None:
        files = []
        for d in session_dirs:
            out = Path(d) / "outputs"
            out.mkdir(parents=True, exist_ok=True)
            files.append(str(out / f"{prefix}.csv"))
        return files
    out = Path(save_dir)
    out.mkdir(parents=True, exist_ok=True)
    names = [Path(d).name for d in session_dirs]
    if len(set(names)) != len(names):
        return [
            str(out / f"{prefix}_{i}_{n}.csv") for i, n in enumerate(names)
        ]
    return [str(out / f"{prefix}_{n}.csv") for n in names]


def parse_s_frames(text: str) -> list[tuple[int | None, int | None]]:
    """Parse an ``--s-frames`` value.

    Accepts a bare integer N (meaning frames 1..N) or a list of
    ``(start,end)`` pairs where either side may be left empty for an open
    end, e.g. ``'[(0,100),(250,)]'``.
    """
    spec = text.strip()
    if spec.isdigit():
        return [(1, int(spec))]
    pairs = _SPAN_RE.findall(re.sub(r"\s", "", spec))
    if not pairs:
        raise argparse.ArgumentTypeError(
            f"--s-frames got {text!r}; give an integer N or windows like "
            "'[(0,100),(250,)]'"
        )
    windows: list[tuple[int | None, int | None]] = []
    for lo_str, hi_str in pairs:
        lo = int(lo_str) if lo_str else None
        hi = int(hi_str) if hi_str else None
        if lo is not None and hi is not None and lo > hi:
            raise argparse.ArgumentTypeError(
                f"--s-frames window ({lo}, {hi}) runs backwards"
            )
        windows.append((lo, hi))
    return windows


def parse_blocks(text: str) -> list[list[int]]:
    """Parse a ``--blocks`` value: ';'-separated groups of comma-separated
    0-based keypoint indices, e.g. ``'0,1,2;3,4'``."""
    groups: list[list[int]] = []
    for chunk in text.split(";"):
        try:
            groups.append([int(tok) for tok in chunk.split(",")])
        except ValueError as e:
            raise argparse.ArgumentTypeError(
                f"--blocks could not read group {chunk!r}; expected "
                "comma-separated integers"
            ) from e
    return groups


# --------------------------------------------------------------------------- #
# argument builders — one declarative spec per flag, wrapped into the
# add_* functions the subcommand modules compose
# --------------------------------------------------------------------------- #
def _builder(*flag_defs):
    def add(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        for flags, kwargs in flag_defs:
            parser.add_argument(*flags, **kwargs)
        return parser

    return add


add_common_args = _builder(
    (("--input-dir",), dict(
        type=str,
        help="directory holding the ensemble's prediction CSV files",
    )),
    (("--input-files",), dict(
        nargs="+",
        help="explicit prediction files (may live in different directories)",
    )),
    (("--save-dir",), dict(
        type=str, default=None,
        help="where to write results (defaults to ./outputs)",
    )),
    (("--save-filename",), dict(
        type=str, default=None,
        help="output filename; a default is derived from the smoother family",
    )),
    (("--s-frames",), dict(
        type=parse_s_frames, default=None,
        help=(
            "frame window(s) the smoothing-parameter search runs on: a bare "
            "integer N for frames 1..N, or windows like '[(0,500),(1000,)]' "
            "with open ends allowed; has no effect when --s fixes the "
            "parameter"
        ),
    )),
    (("--blocks",), dict(
        type=parse_blocks, default=[],
        help=(
            "';'-separated groups of 0-based keypoint indices that share one "
            "smoothing parameter, e.g. '0,1,2;3,4'; default is one parameter "
            "per keypoint"
        ),
    )),
    (("--verbose",), dict(
        action="store_true",
        help="log optimizer iterations and per-stage timings",
    )),
    (("--make-plot",), dict(
        action="store_true",
        help="write per-keypoint diagnostic PDFs next to the results",
    )),
)

add_devices = _builder(
    (("--device",), dict(
        type=str, default="cuda",
        help=(
            "where the smoother runs: 'cuda' (the default; fails when no "
            "CUDA card is visible) or 'cpu' (the plain PyTorch versions of "
            "the kernels)"
        ),
    )),
    (("--devices",), dict(
        type=int, default=None,
        help=(
            "shard the smoothing step over this many devices of --device's "
            "type (cuda:0 .. cuda:N-1; fails when the host has fewer cards); "
            "default = single device"
        ),
    )),
    (("--partition",), dict(
        type=str, default="keypoint", choices=("keypoint", "time"),
        help=(
            "mesh axis for --devices: 'keypoint' = data parallelism over "
            "independent keypoint lanes (default), 'time' = sequence "
            "parallelism splitting the frame axis of the prefix scans"
        ),
    )),
)

add_bodyparts = _builder(
    (("--bodypart-list",), dict(
        nargs="+",
        help="subset of bodyparts to process (default: every bodypart found)",
    )),
)

add_s = _builder(
    (("--s",), dict(
        nargs="+", type=float,
        help=(
            "fix the smoothing parameter instead of auto-tuning; give one "
            "value for all bodyparts, or one value per bodypart"
        ),
    )),
)

add_camera_names = _builder(
    (("--camera-names",), dict(
        required=False, nargs="+",
        help=(
            "one name per camera view; prediction files are assigned to "
            "cameras by filename substring. needed for multicam without "
            "--calibration and for mirrored-multicam; the calibration "
            "file's own names take precedence when --calibration is given"
        ),
    )),
)

add_quantile_keep_pca = _builder(
    (("--quantile-keep-pca",), dict(
        type=float, default=95,
        help=(
            "keep this percentage of frames (lowest ensemble variance) "
            "when fitting the multi-view PCA"
        ),
    )),
)

add_inflate_vars = _builder(
    (("--no-inflate-vars",), dict(
        dest="inflate_vars", action="store_false", default=True,
        help="turn off the Mahalanobis-gated variance inflation pass",
    )),
)

add_n_latent = _builder(
    (("--n-latent",), dict(
        type=int, default=3,
        help="latent dimensionality of the multi-view PCA state",
    )),
)

add_calibration = _builder(
    (("--calibration",), dict(
        type=str, default=None,
        help="Anipose-style calibration TOML enabling the 3D multicam path",
    )),
)

add_diameter_s = _builder(
    (("--diameter-s",), dict(
        type=float,
        help="pupil-diameter AR(1) coefficient in (0, 1); larger = smoother",
    )),
)

add_com_s = _builder(
    (("--com-s",), dict(
        type=float,
        help="pupil center-of-mass AR(1) coefficient in (0, 1); larger = smoother",
    )),
)


# --------------------------------------------------------------------------- #
# device set-up and the run report
# --------------------------------------------------------------------------- #
def prepare_device(args: argparse.Namespace) -> None:
    """Check ``--device`` and make the card ready before any input is read:
    create the CUDA context (the span "device_context"), build the kernel
    libraries that are not built yet (one ``nvcc`` each, in parallel) and
    load them (the process record's "kernel_build.<lib>" and
    "kernel_load.<lib>"). Raises when ``cuda`` is asked for and no card is
    visible."""
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        return
    span = tracing.begin(args.timings, "device_context")
    torch.zeros(1, device=dev)
    tracing.end(args.timings, span, dev)
    cuda_build.build()
    for name in cuda_build.KERNEL_SOURCES:
        cuda_build.load(name)


def timed_fit(args: argparse.Namespace, fit, **kwargs):
    """``fit(**kwargs)`` in the span "fit", and the smoothing parameters it
    ended with in the run report as "s", one list per session (every entry
    point returns them second; a sessions entry point returns one result
    per session)."""
    span = tracing.begin(args.timings, "fit")
    out = fit(**kwargs)
    tracing.end(args.timings, span)
    runs = out if isinstance(out, list) else [out]
    args.report["s"] = [np.asarray(run[1], dtype=float).tolist() for run in runs]
    return out


# --------------------------------------------------------------------------- #
# diagnostics plotting
# --------------------------------------------------------------------------- #
_GREY = (0.5, 0.5, 0.5)


def _eks_trace(output_df: pd.DataFrame, key: str, coord: str, window):
    return output_df.loc[window, ("ensemble-kalman_tracker", key, coord)]


def plot_results(
    output_df: pd.DataFrame,
    input_dfs_list: list[pd.DataFrame],
    key: str,
    s_final,
    nll_values,
    idxs: tuple[int, int],
    save_dir: str,
    smoother_type: str,
    coords: list[str] = ["x", "y", "likelihood"],
) -> None:
    """One stacked panel per coordinate: grey traces for each ensemble member,
    black for the EKS output. Saves ``{smoother_type}_{key}.pdf``."""
    import matplotlib.pyplot as plt

    window = slice(*idxs)
    fig, axes = plt.subplots(len(coords), 1, figsize=(9, 10))

    for ax, coord in zip(axes, coords, strict=True):
        if coord == "zscore":
            # disagreement panel: EKS-only, no member traces exist for it
            ax.plot(_eks_trace(output_df, key, coord, window), color="k", linewidth=2)
            ax.set_ylabel("ensemble disagreement (z)", fontsize=12)
            ax.set_xlabel("Time (frames)", fontsize=12)
            continue
        for m, member_df in enumerate(input_dfs_list):
            ax.plot(
                member_df.loc[window, f"{key}_{coord}"],
                color=_GREY,
                label="ensemble members" if m == 0 else None,
            )
        if coord == "likelihood":
            ax.set_ylabel("member likelihoods", fontsize=12)
            continue
        ax.plot(
            _eks_trace(output_df, key, coord, window),
            color="k", linewidth=2, label="EKS",
        )
        ax.set_ylabel(coord, fontsize=12)
        if coord == "x":
            ax.legend()

    if nll_values is not None:
        axes[-1].plot(range(*idxs), nll_values[window], color="k", linewidth=2)
        axes[-1].set_ylabel("EKS NLL", fontsize=12)

    if isinstance(s_final, tuple):
        s_text = "(" + ", ".join(f"{v:.2f}" for v in s_final) + ")"
    else:
        s_text = f"{s_final:.2f}"
    fig.suptitle(f"EKS results for {key}, smoothing = {s_text}", fontsize=14)
    fig.tight_layout()
    pdf_path = os.path.join(save_dir, f"{smoother_type}_{key}.pdf")
    fig.savefig(pdf_path)
    plt.close(fig)
    logger.info(f"diagnostic plot saved to {pdf_path}")
