"""Entry point for the eks-tpu-torch CLI.

    eks-tpu-torch singlecam --input-dir DIR --save-dir OUT
    python -m eks_tpu_torch.cli.main singlecam --input-dir DIR --save-dir OUT

Subcommands are discovered: every ``cmd_*.py`` module in this package is
imported and its ``register(subparsers)`` called, as in the JAX package's
``eks_tpu/cli/main.py``. Every subcommand runs on the CUDA card unless it is
given ``--device cpu``.

With ``--verbose`` the ``eks_tpu_torch`` loggers log at DEBUG, and the run
ends with one DEBUG line ``run report: {...}`` (JSON): the seconds of each
stage ("imports" from the start of the package's import to the parsed
command line; "device_context", "kernel_build" and "kernel_load" for the
card; "fit", the entry point's call, and within it the stages the entry
point records, "read" and "write" for the CSVs among them), the smoothing
parameters the run ended with ("s", one list per session), the libraries
compiled by this run, and which path each CSV read and write took.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import time
from pathlib import Path

import eks_tpu_torch
from eks_tpu_torch import native

# named, not __name__: under `python -m` this module is __main__
logger = logging.getLogger("eks_tpu_torch.cli.main")


def main() -> None:
    parser = argparse.ArgumentParser(
        prog="eks-tpu-torch",
        description="Ensemble Kalman Smoother for pose estimation, in PyTorch and CUDA.",
    )
    parser.add_argument(
        "--version", action="version", version=f"eks-tpu-torch {eks_tpu_torch.__version__}"
    )
    subparsers = parser.add_subparsers(title="subcommands", dest="subcommand")
    subparsers.required = True

    cli_dir = Path(__file__).parent
    for module_path in sorted(cli_dir.glob("cmd_*.py")):
        module = importlib.import_module(f"eks_tpu_torch.cli.{module_path.stem}")
        module.register(subparsers)

    args = parser.parse_args()
    args.report = {"seconds": {"imports": time.perf_counter() - eks_tpu_torch._IMPORT_STARTED}}
    # logger names split on dots: eks_tpu_torch is not a child of eks_tpu
    logging.basicConfig(format="%(levelname)s:%(name)s: %(message)s" if args.verbose else "%(message)s")
    logging.getLogger("eks_tpu_torch").setLevel(logging.DEBUG if args.verbose else logging.INFO)
    reads, writes, built = dict(native.READS), dict(native.WRITES), set(native.BUILT)
    args.handler(args)

    args.report.update(
        csv_reads={k: v - reads[k] for k, v in native.READS.items()},
        csv_writes={k: v - writes[k] for k, v in native.WRITES.items()},
        csv_libraries_built={k: v for k, v in native.BUILT.items() if k not in built},
    )
    logger.debug("run report: %s", json.dumps(args.report))


if __name__ == "__main__":
    main()
