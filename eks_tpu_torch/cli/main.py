"""Entry point for the eks-tpu-torch CLI.

    eks-tpu-torch singlecam --input-dir DIR --save-dir OUT
    python -m eks_tpu_torch.cli.main singlecam --input-dir DIR --save-dir OUT

Subcommands are discovered: every ``cmd_*.py`` module in this package is
imported and its ``register(subparsers)`` called, as in the JAX package's
``eks_tpu/cli/main.py``. Every subcommand runs on the CUDA card unless it is
given ``--device cpu``.

With ``--verbose`` the ``eks_tpu_torch`` loggers log at DEBUG, and the run
ends with one DEBUG line ``run report: {...}`` (JSON), built from the
recorder (``eks_tpu_torch.tracing``):

* "process": the process record's seconds: "import" (the package's
  import), "kernel_load.<lib>" and, where ``nvcc`` ran, "kernel_build.<lib>"
  for each kernel library, "first_call" (the entry point's call) and
  "adam.loss" (the first Adam iteration's loss);
* "spans": for each span name the run recorded, its total seconds and
  count ("s", "n"): "device_context" (the CUDA context), "fit" (the entry
  point's call) and within it the spans the entry point records ("read"
  and "write" for the CSVs, "prep", "optimizer", "final_pass", "package",
  "table", and the Adam iterations' "adam.stop_test", "adam.loss",
  "adam.update"); an entry point with no ``timings`` records only "fit";
* "launches": this run's kernel launches by instance, the registry's key
  joined by "/";
* "s", the smoothing parameters the run ended with (one list per
  session), and which path each CSV read and write took, with the CSV
  libraries compiled by this run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
from pathlib import Path

import eks_tpu_torch
from eks_tpu_torch import native, tracing

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
    # the entry point's and the CLI's own spans, recorded under --verbose only
    args.timings = {} if args.verbose else None
    args.report = {}
    # logger names split on dots: eks_tpu_torch is not a child of eks_tpu
    logging.basicConfig(format="%(levelname)s:%(name)s: %(message)s" if args.verbose else "%(message)s")
    logging.getLogger("eks_tpu_torch").setLevel(logging.DEBUG if args.verbose else logging.INFO)
    reads, writes, built = dict(native.READS), dict(native.WRITES), set(native.BUILT)
    launched = tracing.snapshot()
    args.handler(args)

    if args.verbose:
        totals: dict = {}
        for name, t0, t1, _ in args.timings.get("spans", []):
            total = totals.setdefault(name, {"s": 0.0, "n": 0})
            total["s"] += t1 - t0
            total["n"] += 1
        args.report.update(
            process={k: v for k, v in tracing.process().items() if k != "spans"},
            spans=totals,
            launches={"/".join(map(str, k)): v for k, v in tracing.since(launched).items()},
        )
    args.report.update(
        csv_reads={k: v - reads[k] for k, v in native.READS.items()},
        csv_writes={k: v - writes[k] for k, v in native.WRITES.items()},
        csv_libraries_built={k: v for k, v in native.BUILT.items() if k not in built},
    )
    logger.debug("run report: %s", json.dumps(args.report))


if __name__ == "__main__":
    main()
