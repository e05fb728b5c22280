"""Where a command-line run's wall goes in a fresh process, beyond the
smoothing itself.

    python3 scripts/torch_cli_cold_start.py [--reps 2] [--device cuda|cpu]

Builds the kernels, writes chip_smoke.py's headline session (10,000 frames x 20 keypoints x 5
seeds, seed 0) as 5 DLC CSVs in a temporary directory and, ``--reps`` times
each, in turns, runs three fresh processes from the root of the checkout,
each timed from start to exit:

  - ``imports``: imports torch, then ``eks_tpu_torch``, then ``torch._dynamo``
    (which the first forward-mode call through one of torch's Python
    references imports lazily), then makes the CUDA context, printing each
    step's seconds; the process's wall less their sum is the interpreter's
    start and exit;
  - ``cli``: ``python -m eks_tpu_torch.cli.main singlecam --verbose`` on the
    CSVs, as a user runs it, with its run report (the process record's
    seconds and each span's);
  - ``cli_dynamo_first``: the same command line with ``torch._dynamo``
    imported before it starts, so the optimizer's seconds in its report
    lack that import.

Then runs the entry point twice in this process (the second run warm) for
the smoothing's own wall. Prints one JSON line with every reading, the card's
name and power limit beside it. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORTS = """
import json, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
import eks_tpu_torch
t2 = time.perf_counter()
import torch._dynamo
t3 = time.perf_counter()
if {cuda}:
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
t4 = time.perf_counter()
print(json.dumps({{"torch": t1 - t0, "eks_tpu_torch": t2 - t1, "torch_dynamo": t3 - t2,
                  "cuda_context": t4 - t3}}))
"""

DYNAMO_FIRST = (
    "import runpy, sys, torch._dynamo; sys.argv = ['eks-tpu-torch'] + sys.argv[1:]; "
    "runpy.run_module('eks_tpu_torch.cli.main', run_name='__main__')"
)


def timed(cmd):
    """(wall seconds, completed process) of ``cmd`` run from the checkout's
    root; raises if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[:3]} ended with {proc.returncode}:\n{proc.stderr[-3000:]}")
    return wall, proc


def run_report(proc) -> dict:
    found = re.search(r"run report: (\{.*\})", proc.stderr)
    if found is None:
        raise RuntimeError("no run report in the command line's output")
    return json.loads(found.group(1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import pandas as pd
    import torch

    import chip_smoke
    import eks_tpu_torch
    from eks_tpu_torch.utils import save_dlc_csv

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_cli_cold_start: no CUDA card visible", file=sys.stderr)
        return 2
    card = chip_smoke.gpu_name_power() if args.device == "cuda" else "cpu"
    out = {"card": card, "device": args.device, "imports": [], "cli": [], "cli_dynamo_first": []}
    if args.device == "cuda":
        # build first, so that no timed process builds a kernel
        from eks_tpu_torch.ops import cuda_build

        t0 = time.perf_counter()
        cuda_build.build()
        out["build_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        arr = chip_smoke.make_session(np, np.random.default_rng(0))
        T, K, M = arr.shape[2], arr.shape[3], arr.shape[0]
        kps = [f"kp{i}" for i in range(K)]
        src = os.path.join(tmp, "headline")
        os.makedirs(src)
        for m in range(M):
            cols = pd.MultiIndex.from_product([[f"seed{m}"], kps, ["x", "y", "likelihood"]],
                                              names=["scorer", "bodyparts", "coords"])
            save_dlc_csv(pd.DataFrame(arr[m, 0].reshape(T, K * 3), columns=cols),
                         os.path.join(src, f"session.rng={m}.csv"))
        cli_args = ["singlecam", "--input-dir", src, "--save-dir", os.path.join(tmp, "out"), "--verbose",
                    "--device", args.device]
        for _ in range(args.reps):
            wall, proc = timed([sys.executable, "-c", IMPORTS.format(cuda=args.device == "cuda")])
            steps = json.loads(proc.stdout.strip().splitlines()[-1])
            out["imports"].append({"wall_s": wall, **steps, "start_and_exit": wall - sum(steps.values())})
            for key, cmd in (("cli", [sys.executable, "-m", "eks_tpu_torch.cli.main", *cli_args]),
                             ("cli_dynamo_first", [sys.executable, "-c", DYNAMO_FIRST, *cli_args])):
                wall, proc = timed(cmd)
                rep = run_report(proc)
                out[key].append({"wall_s": wall, **rep["process"], **{k: v["s"] for k, v in rep["spans"].items()}})
        in_process = []
        for _ in range(2):
            tm = {}
            t0 = time.perf_counter()
            eks_tpu_torch.fit_eks_singlecam(src, os.path.join(tmp, "in.csv"), device=args.device, timings=tm)
            in_process.append({"wall_s": time.perf_counter() - t0,
                               **{k: v for k, v in tm.items() if k not in ("spans", "counts")}})
        out["in_process_first_then_warm"] = in_process
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
