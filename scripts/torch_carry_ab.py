#!/usr/bin/env python3
"""The time-sharded scans and paths of several checkouts on one card, in turn.

    python3 scripts/torch_carry_ab.py --roots _checkout/parent . . _checkout/parent

From the root of a checkout, on a host with a CUDA card (``_checkout/parent``
from ``git archive <commit>``). Each root runs in a child process of its own,
with its own kernels (built into that root's ``eks_tpu_torch/_build/``), on
four time shards of cuda:0, as ``chip_smoke.py``'s phase 22 runs them:

- the sharded scan of four 2,500-step chunks of phase 22's elements, at the
  instances the time-axis paths run (filter and smoother, float and paired,
  D = 2 on 20 lanes, D = 3 on 2 lanes): the device time of one call (the
  port's own kernels under the profiler, summed over the call's launches,
  96 MB written between calls so that every call reads from device memory)
  and its host wall (the call and its synchronise, median of 30);
- the headline (10,000 frames x 20 keypoints x 5 seeds, auto-s) on one
  device and on four time chunks, and the pupil solo session on four time
  chunks with its optimizer capped at 200 Adam iterations, twice each:
  wall and ms an Adam iteration.

Prints one JSON line per root, then per root name the quartiles of its
readings over its runs, and the card's name and power limit; with ``--out``
writes them to that file too. About 2.5 minutes a root, the first of each
root with its build.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (kind, D, lanes), paired and float: the time-axis paths' instances
INSTANCES = [("filter", 2, 20), ("smoother", 2, 20), ("filter", 3, 2), ("smoother", 3, 2)]
CHUNK = 2500
CAP_PUPIL = 200


def _chip_smoke():
    """This checkout's chip_smoke.py (its data recipes and helpers), loaded
    under its own name so that a root's copy cannot shadow it."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms_per_call(torch, fn, reps, profiles=4):
    """(device milliseconds of one call of ``fn``, launches a call by
    kernel): the port's own kernels (those in a top-level anonymous
    namespace) under the profiler over ``reps`` calls, ``profiles`` times.
    A profile now and then drops a few launches' records, so a kernel's
    launches a call are the most any profile recorded, over ``reps``, and
    its time a launch is the mean over every launch recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total, count, most = {}, {}, {}
    for _ in range(profiles):
        seen = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            scope, _, rest = e.key.partition("(anonymous namespace)::")
            if e.device_type == torch.autograd.DeviceType.CUDA and rest and scope.strip() in ("", "void"):
                name = rest.split("<")[0].split("(")[0]
                total[name] = total.get(name, 0.0) + e.self_device_time_total / 1e3
                count[name] = count.get(name, 0) + e.count
                seen[name] = seen.get(name, 0) + e.count
        for name, n in seen.items():
            most[name] = max(most.get(name, 0), n)
    if not most:
        raise RuntimeError("device_ms_per_call: the profiler recorded none of the port's kernels")
    launches = {name: round(n / reps) for name, n in most.items()}
    return sum(total[k] / count[k] * launches[k] for k in launches), launches


def child(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    cs = _chip_smoke()
    import eks_tpu_torch
    from eks_tpu_torch.marker_array import MarkerArray
    from eks_tpu_torch.models import ibl_pupil
    from eks_tpu_torch.ops import cuda_build, fused_filter, pkalman
    from eks_tpu_torch.parallel import mesh as pmesh

    if not os.path.samefile(os.path.dirname(eks_tpu_torch.__file__), os.path.join(root, "eks_tpu_torch")):
        raise RuntimeError(f"imported {eks_tpu_torch.__file__}, not the package of {root}")
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    cuda_build.build()
    build_s = time.perf_counter() - t0
    flush = torch.empty(24 * 2 ** 20, dtype=torch.float32, device=dev)

    scans = {}
    for kind, D, N in INSTANCES:
        g = np.random.default_rng(22 + D)
        T = 4 * CHUNK
        ys = torch.as_tensor(g.normal(size=(N, T, D)).cumsum(1) * 0.1, dtype=torch.float32, device=dev)
        r = torch.as_tensor(g.uniform(0.5, 2.0, size=(N, T, D)), dtype=torch.float32, device=dev)
        eye = torch.eye(D, device=dev).expand(N, D, D).contiguous()

        def make(sl):
            Q = torch.exp(sl)[:, None, None] * eye * 0.1
            el = pkalman._make_filter_elements_tv(ys, torch.zeros(N, D, device=dev), eye, eye * 0.95, Q,
                                                  eye[:, None].expand(N, T, D, D), r)
            if kind == "smoother":
                ms, Ps = pkalman._filtered_moments(fused_filter.filter_prefix_plain(el), D)
                el = pkalman._make_smoother_elements(ms, Ps, eye * 0.95, Q)
            return el

        sl = torch.zeros(N, device=dev)
        planes, tangents = (x.contiguous() for x in torch.func.jvp(make, (sl,), (torch.ones_like(sl),)))
        chunks = [x.contiguous() for x in torch.tensor_split(planes, 4, dim=-1)]
        dchunks = [x.contiguous() for x in torch.tensor_split(tangents, 4, dim=-1)]
        for paired in (False, True):
            if kind == "filter":
                sharded = pmesh.filter_prefix_paired_sharded if paired else pmesh.filter_prefix_sharded
            else:
                sharded = pmesh.smoother_suffix_paired_sharded if paired else pmesh.smoother_suffix_sharded

            def call(sharded=sharded, paired=paired):
                return sharded(chunks, dchunks) if paired else sharded(chunks)

            def flushed(call=call):
                flush.zero_()
                return call()

            dev_ms, launches = device_ms_per_call(torch, flushed, 20)
            walls = []
            for _ in range(30):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
            scans[f"{kind}{'_paired' if paired else ''}_d{D}"] = {
                "lanes": N, "device_ms": dev_ms, "launches_per_call": launches,
                "host_wall_ms": float(np.median(walls))}

    fields = ["x", "y", "likelihood"]
    head_ma = MarkerArray(cs.make_session(np, np.random.default_rng(0)), data_fields=fields)
    head_kps = [f"kp{i}" for i in range(cs.K_HEAD)]
    pupil_ma = MarkerArray(cs.make_pupil_session(np, np.random.default_rng(0)), data_fields=fields)
    runs = {
        "headline_one_device": lambda tm: eks_tpu_torch.ensemble_kalman_smoother_singlecam(
            head_ma, head_kps, device="cuda", timings=tm),
        "headline_time": lambda tm: eks_tpu_torch.ensemble_kalman_smoother_singlecam(
            head_ma, head_kps, device="cuda", devices=4, partition="time", timings=tm),
        "pupil_time": lambda tm: eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
            pupil_ma, ibl_pupil.BODYPART_LIST, safety_cap=CAP_PUPIL, device="cuda", devices=4, timings=tm),
    }
    real = pmesh.make_mesh
    pmesh.make_mesh = lambda n_devices=None, device="cuda": (dev,) * int(n_devices)
    paths = {name: {"wall_s": [], "ms_per_adam_iter": []} for name in runs}
    try:
        for _ in range(2):
            for name, run in runs.items():
                tm = {}
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run(tm)
                torch.cuda.synchronize()
                paths[name]["wall_s"].append(time.perf_counter() - t1)
                # the pupil's optimizer runs its cap (it reports no count)
                iters = tm.get("adam_iters", CAP_PUPIL)
                paths[name]["ms_per_adam_iter"].append(tm["optimizer"] / iters * 1e3)
    finally:
        pmesh.make_mesh = real
    return {"root": root, "build_s": build_s, "sharded_scans_4_chunks": scans, "paths": paths}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", help="checkouts to run, in this order, one child each")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_carry_ab: needs a CUDA card", file=sys.stderr)
        return 2
    lines = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root], cwd=REPO,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            return proc.returncode
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(lines[-1]), flush=True)

    def quartiles(xs):
        return [float(q) for q in np.percentile(xs, [25, 50, 75])]

    summary = {}
    for root in dict.fromkeys(args.roots):
        mine = [ln for ln in lines if ln["root"] == root]
        summary[root] = {
            "scan_device_ms": {k: quartiles([ln["sharded_scans_4_chunks"][k]["device_ms"] for ln in mine])
                               for k in mine[0]["sharded_scans_4_chunks"]},
            "scan_host_wall_ms": {k: quartiles([ln["sharded_scans_4_chunks"][k]["host_wall_ms"] for ln in mine])
                                  for k in mine[0]["sharded_scans_4_chunks"]},
            "paths": {name: {m: quartiles([v for ln in mine for v in ln["paths"][name][m]])
                             for m in ("wall_s", "ms_per_adam_iter")} for name in mine[0]["paths"]},
        }
    card = _chip_smoke().gpu_name_power()
    print(json.dumps({"quartiles_by_root": summary, "card": card}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": lines, "quartiles_by_root": summary, "card": card}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
