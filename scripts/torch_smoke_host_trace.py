#!/usr/bin/env python3
"""Run ``chip_smoke.py`` on the card with host-side recorders around every
optimizer run, to see where an Adam iteration's host time goes as the
script proceeds.

    python3 scripts/torch_smoke_host_trace.py [TRACE.jsonl] [--profile-lanes N ...]

chip_smoke's own output goes to stdout as usual. For each call of the
masked Adam loop (``core._joint_masked_adam``, also the pupil family's),
one JSON line goes to TRACE.jsonl (default
``chiprun_out/smoke_host_trace.jsonl``): its iterations, the wall of each
iteration (from one loss evaluation to the next) as the mean of the first
and of the last five and the largest, the seconds Python's garbage
collector ran during it (``gc.callbacks``) with the collections of each
generation, the objects the collector tracks at its start, and the CUDA
caching allocator's device allocations and allocation retries during it
(``torch.cuda.memory_stats``). With ``--profile-lanes``, the second and
third Adam iterations of every run over that many lanes (blocks) also run
under ``torch.profiler`` (host and device), and the line gains the host
operations with the most self time and the device kernels with the most
time. Needs a CUDA card, like chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    args = sys.argv[1:]
    profile_lanes = set()
    if "--profile-lanes" in args:
        i = args.index("--profile-lanes")
        profile_lanes = {int(a) for a in args[i + 1:]}
        args = args[:i]
    out_path = args[0] if args else os.path.join(REPO, "chiprun_out", "smoke_host_trace.jsonl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from eks_tpu_torch import core
    from eks_tpu_torch.models import ibl_pupil
    from eks_tpu_torch.ops.adam_step import MemberNLL

    gc_state = {"s": 0.0, "t0": None, "by_gen": [0, 0, 0]}

    def on_gc(phase, info):
        if phase == "start":
            gc_state["t0"] = time.perf_counter()
        elif gc_state["t0"] is not None:
            gc_state["s"] += time.perf_counter() - gc_state["t0"]
            gc_state["by_gen"][info["generation"]] += 1
            gc_state["t0"] = None

    gc.callbacks.append(on_gc)
    out = open(out_path, "w")
    adam = core._joint_masked_adam
    runs = [0]

    def top_ops(prof):
        """The host operations with the most self time and the device
        kernels with the most time, in ms over the profiled iterations."""
        ev = prof.key_averages()
        host = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
        dev = sorted(ev, key=lambda e: getattr(e, "self_device_time_total", 0), reverse=True)[:6]
        return {
            "host_total_ms": sum(e.self_cpu_time_total for e in ev) / 1e3,
            "device_total_ms": sum(getattr(e, "self_device_time_total", 0) for e in ev) / 1e3,
            "host_top": [[e.key[:60], e.count, e.self_cpu_time_total / 1e3] for e in host],
            "device_top": [[e.key[:60], e.count, getattr(e, "self_device_time_total", 0) / 1e3] for e in dev],
        }

    def traced_adam(loss_and_grad, init, *args, **kwargs):
        stamps = []
        prof = {}
        profiled = init.shape[0] in profile_lanes and init.dim() == 1

        evaluate = loss_and_grad.member_lls if isinstance(loss_and_grad, MemberNLL) else loss_and_grad

        def timed_loss(x):
            stamps.append(time.perf_counter())
            if profiled and len(stamps) == 2 and not torch.autograd.profiler._is_profiler_enabled:
                # (not inside chip_smoke's own profiled runs)
                prof["p"] = profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * init.is_cuda)
                prof["p"].__enter__()
            elif profiled and len(stamps) == 4 and "p" in prof:
                if init.is_cuda:
                    torch.cuda.synchronize()
                prof["p"].__exit__(None, None, None)
                prof["top"] = top_ops(prof.pop("p"))
            return evaluate(x)

        cuda = torch.cuda.is_available() and init.is_cuda
        mem0 = torch.cuda.memory_stats() if cuda else {}
        gc0, gen0 = gc_state["s"], list(gc_state["by_gen"])
        tracked = len(gc.get_objects())
        t0 = time.perf_counter()
        timed = (dataclasses.replace(loss_and_grad, member_lls=timed_loss) if evaluate is not loss_and_grad
                 else timed_loss)
        res = adam(timed, init, *args, **kwargs)
        if "p" in prof:
            prof.pop("p").__exit__(None, None, None)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stamps.append(time.perf_counter())
        its = [b - a for a, b in zip(stamps, stamps[1:])]
        mem1 = torch.cuda.memory_stats() if cuda else {}
        runs[0] += 1
        out.write(json.dumps({
            "run": runs[0], "lanes": list(init.shape), "iters": len(its), "wall_s": wall,
            "iter_s_first5": sum(its[:5]) / max(1, len(its[:5])), "iter_s_last5": sum(its[-5:]) / max(1, len(its[-5:])),
            "iter_s_max": max(its, default=0.0), "gc_s": gc_state["s"] - gc0,
            "gc_collections_by_generation": [b - a for a, b in zip(gen0, gc_state["by_gen"])],
            "gc_tracked_objects_at_start": tracked,
            "cuda_device_allocs": mem1.get("num_device_alloc", 0) - mem0.get("num_device_alloc", 0),
            "cuda_alloc_retries": mem1.get("num_alloc_retries", 0) - mem0.get("num_alloc_retries", 0),
            "cuda_reserved_gib": mem1.get("reserved_bytes.all.current", 0) / 2**30,
            **({"profile_iters_2_3": prof["top"]} if "top" in prof else {}),
        }) + "\n")
        out.flush()
        return res

    core._joint_masked_adam = traced_adam
    ibl_pupil._joint_masked_adam = traced_adam
    try:
        return chip_smoke.main()
    finally:
        out.close()


if __name__ == "__main__":
    sys.exit(main())
