"""The device trace of a run: what ran on the card, and when it idled.

A traced segment runs a few jobs under ``torch.profiler`` with device
activity only. Its timeline gives every device operation's start and
length; the union of those intervals is the busy time, and the gaps between
them are idle time. The segment opens with one small kernel launched at a
known host time, which ties the device clock to the host's, so that each
idle gap can be placed in the job stage (``timings``) the host was in.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the stages an entry point's ``timings`` records, in the order they run
STAGES = ("prep", "optimizer", "final_pass", "package")


def entry_stages(timings: dict | None) -> list:
    return [[k, timings[k]] for k in STAGES if timings and k in timings]


def profile(torch, run_jobs):
    """Run ``run_jobs()`` (which returns the host record of each job it ran:
    ``{"t0", "t1", "stages"}``, the stages as [name, seconds] in the order
    they ran from ``t0``) under a device-only profile. Returns
    ``{"events": [(name, start_s, dur_s)], "jobs", "window_s"}`` with event
    times on the host's clock (``time.perf_counter``)."""
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        jobs = run_jobs()
        torch.cuda.synchronize()
        h1 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    events = sorted(
        ((e["name"], float(e["ts"]) / 1e6, float(e.get("dur", 0.0)) / 1e6)
         for e in raw.get("traceEvents", [])
         if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES),
        key=lambda e: e[1],
    )
    offset = events[0][1] - h0 if events else 0.0
    events = [(n, s - offset, d) for n, s, d in events]
    return {"events": events, "jobs": jobs, "window_s": h1 - h0}


def busy_intervals(events) -> list[tuple[float, float]]:
    """The union of the events' intervals, in order."""
    out: list[list[float]] = []
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return [(a, b) for a, b in out]


def busy_s(events) -> float:
    return sum(b - a for a, b in busy_intervals(events))


def stage_at(jobs, t: float) -> str:
    """The job stage the host was in at host time ``t``."""
    for job in jobs:
        if job["t0"] <= t <= job["t1"]:
            at = job["t0"]
            for stage, seconds in job.get("stages", []):
                at += seconds
                if t < at:
                    return stage
            return "job_rest"
    return "between_jobs"


def idle_gaps(seg, top: int = 10) -> list[list]:
    """The ``top`` longest idle gaps inside the traced segment, each as
    [the stage the host was in, seconds]."""
    spans = busy_intervals(seg["events"])
    gaps = [(b0 - a1, (a1 + b0) / 2) for (_, a1), (b0, _) in zip(spans, spans[1:]) if b0 > a1]
    gaps.sort(reverse=True)
    return [[stage_at(seg["jobs"], mid), g] for g, mid in gaps[:top]]


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return re.sub(r"^void ", "", "".join(out)).strip()[:96]


def top_ops(events, top: int = 10) -> list[list]:
    """The ``top`` device operations by total time, each [name, seconds]."""
    total: dict[str, float] = {}
    for n, _, d in events:
        k = short_name(n)
        total[k] = total.get(k, 0.0) + d
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def device_seconds(events, patterns) -> float:
    """Device seconds of the operations whose names match any of the
    regular expressions ``patterns``."""
    rx = [re.compile(p) for p in patterns]
    return sum(d for n, _, d in events if any(r.search(n) for r in rx))
