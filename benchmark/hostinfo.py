"""Facts about the host a run stands on, printed on its earlier lines so
that spreads between hosts can be read from the runs, and what the host
did while the window ran: the machine's CPU time stolen by the hypervisor,
this process's CPU time and involuntary context switches, the load, and
the garbage collector's passes and pauses."""

from __future__ import annotations

import gc
import os
import resource
import subprocess
import time

_GPU_QUERY = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu,memory.used"


def nvidia_smi(query: str = _GPU_QUERY) -> list[str]:
    """One CSV line per card for ``query``, or the error in its place."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]
    return out.stdout.strip().splitlines() or [f"nvidia-smi rc={out.returncode}: {out.stderr.strip()}"]


def cpu_model() -> str:
    """The CPU's model name, from ``lscpu`` (which knows more machines than
    ``/proc/cpuinfo`` spells out)."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    for line in out.splitlines():
        key, _, value = line.partition(":")
        if key.strip() in ("Model name", "Vendor ID"):
            return value.strip()
    return "unknown"


def facts() -> dict:
    return {"gpu": nvidia_smi(), "cpu": cpu_model(), "cpus": os.cpu_count(),
            "loadavg": list(os.getloadavg())}


def sample() -> dict:
    """A reading of the counters ``during`` compares: the host clock, this
    process's CPU seconds and involuntary context switches, and the
    machine's CPU seconds in all, idle and stolen (``/proc/stat``)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"wall": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime, "ivcsw": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
        hz = os.sysconf("SC_CLK_TCK")
        out.update(total=sum(v) / hz, idle=(v[3] + v[4]) / hz, steal=v[7] / hz)
    except (OSError, ValueError, IndexError):
        pass
    return out


class GcClock:
    """The garbage collector's passes by generation and its pauses, while
    installed (a context manager around the window)."""

    def __init__(self):
        self.passes, self.seconds, self._t = [0, 0, 0], 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.passes[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def during(a: dict, b: dict, gcc: GcClock) -> str:
    """One line on what the host did between readings ``a`` and ``b``."""
    wall = b["wall"] - a["wall"]
    parts = [f"process cpu {b['cpu'] - a['cpu']:.3f} s of {wall:.3f} s wall",
             f"involuntary context switches {b['ivcsw'] - a['ivcsw']}"]
    total = b.get("total", 0.0) - a.get("total", 0.0)
    if total > 0:
        parts.append(f"machine cpu stolen {100 * (b['steal'] - a['steal']) / total:.3f} %, "
                     f"idle {100 * (b['idle'] - a['idle']) / total:.2f} %")
    parts += [f"load {list(os.getloadavg())}",
              f"gc passes by generation {gcc.passes} pausing {gcc.seconds:.4f} s"]
    return "host during window: " + "; ".join(parts)
