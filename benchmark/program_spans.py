"""The program's spans in a traced run's records: an entry point given a
``timings`` dict leaves ``timings["spans"]``, ``[name, t0, t1, parent]``
on the host clock the device trace is mapped onto (``eks_tpu_torch/
tracing.py``). A program without them leaves none, and every function
here then finds nothing."""

from __future__ import annotations


def spans(job: dict) -> list:
    return (job.get("timings") or {}).get("spans") or []


def seconds(job: dict, name: str) -> list[float]:
    """The seconds of each span ``name`` of one job."""
    return [t1 - t0 for n, t0, t1, _ in spans(job) if n == name]


def per_iteration_ms(rec: dict, name: str) -> float | None:
    """Milliseconds of the spans ``name`` over the Adam iterations, summed
    over the measured window's jobs that have both."""
    total, iters = 0.0, 0
    for job in rec["jobs"]:
        found = seconds(job, name)
        n = (job.get("timings") or {}).get("adam_iters", 0)
        if found and n:
            total += sum(found)
            iters += n
    return 1e3 * total / iters if iters else None


def process_seconds(name: str) -> float | None:
    """Seconds of the process record's span ``name`` (``tracing.process()``),
    read from the program this process loaded; None where it has none."""
    try:
        from eks_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.process().get(name)
