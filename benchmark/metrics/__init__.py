"""One module per per-layer metric, found by the metric's name in
``BENCHMARK.json``. Each has ``read(rec) -> float | None``: it takes the
metric from the traced run's record and returns None where it finds
nothing to read, and the harness then leaves the metric out of the line.

The record: ``rec["jobs"]``, the measured window's jobs (``wall``, and the
entry point's ``timings``);
``rec["trace"]``, the profiled segment (``events`` on the device,
``jobs``, ``window_s``), where the cell has one; ``rec["cell"]``, the
configuration's sizes.
"""

from __future__ import annotations


def stage_mean_ms(rec: dict, stage: str) -> float | None:
    vals = [j["timings"][stage] for j in rec["jobs"] if stage in (j.get("timings") or {})]
    return 1e3 * sum(vals) / len(vals) if vals else None
