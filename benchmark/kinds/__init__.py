"""One module per kind of job, found by the ``kind`` key of a traffic file.
``run(ctx)`` sets up, measures the window and, in a traced run, the
profiled segment, and returns a ``kinds.Result``."""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from harness import Window


@dataclass
class Context:
    """What a run was asked for: the cell, the seed, the window's length,
    whether it is traced, the device the program runs on (``cuda``; the
    CPU only in the benchmark's own tests) and the process start."""
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float
    torch: object


@dataclass
class Result:
    setup_s: float
    window: Window
    arrs: list  # the sessions judged
    outputs: list  # the program's outputs on them
    memory_peak_bytes: int
    segment: dict | None = None  # the profiled segment of a traced run


def load(name: str):
    return importlib.import_module(f"kinds.{name}")
