"""One recorder of spans and counters for the port.

Spans. An entry point given a ``timings`` dict records, besides each
stage's seconds under its key ("read", "prep", "optimizer", "final_pass",
"package", "write"), two more keys:

* ``timings["spans"]``: a list (``Spans``) of ``[name, t0, t1, parent]``
  in the order the spans began. ``t0`` and ``t1`` are ``time.perf_counter`` seconds, the
  host clock a device trace is mapped onto; ``parent`` is the index of the
  span that enclosed it in the same list, or -1. A stage's seconds are its
  span's duration. Beside the stages: "table", the pandas build of the
  output tables, and in every iteration of the Adam loop (under
  "optimizer") "adam.stop_test" (the loop-top read of which lanes are
  still active, the iteration's one wait for the device), "adam.loss" (the
  loss and its gradient) and "adam.update" (the s-optimizer's block sums,
  Adam's update, the stop rule and the masked carries).
* ``timings["counts"]``: this call's kernel launches by instance (the
  registry's keys), those that changed.

Nothing else switches spans on: without a dict a span site costs one
``is None`` test, and the Adam loop reads no clock and appends nothing.

Launch counters. ``LAUNCHES`` counts every kernel launch of the process,
always, by kernel and instance: ``("A", D, O, paired)`` (kernel A),
``("table", D, O)`` (the s-optimizer's table kernel, one launch an Adam
iteration at kernel A's shapes), ``("adam_step", b_max)`` (the
s-optimizer's Adam step kernel, one launch an Adam iteration on the card),
``("C", paired)`` (kernel C),
``("scan", kind, paired, D)`` (kernels B and D), ``("scan_carried", kind,
paired, D)`` (a carried downsweep, also counted as a scan), and
``("scan_plain_route", kind)`` and
``("scan_carried_plain_route", kind)`` (scans and carry combines of CUDA
tensors beyond D = 3, which the plain version runs). Beside the kernels, the
output path (``utils/io.py``): ``("output_pull",)`` (one device-to-host copy
of an entry point's results), ``("frame", "wrapped")`` (one output table
wrapped around that copy) and ``("frame", "index_built")`` (one build of a
table's column index, which is cached). ``launches`` sums it over a
pattern.

The process record. Filled once per process, traced or not: the package's
import, each kernel library's first load (with its ``nvcc`` build as a
child where it ran one), and the process's first entry-point call with
the process's first "adam.loss" as a child. ``process()`` returns it.
"""

from __future__ import annotations

import functools
import inspect
import threading
import time
from collections import Counter

__all__ = [
    "LAUNCHES",
    "Spans",
    "begin",
    "count",
    "end",
    "entry_point",
    "launches",
    "process",
    "reset_launches",
    "since",
    "snapshot",
    "spans",
    "sync",
]


class Spans(list):
    """``[name, t0, t1, parent]`` entries in the order they began or, for
    a span measured elsewhere, were added (``t1`` is None while the span is
    open), with ``open``, the indices of the spans not closed yet: a new
    span's parent is the last of them."""

    __slots__ = ("open",)

    def __init__(self, items=()):
        super().__init__(items)
        self.open = []

    def begin(self, name: str) -> int:
        i = len(self)
        self.append([name, time.perf_counter(), None, self.open[-1] if self.open else -1])
        self.open.append(i)
        return i

    def end(self, i: int) -> float:
        """Close span ``i``; returns its seconds."""
        span = self[i]
        span[2] = time.perf_counter()
        self.open.remove(i)
        return span[2] - span[1]

    def add(self, name: str, t0: float, t1: float) -> int:
        """A span measured elsewhere, in the innermost open span."""
        self.append([name, t0, t1, self.open[-1] if self.open else -1])
        return len(self) - 1


def spans(timings: dict | None) -> Spans | None:
    """The spans of ``timings`` (made on first use), or None without a dict."""
    if timings is None:
        return None
    sp = timings.get("spans")
    if not isinstance(sp, Spans):
        sp = timings["spans"] = Spans(sp or ())
    return sp


def sync(*devices) -> None:
    """Wait for every CUDA device among ``devices``."""
    import torch

    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def begin(timings: dict | None, name: str) -> int | None:
    """Open the span ``name`` in ``timings``; None without a dict."""
    return None if timings is None else spans(timings).begin(name)


def end(timings: dict | None, i: int | None, *devices, stage: bool = False) -> None:
    """Close span ``i`` of ``timings`` once the CUDA devices among
    ``devices`` are done; with ``stage`` its seconds also go under its name.
    Nothing when ``i`` is None."""
    if i is None:
        return
    sync(*devices)
    sp = timings["spans"]
    seconds = sp.end(i)
    if stage:
        timings[sp[i][0]] = seconds


# --------------------------------------------------------------------------- #
# launch counters
# --------------------------------------------------------------------------- #
#: kernel launches of the process (or since ``reset_launches``), by kernel
#: and instance; a caller's threads may launch at once, so ``_LOCK`` guards it
LAUNCHES: Counter = Counter()
_LOCK = threading.Lock()


def count(key: tuple) -> None:
    """One launch of the instance ``key``."""
    with _LOCK:
        LAUNCHES[key] += 1


def snapshot() -> dict:
    with _LOCK:
        return dict(LAUNCHES)


def reset_launches() -> None:
    with _LOCK:
        LAUNCHES.clear()


def launches(*pattern) -> int:
    """Launches of every key that starts with ``pattern``, None matching
    anything: ``launches("A")``, ``launches("A", None, None, True)`` (kernel
    A paired), ``launches("scan", "filter", False, 3)``."""
    n = len(pattern)
    return sum(v for k, v in snapshot().items()
               if all(p is None or p == x for p, x in zip(pattern, k[:n])))


def since(before: dict) -> dict:
    """The launches since ``before`` (a ``snapshot``), of the keys that moved."""
    return {k: v - before.get(k, 0) for k, v in snapshot().items() if v != before.get(k, 0)}


# --------------------------------------------------------------------------- #
# the process record
# --------------------------------------------------------------------------- #
_PROCESS = Spans()
_PLOCK = threading.Lock()
#: whether an entry-point call has begun in this process
_called = False
#: whether the process's first Adam iteration is still to come
_loss_pending = True


def process() -> dict:
    """The process record: ``"spans"``, its spans as ``timings["spans"]``
    has them, and the seconds of the first closed span of each name:
    "import" (the package's import, from the top of
    ``eks_tpu_torch/__init__.py`` to its end), "kernel_load.<lib>" (a
    library's first load), "kernel_build.<lib>" (its ``nvcc`` build, where
    one ran), "first_call" (the process's first entry-point call) and
    "adam.loss" (the process's first loss of the Adam loop)."""
    with _PLOCK:
        record = [list(s) for s in _PROCESS]
    out = {}
    for name, t0, t1, _ in record:
        if t1 is not None:
            out.setdefault(name, t1 - t0)
    out["spans"] = record
    return out


def imported(started: float) -> None:
    """The package's import, from ``started`` to now."""
    with _PLOCK:
        _PROCESS.add("import", started, time.perf_counter())


def process_begin(name: str) -> int:
    with _PLOCK:
        return _PROCESS.begin(name)


def process_end(i: int) -> None:
    with _PLOCK:
        _PROCESS.end(i)


def process_add(name: str, t0: float, t1: float) -> None:
    with _PLOCK:
        _PROCESS.add(name, t0, t1)


def adam_spans(timings: dict | None) -> Spans | None:
    """Where the Adam loop records: the spans of ``timings``; without a dict
    a list of its own while the process's first loss is still to come
    (``first_loss`` takes that loss from it), else None."""
    if timings is not None:
        return spans(timings)
    return Spans() if _loss_pending else None


def first_loss(sp: Spans) -> None:
    """Give the process record the first "adam.loss" of ``sp``, once."""
    global _loss_pending
    if not _loss_pending:
        return
    loss = next((s for s in sp if s[0] == "adam.loss" and s[2] is not None), None)
    with _PLOCK:
        if loss is not None and _loss_pending:
            _loss_pending = False
            _PROCESS.add("adam.loss", loss[1], loss[2])


def entry_point(fn):
    """Mark ``fn`` as an entry point of the port. The process's first call
    of one is recorded ("first_call"); a call given a ``timings`` dict gets
    its launch counts there ("counts", those of every thread while it ran).
    Calls nested in another entry point's record again, the outermost
    last."""
    params = list(inspect.signature(fn).parameters)
    at = params.index("timings") if "timings" in params else None

    @functools.wraps(fn)
    def call(*args, **kwargs):
        timings = kwargs.get("timings") if at is None or len(args) <= at else args[at]
        if timings is None and _called:
            return fn(*args, **kwargs)
        return _recorded(fn, args, kwargs, timings)

    return call


def _recorded(fn, args, kwargs, timings):
    global _called
    first = None
    with _PLOCK:
        if not _called:
            _called = True
            first = _PROCESS.begin("first_call")
    before = None if timings is None else snapshot()
    try:
        return fn(*args, **kwargs)
    finally:
        if before is not None:
            timings["counts"] = since(before)
        if first is not None:
            process_end(first)
