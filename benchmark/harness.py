"""The parts of a run that every cell shares: finding a cell's files by
name, the closed loop of jobs, the end-to-end arithmetic and the result
line."""

from __future__ import annotations

import importlib
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "eks_tpu")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what its names point to."""
    name: str
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int

    @property
    def kp_frames(self) -> int:
        """Keypoints × frames × cameras one job smooths and returns."""
        return self.cfg["keypoints"] * self.cfg["frames"] * self.cfg["cameras"]

    @property
    def sizes(self) -> dict:
        c = self.cfg
        return {"lanes": c["keypoints"], "frames": c["frames"], "state_dim": c["state_dim"],
                "obs_dim": c["obs_dim"], "cameras": c["cameras"]}


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name``: its configuration file (``configs`` entry),
    traffic file (``traffic/<mix>.json``), limits (``checks/<cell>.json``)
    and the metrics that list it, all found by name."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = root / "benchmark"
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "checks" / f"{name}.json").read_text())["limits"]
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in e2e_names else [])]
    return Cell(name, cfg, traffic, limits, e2e, per_layer, int(w["chips"]))


@dataclass
class Window:
    """The measured jobs of a run: each ``{"t0", "t1", "wall", ...}``."""
    jobs: list = field(default_factory=list)
    failed: int = 0

    @property
    def seconds(self) -> float:
        return self.jobs[-1]["t1"] - self.jobs[0]["t0"] if self.jobs else 0.0


def closed_loop(run_job, seconds: float, first: int = 0) -> Window:
    """One caller that waits for each result: job ``i`` runs as
    ``run_job(i)`` (returning the job's record), the first at once and each
    next one only if the longest job so far would still end within
    ``seconds`` of the first job's start. A job that raises counts as
    failed and its traceback goes to standard error. Each record gets the
    job's host times, its process CPU seconds and its collector pauses;
    what the host did over the window goes to standard error."""
    import traceback

    from hostinfo import GcClock, during, sample

    win, longest, i = Window(), 0.0, first
    before = sample()
    with GcClock() as gcc:
        while True:
            t0, c0, g0 = time.perf_counter(), time.process_time(), gcc.seconds
            if win.jobs and (t0 - win.jobs[0]["t0"]) + longest > seconds:
                break
            try:
                rec = run_job(i)
            except Exception:  # a failed job is counted, and the loop goes on
                traceback.print_exc()
                win.failed += 1
                rec = {"failed": True}
            t1 = time.perf_counter()
            rec.update(t0=t0, t1=t1, wall=t1 - t0, cpu=time.process_time() - c0, gc_s=gcc.seconds - g0,
                       index=i)
            win.jobs.append(rec)
            longest = max(longest, t1 - t0)
            i += 1
    print(during(before, sample(), gcc), file=sys.stderr)
    return win


def p90(values: list) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def spread(values: list) -> list:
    """[min, first quartile, median, third quartile, max]."""
    if len(values) < 2:
        return list(values) * 5
    return [min(values), *statistics.quantiles(values, n=4, method="inclusive"), max(values)]


def correlation(xs, ys) -> float:
    """Pearson's r, NaN where either side does not vary."""
    try:
        return statistics.correlation(xs, ys)
    except statistics.StatisticsError:
        return math.nan


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are in ``FORBIDDEN``,
    compared whole (``eks_tpu_torch`` is not ``eks_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer_metrics(cell: Cell, rec: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = importlib.import_module(f"metrics.{m['name']}").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number against its limit: (all within, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def report(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
           checks: dict, breakdown: dict | None = None) -> None:
    """Each number compared beside its limit as the last lines of standard
    error, then the one-line result as the last line of standard output."""
    checks = {k: {"value": v["value"] if math.isfinite(v["value"]) else str(v["value"]), "limit": v["limit"]}
              for k, v in checks.items()}
    for k, c in checks.items():
        print(f"check {k} = {c['value']!s} limit {c['limit']!r}", file=sys.stderr)
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
