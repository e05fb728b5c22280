"""The metrics that read the program's spans (``program_spans.py``), each
fed a synthetic record: the value it reads, and None where the record (or
the program) has nothing for it, as a program without spans leaves."""

from __future__ import annotations

import importlib
import sys

import pytest


def _job(iters, spans, **timings):
    return {"timings": dict(timings, adam_iters=iters, spans=spans) if iters is not None else dict(timings)}


def _iteration(t, loss, update, stop):
    """One Adam iteration's spans from ``t``, under the optimizer (index 1)."""
    return [["adam.stop_test", t, t + stop, 1], ["adam.loss", t + stop, t + stop + loss, 1],
            ["adam.update", t + stop + loss, t + stop + loss + update, 1]]


def _tuned_job(t, iters, loss=0.008, update=0.0003, stop=0.0002):
    spans = [["prep", t, t + 0.005, -1], ["optimizer", t + 0.005, t + 1.0, -1]]
    for k in range(iters):
        spans += _iteration(t + 0.01 + 0.01 * k, loss, update, stop)
    spans += [["adam.stop_test", t + 0.99, t + 0.99 + stop, 1], ["final_pass", t + 1.0, t + 1.006, -1],
              ["package", t + 1.006, t + 1.007, -1], ["table", t + 1.007, t + 1.014, -1]]
    return _job(iters, spans)


def _metric(name):
    return importlib.import_module(f"metrics.{name}").read


def test_the_adam_spans_read_per_iteration():
    rec = {"jobs": [_tuned_job(0.0, 3), _tuned_job(2.0, 5), {"timings": None}]}
    # loss: 8 iterations of 8 ms; update and stop over the same 8 iterations
    assert _metric("adam_loss_host_ms")(rec) == pytest.approx(8.0)
    assert _metric("adam_update_host_ms")(rec) == pytest.approx(0.3)
    # the stop test runs once more than the iterations in each job: 10 tests of 0.2 ms over 8
    assert _metric("adam_stop_wait_ms")(rec) == pytest.approx(0.25)
    assert _metric("table_ms")(rec) == pytest.approx(7.0)


@pytest.mark.parametrize("name", ["adam_loss_host_ms", "adam_update_host_ms", "adam_stop_wait_ms", "table_ms"])
def test_a_record_without_spans_reads_nothing(name):
    # the parent program: stage seconds and iterations, no spans
    parent = {"jobs": [{"timings": {"prep": 0.005, "optimizer": 0.7, "adam_iters": 88}}, {"timings": None}]}
    assert _metric(name)(parent) is None
    assert _metric(name)({"jobs": []}) is None
    # a fixed-s job has a table but no Adam iteration
    fixed = {"jobs": [_job(0, [["optimizer", 0.0, 0.001, -1], ["table", 0.01, 0.017, -1]])]}
    assert _metric(name)(fixed) == (pytest.approx(7.0) if name == "table_ms" else None)


def test_device_ops_per_iteration_count_the_events_inside_the_optimizer():
    jobs = [_tuned_job(0.0, 2), _tuned_job(2.0, 3)]
    events = [("k", t, 1e-5) for t in (0.001, 0.2, 0.3, 0.5, 0.99, 1.003, 2.004, 2.5, 2.6, 3.2)]
    rec = {"jobs": [], "trace": {"events": events, "jobs": jobs, "window_s": 4.0}}
    # inside job 0's optimizer [0.005, 1.0]: 4 events; job 1's [2.005, 3.0]: 2; over 5 iterations
    assert _metric("adam_device_ops_per_iter")(rec) == pytest.approx(6 / 5)
    assert _metric("adam_device_ops_per_iter")({"jobs": [], "trace": None}) is None
    parent = {"jobs": [], "trace": {"events": events, "jobs": [{"timings": {"adam_iters": 3}}], "window_s": 4.0}}
    assert _metric("adam_device_ops_per_iter")(parent) is None


def test_the_set_up_metrics_read_the_process_record(monkeypatch):
    from eks_tpu_torch import tracing

    fake = {"import": 3.5, "first_call": 14.25, "spans": []}
    monkeypatch.setattr(tracing, "process", lambda: fake)
    assert _metric("setup_import_s")({"jobs": []}) == 3.5
    assert _metric("setup_first_job_s")({"jobs": []}) == 14.25
    fake.pop("first_call")  # no entry-point call yet
    assert _metric("setup_first_job_s")({"jobs": []}) is None


def test_the_set_up_metrics_read_nothing_from_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "eks_tpu_torch.tracing", None)  # its import now raises ImportError
    import eks_tpu_torch

    monkeypatch.delattr(eks_tpu_torch, "tracing", raising=False)
    assert _metric("setup_import_s")({"jobs": []}) is None
    assert _metric("setup_first_job_s")({"jobs": []}) is None


def test_importing_the_metric_files_loads_no_program():
    import subprocess

    code = ("import sys; sys.path[:0] = ['benchmark']; import importlib\n"
            "for n in ('setup_import_s', 'setup_first_job_s', 'table_ms', 'adam_loss_host_ms',"
            " 'adam_device_ops_per_iter'):\n"
            "    importlib.import_module('metrics.' + n)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'eks_tpu_torch'], 'loaded'\n")
    from pathlib import Path

    done = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[2],
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
