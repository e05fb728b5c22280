"""A run's plumbing on the CPU at a small size: the closed loop, the check,
the metrics and the result line, with the look for a card skipped; and a
run with the timed path broken underneath, which has to come out not
correct.

The faults: a step that returns its state unchanged (the optimizer's
Adam loop, which leaves s at its first guess; the final pass, which leaves
every frame at the prior); half of the ensemble left out, the statistics
taken over the rest; an answer altered where it is produced (one smoothed
x moved by one pixel in the packaging). No cell spans chips, so no
exchange between chips can be left out."""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

import run
from harness import load_cell

ROOT = run.ROOT


def _cell(name, frames=240, keypoints=3, pool=2):
    cell = load_cell(name, ROOT)
    cell.cfg.update(frames=frames, keypoints=keypoints)
    cell.traffic["pool"] = min(cell.traffic["pool"], pool)
    return cell


def _run(cell, trace=False, seconds=0.5, seed=2**31 + 11):
    return run.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(), torch)


@pytest.mark.parametrize("name", ["singlecam-auto", "singlecam-fixed-s"])
def test_a_small_run_is_correct_and_reports_its_metrics(name, capsys):
    cell = _cell(name)
    correct, attempted, failed, metrics, dev, checks, breakdown = _run(cell)
    assert correct and failed == 0 and attempted >= 1, checks
    assert set(metrics) == {m["name"] for m in cell.end_to_end}
    assert set(checks) == set(cell.limits)
    correct, _, _, metrics, _, checks, _ = _run(cell, trace=True)
    assert correct, checks
    timed = {"prep_ms", "package_ms", "final_pass_ms", "adam_iter_ms", "adam_iters_per_job"}
    assert set(metrics) == {m["name"] for m in cell.per_layer} & timed
    assert all(v["value"] > 0 for v in metrics.values())


def test_the_result_line_is_last_and_checks_come_last_in_it(capsys):
    from harness import report

    report(True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}}, {"platform": "gpu"},
           {"mean_gap": {"value": 0.1, "limit": 0.2}, "s_nll_excess": {"value": float("inf"), "limit": 9.0}},
           {"device_ops": [], "idle_gaps": []})
    out, err = capsys.readouterr()
    line = json.loads(out.splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert line["checks"]["s_nll_excess"]["value"] == "inf"
    assert err.splitlines()[-1] == "check s_nll_excess = inf limit 9.0"


# ---- faults ----------------------------------------------------------------
def _adam_returns_its_state(monkeypatch):
    import eks_tpu_torch.core as core

    def unchanged(loss_and_grad, init, lr, tol, safety_cap, timings=None, scale_gradient=True):
        n = init.shape[0]
        if timings is not None:
            timings["adam_iters"] = 1
        return init, torch.zeros(n, dtype=init.dtype), torch.ones(n, dtype=torch.int32)

    monkeypatch.setattr(core, "_joint_masked_adam", unchanged)


def _final_pass_returns_its_state(monkeypatch):
    import eks_tpu_torch.core as core

    def unchanged(ys, m0s, S0s, As, Qs, Cs, s_finals, rs, **kw):
        T = ys.shape[1]
        return m0s[:, None].expand(-1, T, -1), S0s[:, None].expand(-1, T, -1, -1)

    monkeypatch.setattr(core, "_smooth_all", unchanged)


def _half_the_members(monkeypatch):
    import eks_tpu_torch.models.singlecam as sc

    orig = sc._ensemble_kernel

    def half(x, y, lh, n_models, *rest):
        h = max(2, n_models // 2)
        return orig(x[:h], y[:h], lh[:h], h, *rest)

    monkeypatch.setattr(sc, "_ensemble_kernel", half)


def _one_answer_altered(monkeypatch):
    import eks_tpu_torch.models.singlecam as sc

    def moved(orig):
        def package(*args):
            table = orig(*args).clone()
            table[..., table.shape[-3] // 2, 0, 0] += 1.0  # frame T/2, keypoint 0, x
            return table
        return package

    monkeypatch.setattr(sc, "_package_singlecam_full", moved(sc._package_singlecam_full))


FAULTS = {
    "adam_returns_its_state": (_adam_returns_its_state, "s_gap"),
    "final_pass_returns_its_state": (_final_pass_returns_its_state, "mean_gap"),
    "half_the_members": (_half_the_members, "stats_gap"),
    "one_answer_altered": (_one_answer_altered, "mean_gap"),
}
IN_PROCESS = ["singlecam-auto", "singlecam-fixed-s"]
CASES = [(cell, fault) for cell in IN_PROCESS for fault in FAULTS
         if not (fault == "adam_returns_its_state" and cell == "singlecam-fixed-s")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    plant, number = FAULTS[fault]
    cell = _cell(name)
    cell.traffic["pool"] = 1
    plant(monkeypatch)
    correct, _, _, _, _, checks, _ = _run(cell, seconds=0.1)
    assert not correct
    assert checks[number]["value"] > checks[number]["limit"], checks


# ---- runs that must print no result ------------------------------------------
def _run_py(cwd, *extra):
    import subprocess
    import sys

    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "singlecam-auto", "--seed", "1",
                           "--seconds", "1", "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_a_card(card_absent):
    done = _run_py(ROOT)
    assert done.returncode != 0 and done.stdout == ""


def test_no_result_in_a_directory_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    done = _run_py(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
