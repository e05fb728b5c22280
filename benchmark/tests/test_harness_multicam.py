"""The two-camera cell ``multicam2-auto`` on the CPU at a small size: its
files found by name, its limits against the TF32 control and the float64
reference, a run's result and metrics, and runs with the timed path broken
underneath, which have to come out not correct.

The faults: the two cameras' tables swapped where they are packaged; the
Adam loop returning its state (s left at its first guess); the latent's Q
left without its normalisation (the optimizer's s then absorbs the
scale); the posterior variance columns without the ensemble variance that
upstream adds to them."""

from __future__ import annotations

import time

import pytest
import torch

import run
from harness import load_cell

ROOT = run.ROOT
CELL = "multicam2-auto"


def _cell(frames=240, keypoints=3, pool=2):
    cell = load_cell(CELL, ROOT)
    cell.cfg.update(frames=frames, keypoints=keypoints)
    cell.traffic["pool"] = min(cell.traffic["pool"], pool)
    return cell


def _run(cell, trace=False, seconds=0.5, seed=2**31 + 11):
    return run.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(), torch)


def test_the_cell_finds_its_files_by_name():
    from families import load
    from generators.sessions import GENERATORS, session_pool

    cell = load_cell(CELL, ROOT)
    assert cell.cfg["family"] == "multicam_linear" and cell.traffic["smooth_param"] is None
    assert (cell.cfg["cameras"], cell.cfg["n_latent"], cell.cfg["state_dim"], cell.cfg["obs_dim"]) == (2, 3, 3, 4)
    assert cell.kp_frames == 10 * 10_000 * 2
    assert set(cell.limits) == {"stats_gap", "mean_gap", "var_gap", "s_gap"}
    load(cell.cfg["family"])  # adds the configuration's recipe to the generators
    assert cell.cfg["generator"] in GENERATORS
    small = dict(cell.cfg, frames=50, keypoints=2)
    a, b = session_pool(2**40 + 3, small, 2), session_pool(2**40 + 3, small, 2)
    assert a[0].shape == (5, 2, 50, 2, 3) and a[0].dtype.name == "float32"
    assert (a[0] == b[0]).all() and not (a[0] == a[1]).all()
    assert "pca_ms" in {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("precision", ["tf32", "float64"])
def test_the_limits_refuse_the_tf32_control_and_pass_the_float64_reference(precision):
    from check import control_outputs, judge
    from families import load
    from generators.sessions import session_pool
    from reference.precision import FLOAT64, TF32

    cell = _cell()
    load(cell.cfg["family"])
    arrs = session_pool(2**31 + 5, cell.cfg, 1)
    p = TF32 if precision == "tf32" else FLOAT64
    nums = judge(cell.cfg, arrs, control_outputs(cell.cfg, arrs, None, p, "cpu"), True, "cpu")
    assert set(nums) == set(cell.limits)
    if precision == "tf32":
        assert any(v > cell.limits[k] for k, v in nums.items()), nums
    else:
        assert all(v < 1e-9 for v in nums.values()), nums


def test_a_small_run_is_correct_and_reports_its_metrics():
    cell = _cell()
    correct, attempted, failed, metrics, dev, checks, _ = _run(cell)
    assert correct and failed == 0 and attempted >= 1, checks
    assert set(metrics) == {m["name"] for m in cell.end_to_end}
    assert set(checks) == set(cell.limits)
    correct, _, _, metrics, _, checks, _ = _run(cell, trace=True)
    assert correct, checks
    # the device trace's metrics need the card; every span and counter metric is read
    assert set(metrics) == {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
    assert all(v["value"] > 0 for v in metrics.values())


# ---- faults ----------------------------------------------------------------
def _cameras_swapped(monkeypatch):
    import eks_tpu_torch.models.multicam as mc

    orig = mc._camera_blocks
    monkeypatch.setattr(mc, "_camera_blocks", lambda *a: orig(*a)[::-1])


def _adam_returns_its_state(monkeypatch):
    import eks_tpu_torch.core as core

    def unchanged(loss_and_grad, init, lr, tol, safety_cap, timings=None, scale_gradient=True):
        n = init.shape[0]
        if timings is not None:
            timings["adam_iters"] = 1
        return init, torch.zeros(n, dtype=init.dtype), torch.ones(n, dtype=torch.int32)

    monkeypatch.setattr(core, "_joint_masked_adam", unchanged)


def _q_not_normalised(monkeypatch):
    import eks_tpu_torch.models.multicam as mc

    orig = mc._prep_multicam_linear

    def prep(*a, **kw):
        out = list(orig(*a, **kw))
        out[6] = out[6] * 4.0  # Qs
        return tuple(out)

    monkeypatch.setattr(mc, "_prep_multicam_linear", prep)


def _posterior_without_ensemble_variance(monkeypatch):
    import eks_tpu_torch.models.multicam as mc

    orig = mc._package_multicam_smoothed
    monkeypatch.setattr(mc, "_package_multicam_smoothed",
                        lambda means, Cs, ms, Vs, evars: orig(means, Cs, ms, Vs, torch.zeros_like(evars)))


FAULTS = {
    "cameras_swapped": (_cameras_swapped, "mean_gap"),
    "adam_returns_its_state": (_adam_returns_its_state, "s_gap"),
    "q_not_normalised": (_q_not_normalised, "s_gap"),
    "posterior_without_ensemble_variance": (_posterior_without_ensemble_variance, "var_gap"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    plant, number = FAULTS[fault]
    cell = _cell(pool=1)
    plant(monkeypatch)
    correct, _, _, _, _, checks, _ = _run(cell, seconds=0.1)
    assert not correct
    assert checks[number]["value"] > checks[number]["limit"], checks
