"""The port's recorder (``eks_tpu_torch/tracing.py``): the spans an entry
point given a ``timings`` dict records (its stages, the pandas table, and
each Adam iteration's stop test, loss and update under the optimizer),
their nesting and order, the stage seconds they carry, the untraced Adam
loop's cost (no clock, no sync, no record), the process record, and the
launch registry.

The CPU tests run the plain versions of the kernels at small sizes. The
tests marked ``cuda`` launch the kernels and skip without a card; on the
card (where JAX is not installed, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import types

import numpy as np
import pandas as pd
import pytest
import torch

import eks_tpu_torch
from eks_tpu_torch import core, tracing
from eks_tpu_torch.marker_array import MarkerArray
from eks_tpu_torch.models import ibl_pupil
from eks_tpu_torch.ops.adam_step import MemberNLL
from eks_tpu_torch.utils import make_dlc_pandas_index

STAGES = ["prep", "optimizer", "final_pass", "package", "table"]
ADAM = ("adam.stop_test", "adam.loss", "adam.update")


def _singlecam_array(rng, M=5, T=200, K=3):
    arr = np.cumsum(rng.normal(size=(1, 1, T, K, 2)), axis=2) + rng.normal(size=(M, 1, T, K, 2)) * 0.5
    lh = rng.uniform(0.5, 1.0, size=(M, 1, T, K, 1))
    return MarkerArray(np.concatenate([arr, lh], axis=-1).astype(np.float32),
                       data_fields=["x", "y", "likelihood"])


def _pupil_array(rng, M=4, T=60):
    """Four pupil keypoints on a circle of diameter 10 around (60, 40)."""
    offsets = {"pupil_top_r": (0.0, -5.0), "pupil_bottom_r": (0.0, 5.0),
               "pupil_right_r": (5.0, 0.0), "pupil_left_r": (-5.0, 0.0)}
    arr = np.zeros((M, 1, T, 4, 3))
    for k, name in enumerate(ibl_pupil.BODYPART_LIST):
        track = np.array([60.0, 40.0]) + offsets[name] + rng.normal(size=(T, 2)) * 0.1
        arr[:, 0, :, k, :2] = track + rng.normal(size=(M, T, 2)) * 0.2
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(M, 1, T, 4))
    return MarkerArray(arr, data_fields=["x", "y", "likelihood"])


def _multicam_array(rng, M=4, C=2, T=120, K=3):
    base = np.cumsum(rng.normal(size=(1, 1, T, K, 2)), axis=2)
    arr = np.repeat(base, C, axis=1) + rng.normal(size=(M, C, T, K, 2)) * 0.3
    lh = rng.uniform(0.5, 1.0, size=(M, C, T, K, 1))
    return MarkerArray(np.concatenate([arr, lh], axis=-1), data_fields=["x", "y", "likelihood"])


def _run(family):
    """One entry-point call of ``family`` on the CPU with a ``timings`` dict."""
    rng = np.random.default_rng(3)
    timings = {}
    if family == "singlecam":
        eks_tpu_torch.ensemble_kalman_smoother_singlecam(
            _singlecam_array(rng), ["a", "b", "c"], device="cpu", timings=timings)
    elif family == "pupil":
        eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
            _pupil_array(rng), ibl_pupil.BODYPART_LIST, safety_cap=3, device="cpu", timings=timings)
    else:  # the multi-camera family with s given, through the fused and the general route
        eks_tpu_torch.ensemble_kalman_smoother_multicam(
            _multicam_array(rng), ["a", "b", "c"], ["l", "r"], smooth_param=2.0, n_latent=2,
            s_frames=[(0, 100)] if family == "multicam-general" else None, device="cpu", timings=timings)
    return timings


@pytest.fixture(scope="module")
def traced():
    cache = {}

    def get(family):
        if family not in cache:
            cache[family] = _run(family)
        return cache[family]

    return get


@pytest.mark.parametrize("family", ["singlecam", "pupil"])
def test_adam_spans_cover_each_iteration_under_the_optimizer(traced, family):
    timings = traced(family)
    spans = timings["spans"]
    n = timings["adam_iters"]
    assert n > 0
    (opt,) = [i for i, s in enumerate(spans) if s[0] == "optimizer"]
    adam = [s for s in spans if s[0] in ADAM]
    assert [s[0] for s in adam].count("adam.loss") == n
    assert [s[0] for s in adam].count("adam.update") == n
    assert [s[0] for s in adam].count("adam.stop_test") == n + 1
    # in order: each iteration's stop test, loss and update, then the last stop test
    assert [s[0] for s in adam] == list(ADAM) * n + ["adam.stop_test"]
    assert all(s[3] == opt for s in adam)
    o0, o1 = spans[opt][1], spans[opt][2]
    assert all(o0 <= s[1] <= s[2] <= o1 for s in adam)
    assert all(a[2] <= b[1] for a, b in zip(adam, adam[1:]))  # no two overlap


@pytest.mark.parametrize("family", ["singlecam", "pupil", "multicam-fused", "multicam-general"])
def test_stage_and_table_spans_once_a_call_in_order(traced, family):
    spans = traced(family)["spans"]
    top = [s for s in spans if s[3] == -1]
    assert [s[0] for s in top] == STAGES
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    assert all(s[1] <= s[2] for s in spans)
    for name, t0, t1, parent in spans:  # every span lies inside its parent
        if parent >= 0:
            assert spans[parent][1] <= t0 <= t1 <= spans[parent][2]
    assert not spans.open


@pytest.mark.parametrize("family", ["singlecam", "pupil", "multicam-fused", "multicam-general"])
def test_stage_seconds_are_their_spans(traced, family):
    timings = traced(family)
    for name, t0, t1, _ in timings["spans"]:
        if name in STAGES and name != "table":
            assert timings[name] == t1 - t0
    assert "table" not in timings  # a span only
    counts = dict(timings["counts"])
    # the output path's counters: one pull of the results, a table wrapped
    # around it per output (an index built where not cached)
    assert counts.pop(("output_pull",)) == 1
    assert counts.pop(("frame", "wrapped")) == (1 if family in ("singlecam", "pupil") else 3)
    counts.pop(("frame", "index_built"), None)
    assert counts == {}  # the CPU launches no kernel


def test_sessions_and_file_entry_points_record_read_write_and_tables(tmp_path):
    rng = np.random.default_rng(5)
    timings = {}
    arrays = [_singlecam_array(rng, T=120), _singlecam_array(rng, T=120)]
    out = eks_tpu_torch.ensemble_kalman_smoother_singlecam_sessions(
        arrays, [["a", "b", "c"]] * 2, smooth_param=1.0, device="cpu", timings=timings)
    assert len(out) == 2
    assert [s[0] for s in timings["spans"] if s[3] == -1] == STAGES  # one batched run, one table span
    src = tmp_path / "in"
    src.mkdir()
    for m in range(2):  # two members, each a DLC-style CSV
        a = arrays[0].array[m, 0]  # (T, K, 3)
        df = pd.DataFrame(a.reshape(a.shape[0], -1), columns=make_dlc_pandas_index(
            ["a", "b", "c"], labels=["x", "y", "likelihood"]))
        df.to_csv(src / f"m{m}.csv")
    timings = {}
    eks_tpu_torch.fit_eks_singlecam(str(src), str(tmp_path / "out.csv"), smooth_param=1.0, device="cpu",
                                    timings=timings)
    assert [s[0] for s in timings["spans"] if s[3] == -1] == ["read"] + STAGES + ["write"]
    assert timings["read"] > 0 and timings["write"] > 0


def _quadratic(target):
    """The s-optimizer's loss as its Adam step takes it, one member a block:
    log-likelihood -(s - target)^2 and its derivative."""
    def member_lls(s):
        d = s - target
        return -(d * d), -2 * d
    return MemberNLL(member_lls, torch.ones_like(target), 1)


def test_untraced_adam_loop_reads_no_clock_syncs_nothing_and_records_nothing(monkeypatch):
    init = torch.zeros(4)
    target = torch.linspace(-1.0, 1.0, 4)
    # the process's first loss, recorded once whether or not tracing is on
    core._joint_masked_adam(_quadratic(target), init, 0.1, 1e-3, 20)
    assert not tracing._loss_pending and "adam.loss" in tracing.process()
    record = len(tracing.process()["spans"])

    calls = {"clock": 0, "sync": 0}
    clock = tracing.time.perf_counter

    def counting_clock():
        calls["clock"] += 1
        return clock()

    def counting_sync(*args, **kwargs):
        calls["sync"] += 1

    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter=counting_clock))
    monkeypatch.setattr(torch.cuda, "synchronize", counting_sync)
    made = []
    monkeypatch.setattr(tracing, "Spans", lambda *a: made.append(a) or list())
    s, _, iters = core._joint_masked_adam(_quadratic(target), init, 0.1, 1e-3, 20)
    assert int(iters.max()) > 1
    assert calls == {"clock": 0, "sync": 0}
    assert made == [] and len(tracing.process()["spans"]) == record
    # traced, the same loop reads the clock twice a span: the counting works
    monkeypatch.undo()
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter=counting_clock))
    timings = {}
    core._joint_masked_adam(_quadratic(target), init, 0.1, 1e-3, 20, timings=timings)
    assert calls["clock"] == 2 * len(timings["spans"]) and calls["sync"] == 0
    assert timings["adam_iters"] == int(iters.max())


def test_the_process_record_holds_the_import_and_the_first_call(traced):
    traced("singlecam")  # an entry-point call has run in this process
    rec = tracing.process()
    assert rec["import"] > 0 and rec["first_call"] > 0
    names = [s[0] for s in rec["spans"]]
    assert names.count("import") == 1 and names.count("first_call") == 1
    first = names.index("first_call")
    for name, t0, t1, parent in rec["spans"]:
        if name == "adam.loss":  # the process's first loss, inside the first call if it ran there
            assert parent in (-1, first) and t0 <= t1


def test_entry_points_give_their_own_launch_counts_and_the_outermost_wins():
    @tracing.entry_point
    def inner(n, timings=None):
        for _ in range(n):
            tracing.count(("test", "inner"))

    @tracing.entry_point
    def outer(timings=None):
        inner(2, timings=timings)
        assert timings["counts"] == {("test", "inner"): 2}
        tracing.count(("test", "outer"))

    timings = {}
    outer(timings)
    assert timings["counts"] == {("test", "inner"): 2, ("test", "outer"): 1}
    inner(1, None)  # no dict, nothing recorded
    assert tracing.launches("test") >= 4


def test_launches_sum_over_a_pattern():
    before = tracing.snapshot()
    for key in [("A", 2, 2, True), ("A", 2, 2, True), ("A", 3, 4, True), ("A", 2, 2, False), ("C", True)]:
        tracing.count(key)
    assert tracing.since(before) == {("A", 2, 2, True): 2, ("A", 3, 4, True): 1, ("A", 2, 2, False): 1,
                                     ("C", True): 1}
    moved = tracing.since(before)
    assert sum(v for k, v in moved.items() if k[0] == "A") == 4
    after = tracing.snapshot()
    assert tracing.launches("A", None, None, True) - sum(
        v for k, v in before.items() if k[0] == "A" and k[3]) == 3
    assert tracing.launches("A", 2, 2) == after[("A", 2, 2, True)] + after[("A", 2, 2, False)]


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there; the CPU tests hold their plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D,O", [(2, 2), (3, 4), (1, 8)])
def test_a_paired_kernel_a_call_moves_exactly_its_instance_key(dev, D, O):
    from eks_tpu_torch.ops import fused_nll
    from tests.test_torch_cuda_kernels import _nll_operands

    table, dtable, y = _nll_operands(dev, 3, 300, O=O, D=D)
    before = tracing.snapshot()
    fused_nll.fused_nll_paired(table, dtable, y)
    torch.cuda.synchronize()
    assert tracing.since(before) == {("A", D, O, True): 1}


@pytest.mark.cuda
def test_a_call_on_the_card_counts_its_launches_by_instance(dev):
    timings = {}
    eks_tpu_torch.ensemble_kalman_smoother_singlecam(
        _singlecam_array(np.random.default_rng(3), T=500), ["a", "b", "c"], device="cuda", timings=timings)
    n = timings["adam_iters"]
    assert n > 0
    counts = dict(timings["counts"])
    counts.pop(("frame", "index_built"), None)  # none where the names' index is cached
    assert counts == {("table", 2, 2): n, ("A", 2, 2, True): n, ("adam_step", 1): n,
                      ("scan", "filter", False, 2): 1, ("scan", "smoother", False, 2): 1,
                      ("output_pull",): 1, ("frame", "wrapped"): 1}
