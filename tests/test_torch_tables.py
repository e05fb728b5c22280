"""The port's output path (``eks_tpu_torch/utils/io.py``): an entry point's
results cross from the device in one copy (``pull_outputs``), and every
returned table is wrapped around that copy, or a view of it, without another
copy, over its own shallow copy of a cached column index (``dlc_frame``).

Each table site is held against the construction it replaces,
``pd.DataFrame(arr.copy(), columns=make_dlc_pandas_index(...))``, bit for
bit, with the two-camera fused paths' blocks also against the former host
interleave of the same device results. Writing into one returned table or
renaming its column levels changes no other table, and no table of the next
call. The registry counts a pull a call, a wrapped table a table and an
index build only on a cache miss.

The test marked ``cuda`` builds the two-camera blocks on the card and skips
without one; there (where JAX is not installed, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_tables.py -q
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import eks_tpu_torch
from eks_tpu_torch import tracing
from eks_tpu_torch.geometry import CameraGroup, make_projection_from_camgroup
from eks_tpu_torch.marker_array import MarkerArray
from eks_tpu_torch.models import ibl_pupil, multicam, singlecam
from eks_tpu_torch.utils import io, make_dlc_pandas_index

CALIBRATION = Path(__file__).resolve().parent.parent / "data" / "multicam" / "calibration.toml"
FIELDS = ["x", "y", "likelihood"]
NAMES = ["nose", "paw", "tail"]
OUTPUT_KEYS = (("frame", "wrapped"), ("frame", "index_built"), ("output_pull",))


def _singlecam_array(rng, M=4, T=60, K=3):
    arr = np.cumsum(rng.normal(size=(1, 1, T, K, 2)), axis=2) + rng.normal(size=(M, 1, T, K, 2)) * 0.5
    lh = rng.uniform(0.5, 1.0, size=(M, 1, T, K, 1))
    return MarkerArray(np.concatenate([arr, lh], axis=-1).astype(np.float32), data_fields=FIELDS)


def _multicam_array(rng, M=4, C=2, T=60, K=3):
    lat = rng.normal(size=(T, K, 3)).cumsum(axis=0)
    load = rng.normal(size=(K, 2 * C, 3))
    base = np.einsum("tkl,kfl->tkf", lat, load).reshape(T, K, C, 2).transpose(2, 0, 1, 3)
    xy = base[None] + rng.normal(size=(M, C, T, K, 2)) * 0.3
    lh = rng.uniform(0.5, 1.0, size=(M, C, T, K, 1))
    return MarkerArray(np.concatenate([xy, lh], axis=-1).astype(np.float32), data_fields=FIELDS)


def _calibrated_array(rng, group, M=4, T=60, K=2):
    """A 3-D random walk a keypoint seen through the bundled two-camera rig,
    with pixel jitter a member."""
    h64, _ = make_projection_from_camgroup(group, device="cpu", dtype=torch.float64)
    walk = rng.normal(size=(K, T, 3)).cumsum(axis=1) * 0.01
    px = h64(torch.as_tensor(walk)).numpy().reshape(K, T, 2, 2).transpose(2, 1, 0, 3)  # (C, T, K, 2)
    xy = px[None] + rng.normal(size=(M, 2, T, K, 2))
    lh = rng.uniform(0.5, 1.0, size=(M, 2, T, K, 1))
    return MarkerArray(np.concatenate([xy, lh], axis=-1).astype(np.float32), data_fields=FIELDS)


def _pupil_array(rng, M=4, T=60):
    offsets = {"pupil_top_r": (0.0, -5.0), "pupil_bottom_r": (0.0, 5.0),
               "pupil_right_r": (5.0, 0.0), "pupil_left_r": (-5.0, 0.0)}
    arr = np.zeros((M, 1, T, 4, 3))
    for k, name in enumerate(ibl_pupil.BODYPART_LIST):
        track = np.array([60.0, 40.0]) + offsets[name] + rng.normal(size=(T, 2)) * 0.1
        arr[:, 0, :, k, :2] = track + rng.normal(size=(M, T, 2)) * 0.2
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(M, 1, T, 4))
    return MarkerArray(arr, data_fields=FIELDS)


def _call(site: str, device: str, n_latent: int = 3) -> list:
    """One entry-point call of a table site, s given; its output tables in
    the order they were returned."""
    rng = np.random.default_rng(7)
    if site == "singlecam":
        df, _ = eks_tpu_torch.ensemble_kalman_smoother_singlecam(
            _singlecam_array(rng), NAMES, smooth_param=2.0, device=device)
        return [df]
    if site == "singlecam-sessions":
        out = eks_tpu_torch.ensemble_kalman_smoother_singlecam_sessions(
            [_singlecam_array(rng), _singlecam_array(rng)], [NAMES, NAMES], smooth_param=2.0, device=device)
        return [df for df, _ in out]
    if site == "pupil":
        df, _ = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(
            _pupil_array(rng), ibl_pupil.BODYPART_LIST, smooth_params=[0.9, 0.9], device=device)
        return [df]
    if site == "pupil-sessions":
        out = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil_sessions(
            [_pupil_array(rng), _pupil_array(rng)], ibl_pupil.BODYPART_LIST, smooth_params=[0.9, 0.9],
            device=device)
        return [df for df, _ in out]
    if site.startswith("multicam-calibrated"):
        group = CameraGroup.load(str(CALIBRATION))
        dfs, _, df_3d = eks_tpu_torch.ensemble_kalman_smoother_multicam(
            _calibrated_array(rng, group), NAMES[:2], ["cam0", "cam1"], smooth_param=10.0, camgroup=group,
            s_frames=[(0, 40)] if site.endswith("general") else None, device=device)
        return [*dfs, df_3d]
    dfs, _, df_3d = eks_tpu_torch.ensemble_kalman_smoother_multicam(
        _multicam_array(rng), NAMES, ["l", "r"], smooth_param=2.0, n_latent=n_latent,
        inflate_vars=site == "multicam-general-inflated", device=device)
    return [*dfs, df_3d]


def _host_camera_blocks(sm4: np.ndarray, stats: np.ndarray) -> list:
    """The former host interleave of the two-camera fused paths: the
    smoother-dependent block (C, T, K, 4) and the ensemble stats (C, T, K,
    5) into one (T, K, 9) block per camera, in OUTPUT_LABELS order."""
    return [
        np.concatenate([sm4[c][..., :2], stats[c][..., 4:5], stats[c][..., 0:2], stats[c][..., 2:4],
                        sm4[c][..., 2:4]], axis=-1)
        for c in range(sm4.shape[0])
    ]


def _spy(monkeypatch) -> dict:
    """Record every pull of the output path (its tensors as separate host
    copies, and what the one pull gave), every table wrapped (a copy of its
    array, the array itself, its names and labels) and every two-camera
    device block (sm4 and stats as host copies), in order. The column cache
    starts empty."""
    rec = {"pulls": [], "frames": [], "blocks": []}
    real_pull, real_frame, real_blocks = io.pull_outputs, io.dlc_frame, multicam._camera_blocks

    def pull(*tensors):
        separate = [t.cpu().numpy().copy() for t in tensors]
        out = real_pull(*tensors)
        rec["pulls"].append((separate, out))
        return out

    def frame(array2d, keypoint_names, labels):
        rec["frames"].append((array2d.copy(), array2d, list(keypoint_names), list(labels)))
        return real_frame(array2d, keypoint_names, labels)

    def blocks(sm4, stats):
        rec["blocks"].append((sm4.cpu().numpy().copy(), stats.cpu().numpy().copy()))
        return real_blocks(sm4, stats)

    for module in (singlecam, multicam, ibl_pupil):
        monkeypatch.setattr(module, "pull_outputs", pull)
        monkeypatch.setattr(module, "dlc_frame", frame)
    monkeypatch.setattr(multicam, "_camera_blocks", blocks)
    io._dlc_columns.cache_clear()
    return rec


@pytest.fixture
def spied(monkeypatch):
    return _spy(monkeypatch)


@pytest.fixture(scope="module")
def recorded():
    """Each site's first call on the CPU, once a module: its tables, what
    the spies recorded, and the registry's moves over the call. Tests that
    read these leave them as they are."""
    cache = {}

    def get(site):
        if site not in cache:
            with pytest.MonkeyPatch.context() as mp:
                rec = _spy(mp)
                before = tracing.snapshot()
                rec["tables"] = _call(site, "cpu")
                rec["moved"] = tracing.since(before)
            cache[site] = rec
        return cache[site]

    return get


def _former(arr, names, labels) -> pd.DataFrame:
    return pd.DataFrame(arr.copy(), columns=make_dlc_pandas_index(names, labels))


def _output_counts(moved: dict) -> dict:
    return {k: v for k, v in moved.items() if k in OUTPUT_KEYS}


SITES = ["singlecam", "singlecam-sessions", "multicam-linear-fused", "multicam-calibrated-fused",
         "multicam-general-inflated", "multicam-calibrated-general", "pupil", "pupil-sessions"]
#: the sites whose tables wrap the pulled array itself (the others' host
#: packaging builds their blocks from it)
PULLED = ("singlecam", "singlecam-sessions", "multicam-linear-fused", "multicam-calibrated-fused")


@pytest.mark.parametrize("site", SITES)
def test_the_results_cross_in_one_pull(recorded, site):
    rec = recorded(site)
    (pull,) = rec["pulls"]
    for separate, pulled in zip(*pull):
        assert pulled.dtype == separate.dtype and pulled.shape == separate.shape
        np.testing.assert_array_equal(pulled, separate)  # the tensors' own host copies
    assert len({id(a.base) for a in pull[1]}) == 1  # views of one host buffer
    assert rec["moved"][("output_pull",)] == 1


@pytest.mark.parametrize("site", SITES)
def test_tables_are_the_former_construction_bit_for_bit(recorded, site):
    rec = recorded(site)
    tables = rec["tables"]
    assert len(rec["frames"]) == len(tables)
    for df, (arr, _, names, labels) in zip(tables, rec["frames"]):
        pd.testing.assert_frame_equal(df, _former(arr, names, labels), check_exact=True)
    if site in PULLED:
        assert all(df.dtypes.eq(np.float32).all() for df in tables)
    if site.endswith("-fused"):  # against the former host interleave of the same device results
        (sm4, stats), = rec["blocks"]
        names = rec["frames"][0][2]
        for df, block in zip(tables[:2], _host_camera_blocks(sm4, stats)):
            pd.testing.assert_frame_equal(
                df, _former(block.reshape(block.shape[0], -1), names, multicam.OUTPUT_LABELS), check_exact=True)
        pd.testing.assert_frame_equal(
            tables[2], _former(rec["pulls"][0][0][-1], names, multicam._LABELS_3D), check_exact=True)


@pytest.mark.parametrize("site", SITES)
def test_tables_wrap_their_arrays_over_a_cached_index(recorded, site):
    rec = recorded(site)
    tables = rec["tables"]
    for df, (_, arr, _, _) in zip(tables, rec["frames"]):
        assert np.shares_memory(df.to_numpy(), arr)
    if site in PULLED:
        host = rec["pulls"][0][1][0].base
        assert all(np.shares_memory(df.to_numpy(), host) for df in tables)
    n_keys = len({(tuple(names), tuple(labels)) for _, _, names, labels in rec["frames"]})
    assert _output_counts(rec["moved"]) == {
        ("frame", "wrapped"): len(tables), ("frame", "index_built"): n_keys, ("output_pull",): 1}
    assert len({id(df.columns) for df in tables}) == len(tables)  # a copy of the index a table


@pytest.mark.parametrize("site", SITES)
def test_a_write_or_rename_stays_in_its_table(spied, site):
    """Writing into the first table and renaming its levels reach no other
    table, and no table of the next call, which reuses no host memory and
    builds no index."""
    tables = _call(site, "cpu")
    want = [_former(arr, names, labels) for arr, _, names, labels in spied["frames"]]
    tables[0].iloc[0, 0] = -1.0e30
    tables[0].columns.names = ["a", "b", "c"]
    for df, w in zip(tables[1:], want[1:]):
        pd.testing.assert_frame_equal(df, w, check_exact=True)
    before = tracing.snapshot()
    again = _call(site, "cpu")
    moved = tracing.since(before)
    for df, w in zip(again, want):
        pd.testing.assert_frame_equal(df, w, check_exact=True)
    assert _output_counts(moved) == {("frame", "wrapped"): len(tables), ("output_pull",): 1}
    assert tables[0].iloc[0, 0] == -1.0e30
    assert not any(np.shares_memory(a.to_numpy(), b.to_numpy()) for a in again for b in tables)


@pytest.mark.parametrize("site", SITES)
def test_a_wrapped_table_saves_as_pandas_writes_it(recorded, site, tmp_path):
    """``save_dlc_csv`` (the native writer where it applies) gives the bytes
    of ``df.to_csv`` for every table of the site."""
    for i, df in enumerate(recorded(site)["tables"]):
        io.save_dlc_csv(df, str(tmp_path / f"{i}.csv"))
        df.to_csv(tmp_path / f"{i}.pandas.csv")
        assert (tmp_path / f"{i}.csv").read_bytes() == (tmp_path / f"{i}.pandas.csv").read_bytes()


def test_dlc_frame_columns_are_the_dlc_index():
    arr = np.arange(12, dtype=np.float32).reshape(2, 6)
    df = io.dlc_frame(arr, ["a", "b"], ["x", "y", "likelihood"])
    assert df.columns.equals(make_dlc_pandas_index(["a", "b"], ["x", "y", "likelihood"]))
    assert list(df.columns.names) == ["scorer", "bodyparts", "coords"]
    assert isinstance(df.index, pd.RangeIndex) and np.shares_memory(df.to_numpy(), arr)


def test_pull_outputs_lays_tensors_end_to_end():
    a, b = torch.arange(6.0).reshape(2, 3), torch.arange(4.0).reshape(2, 1, 2) + 10
    before = tracing.snapshot()
    pa, pb = io.pull_outputs(a, b)
    assert tracing.since(before) == {("output_pull",): 1}
    np.testing.assert_array_equal(pa, a.numpy())
    np.testing.assert_array_equal(pb, b.numpy())
    assert pa.shape == (2, 3) and pb.shape == (2, 1, 2) and pa.base is pb.base  # one host buffer


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the two-camera blocks are built there; the CPU tests hold the path")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("site, n_latent", [("multicam-linear-fused", 3), ("multicam-linear-fused", 2),
                                            ("multicam-calibrated-fused", 3)])
def test_two_camera_blocks_built_on_the_card_are_the_host_interleave(dev, spied, site, n_latent):
    """The camera blocks, (T, K * 9) each, and the (T, 6K) 3-D block, built
    on the card and pulled in one copy, against the former host interleave of
    the same device results and their own 3-D block's host copy (zeros at
    ``n_latent`` 2)."""
    tables = _call(site, "cuda", n_latent=n_latent)
    (sm4, stats), = spied["blocks"]
    (separate, (*cams, arr_3d)), = spied["pulls"]
    C, T, K, _ = sm4.shape
    assert len(cams) == C and arr_3d.shape == (T, 6 * K)
    for c, block in enumerate(_host_camera_blocks(sm4, stats)):
        np.testing.assert_array_equal(cams[c], block.reshape(T, K * 9))
        assert np.shares_memory(tables[c].to_numpy(), cams[c])
    np.testing.assert_array_equal(arr_3d, separate[-1])
    if n_latent == 2:
        assert not arr_3d.any()
    np.testing.assert_array_equal(tables[2].to_numpy(), arr_3d)
