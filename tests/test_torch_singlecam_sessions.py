"""The PyTorch port's singlecam sessions (eks_tpu_torch/models/singlecam.py:
several recordings stacked as keypoint lanes of one run) against the JAX
package and against the port's own solo runs, on identical numpy inputs made
from a seed; and the host helpers the slice adds (core's initial-s guess and
constant R, utils' crop_R and build_R_from_vars) against the JAX package's.
On the CPU the kernels run as their plain versions."""

import numpy as np
import pandas as pd
import pytest

import eks_tpu
import eks_tpu_torch
from eks_tpu import core as jax_core
from eks_tpu import utils as jax_utils
from eks_tpu.marker_array import MarkerArray as JaxMarkerArray
from eks_tpu.models import singlecam as jax_singlecam
from eks_tpu_torch import core, utils
from eks_tpu_torch.marker_array import MarkerArray
from eks_tpu_torch.utils import make_dlc_pandas_index

FIELDS = ["x", "y", "likelihood"]
KPS = ["nose", "ear", "tail"]


def _arrays(seed, T=90, K=(2, 3), M=4):
    """One (M, 1, T, K_s, 3) random-walk ensemble per entry of ``K``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in K:
        arr = np.zeros((M, 1, T, k, 3))
        arr[..., :2] = rng.normal(size=(1, 1, T, k, 2)).cumsum(axis=2) + 50
        arr[..., :2] += rng.normal(size=(M, 1, T, k, 2)) * 0.3
        arr[..., 2] = rng.uniform(0.7, 1.0, size=(M, 1, T, k))
        out.append(arr)
    return out


def _port(arrs):
    return [MarkerArray(a.astype(np.float32), data_fields=FIELDS) for a in arrs]


def _jax(arrs):
    return [JaxMarkerArray(a, data_fields=FIELDS) for a in arrs]


def _names(arrs):
    return [KPS[:a.shape[3]] for a in arrs]


def _columns(df):
    return [tuple(map(str, c)) for c in df.columns]


def _port_sessions(arrs, **kw):
    return eks_tpu_torch.ensemble_kalman_smoother_singlecam_sessions(
        _port(arrs), _names(arrs), device="cpu", **kw)


def _port_solo(arr, **kw):
    return eks_tpu_torch.ensemble_kalman_smoother_singlecam(
        _port([arr])[0], _names([arr])[0], device="cpu", **kw)


# --------------------------------------------------------------------------- #
# batched runs
# --------------------------------------------------------------------------- #
def test_batched_auto_s_with_blocks_matches_jax_and_solo_runs():
    """Two sessions (1 and 2 keypoints) stacked into one auto-s run, session
    1 with the block [0, 1], which becomes lanes [1, 2] of the stacked run
    and shares one s; session 0 declared no blocks, so its lane is a
    singleton and still optimized. Each session's s and table against the
    JAX package's batched run (s at rtol 5e-4, tables at atol 1e-4), and
    session 1's against the port's solo run of it with its own block. The
    lane count changes how the plain scans associate, so the batched and
    solo runs add in different orders: s at rtol 5e-4, the table at atol
    1e-4 there too."""
    arrs = _arrays(0, T=60, K=(1, 2))
    blocks = [None, [[0, 1]]]
    got = _port_sessions(arrs, blocks=blocks)
    want = jax_singlecam.ensemble_kalman_smoother_singlecam_sessions(_jax(arrs), _names(arrs), blocks=blocks)
    assert len(got) == len(want) == 2
    assert got[1][1][0] == got[1][1][1]
    assert np.isfinite(got[0][1]).all() and (got[0][1] > 0).all()
    for (df_p, s_p), (df_j, s_j) in zip(got, want):
        assert _columns(df_p) == _columns(df_j)
        np.testing.assert_allclose(s_p, np.asarray(s_j), rtol=5e-4)
        np.testing.assert_allclose(df_p.to_numpy(), df_j.to_numpy(), rtol=0, atol=1e-4)
    df_s, s_s = _port_solo(arrs[1], blocks=blocks[1])
    np.testing.assert_allclose(got[1][1], s_s, rtol=5e-4)
    np.testing.assert_allclose(got[1][0].to_numpy(), df_s.to_numpy(), rtol=0, atol=1e-4)


def test_per_session_smooth_param_lists_expand_per_keypoint():
    """Per-session fixed s: a scalar, a per-keypoint list and a length-1
    list (broadcast); the tables match the JAX package's at atol 1e-4."""
    arrs = _arrays(1, K=(2, 3, 2))
    param = [2.0, [1.0, 3.0, 0.5], [4.0]]
    got = _port_sessions(arrs, smooth_param=param)
    want = jax_singlecam.ensemble_kalman_smoother_singlecam_sessions(
        _jax(arrs), _names(arrs), smooth_param=param)
    for (df_p, s_p), (df_j, _), s_want in zip(got, want, ([2.0, 2.0], [1.0, 3.0, 0.5], [4.0, 4.0])):
        np.testing.assert_array_equal(s_p, s_want)
        np.testing.assert_allclose(df_p.to_numpy(), df_j.to_numpy(), rtol=0, atol=1e-4)
    with pytest.raises(AssertionError, match="one entry per keypoint"):
        _port_sessions(arrs, smooth_param=[2.0, [1.0, 3.0], 1.0])


@pytest.mark.parametrize("case", ["unequal_frames", "one_session", "mixed_fixed_and_auto"])
def test_fallbacks_run_each_session_alone(case):
    """Unequal (models, frames), a single session, and a mix of fixed and
    auto s fall back to one solo run per session: the results are the solo
    runs' exactly."""
    if case == "unequal_frames":
        arrs = _arrays(3, T=60, K=(2,)) + _arrays(4, T=80, K=(2,))
        param = 1.5
    elif case == "one_session":
        arrs, param = _arrays(5, K=(3,)), [[1.0, 2.0, 3.0]]
    else:
        arrs, param = _arrays(6, T=40, K=(1, 1)), [None, 2.5]
    got = _port_sessions(arrs, smooth_param=param)
    assert len(got) == len(arrs)
    for i, ((df, s), arr) in enumerate(zip(got, arrs)):
        p = param[i] if isinstance(param, list) else param
        df_s, s_s = _port_solo(arr, smooth_param=p)
        assert df.shape == (arr.shape[2], arr.shape[3] * 9)
        np.testing.assert_array_equal(s, s_s)
        np.testing.assert_array_equal(df.to_numpy(), df_s.to_numpy())
    if case == "mixed_fixed_and_auto":
        np.testing.assert_array_equal(got[1][1], [2.5])


def test_no_sessions_returns_empty():
    assert eks_tpu_torch.ensemble_kalman_smoother_singlecam_sessions([], [], device="cpu") == []


def test_fit_sessions_from_files_matches_jax(tmp_path):
    """The file-level wrapper: per-session CSV directories in, per-session
    CSVs out, against the JAX package's wrapper (fixed s = 2.0, atol
    1e-4); the saved CSVs read back as the returned tables."""
    rng = np.random.default_rng(7)
    sources, saves = [], []
    for s in range(2):
        d = tmp_path / f"session{s}"
        d.mkdir()
        for m in range(3):
            xy = rng.normal(size=(50, 4)).cumsum(axis=0) + 40
            lh = rng.uniform(0.8, 1.0, size=(50, 2))
            data = np.concatenate([xy, lh], axis=1)[:, [0, 1, 4, 2, 3, 5]]
            pd.DataFrame(data, columns=make_dlc_pandas_index(KPS[:2], labels=FIELDS)).to_csv(d / f"seed{m}.csv")
        sources.append(str(d))
        saves.append(str(tmp_path / f"out{s}.csv"))
    got = eks_tpu_torch.fit_eks_singlecam_sessions(sources, saves, smooth_param=2.0, device="cpu")
    want = eks_tpu.fit_eks_singlecam_sessions(sources, [str(tmp_path / f"j{s}.csv") for s in range(2)],
                                              smooth_param=2.0)
    for (df, s_finals, dfs, names), (df_j, _, _, names_j), save in zip(got, want, saves):
        assert names == names_j and len(dfs) == 3
        np.testing.assert_array_equal(s_finals, [2.0, 2.0])
        np.testing.assert_allclose(df.to_numpy(), df_j.to_numpy(), rtol=0, atol=1e-4)
        saved = pd.read_csv(save, header=[0, 1, 2], index_col=0)
        np.testing.assert_allclose(saved.to_numpy(), df.to_numpy(), rtol=1e-6)


# --------------------------------------------------------------------------- #
# host helpers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("helper", ["compute_initial_guesses", "constant_R_from_timevarying",
                                    "crop_R", "build_R_from_vars"])
def test_host_helpers_match_jax(helper):
    """The four host helpers on the same numpy inputs, NaNs included: equal
    to the JAX package's (they are numpy on both sides)."""
    rng = np.random.default_rng(8)
    ev = np.abs(rng.normal(size=(2500, 4)))
    ev[[3, 40], 1] = np.nan
    R_t = ev[:, :, None] * np.eye(4)
    if helper == "compute_initial_guesses":
        assert core.compute_initial_guesses(ev) == jax_core.compute_initial_guesses(ev)
        with pytest.raises(ValueError):
            core.compute_initial_guesses(ev[:1])
    elif helper == "constant_R_from_timevarying":
        for min_var in (1e-4, 0.5):
            np.testing.assert_array_equal(core.constant_R_from_timevarying(R_t, min_var),
                                          jax_core.constant_R_from_timevarying(R_t, min_var))
    elif helper == "crop_R":
        stacked = np.stack([R_t, 2 * R_t])  # (2, T, O, O)
        for spans in (None, [], [(0, 10)], [(100, 200), (5, 20)], [(2400, None)]):
            got, want = utils.crop_R(stacked, spans), jax_utils.crop_R(stacked, spans)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(utils.build_R_from_vars(ev), jax_utils.build_R_from_vars(ev))
        np.testing.assert_array_equal(utils.build_R_from_vars(-ev[:5]), jax_utils.build_R_from_vars(-ev[:5]))
