"""The port's multi-device smoothing through the families' entry points and
the command line, against the JAX package, case by case of
tests/test_parallel_sessions.py and the family cases of tests/test_parallel.py,
on the CPU: the JAX package on its eight virtual CPU devices, the port on a
mesh of the CPU named eight times. Same numpy inputs, the JAX tests' own
limits (keypoint axis: s rtol 1e-4, tables atol 1e-3 through the families;
pupil: rtol 1e-3 at safety_cap 15; nonlinear emission: 1e-3). Where the JAX
test of a case is marked slow, the port's sharded run is held against the
JAX package's one-device run at that test's limits, the JAX test holding the
JAX mesh to that run; and each family's sharded run against the port's own
one-device run."""

import os
import sys
from unittest import mock

import numpy as np
import pandas as pd
import torch

import eks_tpu_torch
from eks_tpu.cli.main import main as jax_main
from eks_tpu.core import run_kalman_smoother as jax_run_kalman_smoother
from eks_tpu.marker_array import MarkerArray as JaxMarkerArray
from eks_tpu.models.ibl_pupil import BODYPART_LIST
from eks_tpu.models.ibl_pupil import PUPIL_C as JAX_PUPIL_C
from eks_tpu.models.ibl_pupil import ensemble_kalman_smoother_ibl_pupil as jax_smoother_pupil
from eks_tpu.models.ibl_pupil import pupil_optimize_smooth as jax_pupil_optimize_smooth
from eks_tpu.models.multicam import ensemble_kalman_smoother_multicam as jax_smoother_multicam
from eks_tpu.models.singlecam import ensemble_kalman_smoother_singlecam_sessions as jax_sessions
from eks_tpu.parallel import make_mesh as jax_make_mesh
from eks_tpu.parallel import optimize_and_smooth_sharded as jax_optimize_and_smooth_sharded
from eks_tpu_torch.cli.main import main
from eks_tpu_torch.core import run_kalman_smoother
from eks_tpu_torch.geometry import Camera, CameraGroup, make_projection_from_camgroup
from eks_tpu_torch.marker_array import MarkerArray
from eks_tpu_torch.models.ibl_pupil import pupil_optimize_smooth
from eks_tpu_torch.parallel import make_mesh, optimize_and_smooth_sharded
from tests.integration.conftest import DATA
from tests.integration.cropping import make_cropped_session
from tests.test_parallel import _calibrated_problem, _toy


def _tables_close(got, want, atol, rtol=0.0):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), atol=atol, rtol=rtol)


# --------------------------------------------------------------------------- #
# tests/test_parallel_sessions.py
# --------------------------------------------------------------------------- #
def test_singlecam_sessions_under_mesh(rng):
    """Two sessions stacked on the keypoint axis and that axis sharded over
    eight shards against the JAX package's devices=8 (s rtol 1e-4, tables
    atol 1e-3 rtol 1e-5, the JAX test's limits), and against the port's
    one-device sessions run bit for bit (each shard runs its lanes alone)."""
    M, T, K, n_sess = 3, 64, 4, 2
    arrays, names = [], []
    for _ in range(n_sess):
        truth = rng.normal(size=(1, 1, T, K, 2)).cumsum(axis=2)
        arr = np.zeros((M, 1, T, K, 3), dtype=np.float32)
        arr[..., :2] = (truth + rng.normal(size=(M, 1, T, K, 2)) * 0.3).astype(np.float32)
        arr[..., 2] = rng.uniform(0.7, 1.0, size=(M, 1, T, K)).astype(np.float32)
        arrays.append(arr)
        names.append([f"kp{i}" for i in range(K)])
    fields = ["x", "y", "likelihood"]
    res_j = jax_sessions([JaxMarkerArray(a, data_fields=fields) for a in arrays], names, devices=8)
    mas = [MarkerArray(a, data_fields=fields) for a in arrays]
    res_p = eks_tpu_torch.ensemble_kalman_smoother_singlecam_sessions(mas, names, devices=8, device="cpu")
    assert len(res_p) == n_sess
    for (df_p, s_p), (df_j, s_j) in zip(res_p, res_j):
        np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_j), rtol=1e-4)
        _tables_close([df_p], [df_j], atol=1e-3, rtol=1e-5)
    res_1 = eks_tpu_torch.ensemble_kalman_smoother_singlecam_sessions(mas, names, device="cpu")
    for (df_p, s_p), (df_1, s_1) in zip(res_p, res_1):
        np.testing.assert_array_equal(np.asarray(s_p), np.asarray(s_1))
        np.testing.assert_array_equal(df_p.to_numpy(), df_1.to_numpy())


def test_sharded_optimizer_nan_vars_use_nanmedian(rng):
    """NaN variances on one keypoint do not poison the sharded optimizer:
    s is finite, the other keypoints optimize as without the NaNs, and the
    NaN run matches the JAX package's on its four-device mesh."""
    ys, m0s, S0s, As, Qs, Cs, ev = _toy(rng, K=8)
    ev_nan = ev.copy()
    ev_nan[::7, 1, :] = np.nan
    mesh = make_mesh(4, "cpu")
    s_nan, _, _ = optimize_and_smooth_sharded(ys, m0s, S0s, As, Qs, Cs, ev_nan, mesh=mesh)
    s_ref, _, _ = optimize_and_smooth_sharded(ys, m0s, S0s, As, Qs, Cs, ev, mesh=mesh)
    assert np.isfinite(s_nan).all()
    keep = [k for k in range(8) if k != 1]
    np.testing.assert_allclose(s_nan[keep], s_ref[keep], rtol=1e-6)
    s_j, _, _ = jax_optimize_and_smooth_sharded(ys, m0s, S0s, As, Qs, Cs, ev_nan, mesh=jax_make_mesh(4))
    np.testing.assert_allclose(s_nan, np.asarray(s_j), rtol=1e-4)


# --------------------------------------------------------------------------- #
# the families of tests/test_parallel.py
# --------------------------------------------------------------------------- #
def _port_camgroup():
    """tests/test_parallel.py's two-camera rig as the port's CameraGroup."""
    return CameraGroup([
        Camera(name=f"cam{c}", matrix=np.array([[800.0, 0, 160], [0, 800.0, 120], [0, 0, 1]]),
               dist=np.array([-0.03, 0.005, 0.0, 0.0, 0.0]), rvec=np.array([0.0, 0.3 * (c - 0.5), 0.0]),
               tvec=np.array([0.2 * (c - 0.5), 0.0, 2.0]))
        for c in range(2)
    ])


def test_devices_with_nonlinear_h_fn(rng):
    """The calibrated optimizer and final pass on eight keypoint shards
    (three keypoints: five shards stay empty), relinearized from a given
    trajectory (split with the lanes), bit for bit against the port's
    one-device run; and its final pass against the JAX package's one-device
    final pass at the same s (1e-3, the JAX test's limit). The JAX test
    tunes s on the JAX side too, a compile of minutes here; the port's
    one-device calibrated optimizer is held against the JAX package's in
    tests/test_torch_calibrated.py."""
    _, obs, ev, m0s, S0s, As, Qs, Cs, hj = _calibrated_problem(rng)
    args = dict(m0s=np.asarray(m0s), S0s=np.asarray(S0s), As=np.asarray(As), Cs=np.asarray(Cs),
                Qs=np.asarray(Qs), ensemble_vars=ev)
    h_fn, _ = make_projection_from_camgroup(_port_camgroup(), device="cpu")
    t = [torch.tensor(np.asarray(a), dtype=torch.float32)
         for a in (obs, args["m0s"], args["S0s"], args["As"], args["Cs"], args["Qs"], ev)]
    x_init = t[1][:, None].expand(-1, obs.shape[1], -1).contiguous()
    timings = {}
    s8, m8, v8 = run_kalman_smoother(*t, h_fn=h_fn, x_init=x_init, safety_cap=3, devices=8, timings=timings)
    assert timings["adam_iters_per_shard"] == [3, 3, 3]
    s1, m1, v1 = run_kalman_smoother(*t, h_fn=h_fn, x_init=x_init, safety_cap=3)
    np.testing.assert_array_equal(s8, s1)
    np.testing.assert_array_equal(m8.numpy(), m1.numpy())
    np.testing.assert_array_equal(v8.numpy(), v1.numpy())
    _, m_j, v_j = jax_run_kalman_smoother(ys=obs, **args, h_fn=hj, smooth_param=list(map(float, s8)))
    np.testing.assert_allclose(m8.numpy(), np.asarray(m_j), atol=1e-3)
    np.testing.assert_allclose(v8.numpy(), np.asarray(v_j), atol=1e-3)


def _calibrated_session(rng):
    """tests/test_parallel.py's calibrated family session: (M, C, T, K, 3)."""
    _, obs, _, *_ = _calibrated_problem(rng, K=2, T=48)
    M, C, T, K = 3, 2, 48, 2
    arr = np.zeros((M, C, T, K, 3), dtype=np.float32)
    for c in range(C):
        arr[:, c, :, :, 0] = obs[:, :, 2 * c].T[None] + rng.normal(size=(M, T, K)).astype(np.float32) * 0.3
        arr[:, c, :, :, 1] = obs[:, :, 2 * c + 1].T[None] + rng.normal(size=(M, T, K)).astype(np.float32) * 0.3
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(M, C, T, K)).astype(np.float32)
    return arr


def test_multicam_calibrated_family_devices(rng):
    """ensemble_kalman_smoother_multicam(camgroup=..., devices=8) at s = 3
    against the JAX package's devices=8 (tables 1e-3, s 1e-4), and the
    frame axis over eight shards against the port's one-device tables."""
    from tests.test_parallel import _tiny_camgroup

    arr = _calibrated_session(rng)
    names, cams = ["kp0", "kp1"], ["cam0", "cam1"]
    dfs_j, s_j, d3_j = jax_smoother_multicam(JaxMarkerArray(arr, data_fields=["x", "y", "likelihood"]), names,
                                             cams, smooth_param=3.0, camgroup=_tiny_camgroup(), devices=8)
    ma = MarkerArray(arr, data_fields=["x", "y", "likelihood"])
    group = _port_camgroup()
    dfs8, s8, d3_8 = eks_tpu_torch.ensemble_kalman_smoother_multicam(
        ma, names, cams, smooth_param=3.0, camgroup=group, devices=8, device="cpu")
    np.testing.assert_allclose(s8, s_j, rtol=1e-4)
    _tables_close(dfs8 + [d3_8], list(dfs_j) + [d3_j], atol=1e-3)
    dfs1, _, d3_1 = eks_tpu_torch.ensemble_kalman_smoother_multicam(
        ma, names, cams, smooth_param=3.0, camgroup=group, device="cpu")
    dfst, _, d3_t = eks_tpu_torch.ensemble_kalman_smoother_multicam(
        ma, names, cams, smooth_param=3.0, camgroup=group, devices=8, partition="time", device="cpu")
    _tables_close(dfs8 + [d3_8], dfs1 + [d3_1], atol=0.0)
    _tables_close(dfst + [d3_t], dfs1 + [d3_1], atol=1e-3)


def test_multicam_linear_family_devices(rng):
    """The fused linear multicam path with auto s under devices=8 against the
    JAX package's one-device run (s rtol 1e-3, tables atol 1e-3, the JAX
    test's limits)."""
    M, C, T, K = 3, 2, 64, 3
    base = rng.normal(size=(1, C, T, K, 2)).cumsum(axis=2) * 0.3 + 50
    arr = np.zeros((M, C, T, K, 3), dtype=np.float32)
    arr[..., :2] = base + rng.normal(size=(M, C, T, K, 2)) * 0.3
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(M, C, T, K))
    names, cams = [f"kp{i}" for i in range(K)], ["cam0", "cam1"]
    dfs_j, s_j, _ = jax_smoother_multicam(JaxMarkerArray(arr, data_fields=["x", "y", "likelihood"]), names,
                                          cams, inflate_vars=False, n_latent=3)
    ma = MarkerArray(arr, data_fields=["x", "y", "likelihood"])
    dfs8, s8, _ = eks_tpu_torch.ensemble_kalman_smoother_multicam(ma, names, cams, n_latent=3, devices=8,
                                                                  device="cpu")
    np.testing.assert_allclose(s8, s_j, rtol=1e-3)
    _tables_close(dfs8, dfs_j, atol=1e-3)


def _pupil_inputs(rng, T=256):
    ys = (rng.normal(size=(T, 8)).cumsum(0) * 0.05).astype(np.float32)
    ev = (np.abs(rng.normal(size=(T, 8))) * 0.2 + 0.05).astype(np.float32)
    kw = dict(m0=np.array([10.0, 0.0, 0.0], dtype=np.float32), S0=np.diag([1.0, 0.5, 0.5]).astype(np.float32),
              C=np.asarray(JAX_PUPIL_C, dtype=np.float32), ensemble_vars=ev, diameters_var=1.0, x_var=0.5,
              y_var=0.5, safety_cap=15)
    return ys, kw


def test_pupil_two_param_optimizer_under_mesh(rng):
    """The pupil optimizer with the frame axis over four shards (the staged
    time-varying-R loss over the sharded paired scan) against the JAX
    package's one-device iterates at safety_cap 15 (rtol 1e-3, the JAX
    test's limit). Four shards, not the JAX test's eight: on the CPU every
    shard's plain scan costs its own tens of milliseconds an iteration."""
    ys, kw = _pupil_inputs(rng)
    s_j = jax_pupil_optimize_smooth(ys=ys, **kw)
    s4 = pupil_optimize_smooth(ys=ys, **kw, devices=4, device="cpu")
    np.testing.assert_allclose(s4, s_j, rtol=1e-3)


def test_pupil_family_devices(rng):
    """ensemble_kalman_smoother_ibl_pupil(devices=8), the frame-axis-sharded
    final pass, against the JAX package's devices=8: s rtol 1e-6, table
    atol 1e-3."""
    M, T = 3, 128
    com = rng.normal(size=(T, 2)).cumsum(axis=0) * 0.05 + 60
    diam = 20 + rng.normal(size=T).cumsum() * 0.01
    offs = {"pupil_top_r": (0, -0.5), "pupil_bottom_r": (0, 0.5), "pupil_right_r": (0.5, 0),
            "pupil_left_r": (-0.5, 0)}
    arr = np.zeros((M, 1, T, 4, 3), dtype=np.float32)
    for k, kp in enumerate(BODYPART_LIST):
        dx, dy = offs[kp]
        arr[:, 0, :, k, 0] = com[:, 0] + dx * diam + rng.normal(size=(M, T)) * 0.2
        arr[:, 0, :, k, 1] = com[:, 1] + dy * diam + rng.normal(size=(M, T)) * 0.2
    arr[..., 2] = rng.uniform(0.8, 1.0, size=(M, 1, T, 4))
    fields = ["x", "y", "likelihood"]
    df_j, s_j = jax_smoother_pupil(JaxMarkerArray(arr, data_fields=fields), BODYPART_LIST,
                                   smooth_params=[0.99, 0.98], devices=8)
    ma = MarkerArray(arr, data_fields=fields)
    df8, s8 = eks_tpu_torch.ensemble_kalman_smoother_ibl_pupil(ma, BODYPART_LIST, smooth_params=[0.99, 0.98],
                                                               devices=8, device="cpu")
    np.testing.assert_allclose(s8, s_j, rtol=1e-6)
    np.testing.assert_allclose(df8.to_numpy(), df_j.to_numpy(), atol=1e-3)


# --------------------------------------------------------------------------- #
# the command line
# --------------------------------------------------------------------------- #
def _cli(entry, prog, argv):
    with mock.patch.object(sys, "argv", [prog] + argv):
        entry()


def test_devices_flag_cli_singlecam(tmp_path, rng):
    """singlecam --devices 8 with s = 2 on three random-prediction CSVs:
    the port's CLI on the CPU against the JAX CLI on its eight devices
    (atol 1e-4, the JAX test's limit), and against the port's one-device
    command line bit for bit."""
    kps = ["a", "b", "c"]
    cols = pd.MultiIndex.from_product([["m"], kps, ["x", "y", "likelihood"]],
                                      names=["scorer", "bodyparts", "coords"])
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i in range(3):
        pd.DataFrame(rng.random((60, len(kps) * 3)).astype(np.float32), columns=cols).to_csv(
            in_dir / f"preds.rng={i}.csv")
    common = ["singlecam", "--input-dir", str(in_dir), "--save-dir", str(tmp_path), "--s", "2.0"]
    _cli(jax_main, "eks-tpu", common + ["--save-filename", "jax.csv", "--devices", "8"])
    _cli(main, "eks-tpu-torch", common + ["--save-filename", "mesh.csv", "--devices", "8", "--device", "cpu"])
    _cli(main, "eks-tpu-torch", common + ["--save-filename", "one.csv", "--device", "cpu"])
    read = {n: pd.read_csv(tmp_path / f"{n}.csv", header=[0, 1, 2], index_col=0).to_numpy()
            for n in ("jax", "mesh", "one")}
    np.testing.assert_allclose(read["mesh"], read["jax"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(read["mesh"], read["one"])


def test_cli_time_partition_on_the_bundled_session(tmp_path):
    """singlecam --devices 8 --partition time at s = 2 on the bundled session
    cropped to 200 frames (the final pass's frame axis over eight shards):
    the port's CLI on the CPU against the JAX CLI on its eight devices at
    1e-4. The time-sharded optimizer is held in
    tests/test_torch_parallel.py."""
    session = make_cropped_session(os.path.join(DATA, "singlecam"), str(tmp_path / "singlecam"))
    common = ["singlecam", "--input-dir", session, "--save-dir", str(tmp_path), "--devices", "8",
              "--partition", "time", "--s", "2.0"]
    _cli(jax_main, "eks-tpu", common + ["--save-filename", "jax.csv"])
    _cli(main, "eks-tpu-torch", common + ["--save-filename", "port.csv", "--device", "cpu"])
    got, want = (pd.read_csv(tmp_path / f"{n}.csv", header=[0, 1, 2], index_col=0) for n in ("port", "jax"))
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=1e-4)
