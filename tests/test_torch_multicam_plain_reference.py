"""The port's linear two-camera smoother (``ensemble_kalman_smoother_multicam``
with no calibration) against the benchmark's plain float64 reference
(``benchmark/reference/``, through ``benchmark/check.py``'s ``judge``) on
the CPU, on a session of the benchmark's two-camera recipe
(``benchmark/generators/two_camera.py``) at T = 300, K = 3, M = 5: with s
given and tuned at ``n_latent`` = 3, (D, O) = (3, 4), and tuned at
``n_latent`` = 2, (D, O) = (2, 4).

The limits and why (readings of seeds 0-4 at this size: ``stats_gap``
2.3e-7, ``mean_gap`` 7.9e-4, ``var_gap`` 1.1e-4, ``s_gap`` 2.2e-5 at
most; the TF32 control at s = 2 on seeds 0 and 1: 0.088, 0.91, 2.33):

- ``stats_gap`` 1e-5: float32 medians, variances and likelihoods agree
  with float64 to a few ulps of 1 + |value|;
- ``mean_gap`` 2e-2 posterior standard deviations: the float32 PCA fit
  and scans over 300 steps;
- ``var_gap`` 1e-2: the float32 covariances, relative;
- ``s_gap`` 1e-3 in log s: a float32 log-likelihood's gradient steers
  Adam to within 1e-5 of the float64 replay's answer.

Each is 25 times or more the largest reading and well under the control's
least, which fails all three it is judged by.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import eks_tpu_torch  # noqa: E402
from check import control_outputs, judge  # noqa: E402
from families import load  # noqa: E402
from generators.sessions import session_pool  # noqa: E402
from reference.precision import FLOAT64, TF32  # noqa: E402

LIMITS = {"stats_gap": 1e-5, "mean_gap": 2e-2, "var_gap": 1e-2, "s_gap": 1e-3}
SEED = 0


def _cfg(n_latent: int) -> dict:
    return {"family": "multicam_linear", "generator": "make_two_camera_session", "frames": 300,
            "keypoints": 3, "members": 5, "cameras": 2, "state_dim": n_latent, "obs_dim": 4,
            "n_latent": n_latent, "quantile_keep_pca": 50.0}


def _session(cfg):
    fam = load(cfg["family"])  # imported first: it adds the two-camera recipe to the generators
    (arr,) = session_pool(SEED, cfg, 1)
    return fam, arr


@pytest.mark.parametrize("n_latent,smooth_param", [(3, 2.0), (3, None), (2, None)],
                         ids=["latent3-s2", "latent3-tuned", "latent2-tuned"])
def test_the_port_matches_the_plain_reference(n_latent, smooth_param):
    cfg = _cfg(n_latent)
    fam, arr = _session(cfg)
    out = fam.outputs(fam.call(eks_tpu_torch, arr, cfg, smooth_param, "cpu", None), cfg)
    assert out["tables"].shape == (2, 300, 3, 9)
    nums = judge(cfg, [arr], [out], smooth_param is None, "cpu")
    assert set(nums) == {"stats_gap", "mean_gap", "var_gap"} | ({"s_gap"} if smooth_param is None else set())
    assert all(v <= LIMITS[k] for k, v in nums.items()), nums


@pytest.mark.parametrize("precision,fails", [(TF32, True), (FLOAT64, False)], ids=["tf32", "float64"])
def test_the_limits_refuse_the_tf32_control_and_pass_the_float64_reference(precision, fails):
    cfg = _cfg(3)
    fam, arr = _session(cfg)
    nums = judge(cfg, [arr], control_outputs(cfg, [arr], 2.0, precision, "cpu"), False, "cpu")
    if fails:
        assert any(v > LIMITS[k] for k, v in nums.items()), nums
    else:
        assert all(v < 1e-9 for v in nums.values()), nums
