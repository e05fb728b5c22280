"""A two-view rig's session: one 3-D body seen by two cameras.

``make_two_camera_session`` draws, from one generator, a 3-D random walk
for each keypoint (a body offset plus unit-variance steps), one fixed
2 x 3 affine camera map for each of the configuration's ``cameras`` (a
random rotation's first two rows times a scale, and an offset in pixels;
two for a two-view rig), each ensemble member's prediction as the
projection plus 0.5 px of jitter, and on 1 % of the (member, camera,
frame, keypoint) entries a glitch: that member's x and y moved by
N(0, 10 px) each, as a pose network now and then locks onto the wrong
spot. Likelihoods are U(0.7, 1.0). The result is a float32 (members,
cameras, frames, keypoints, 3) array of [x, y, likelihood], so the four
observed coordinates of a keypoint carry rank-3 structure, as a real rig's
do.

Importing the module adds the recipe to ``generators.sessions.GENERATORS``.
"""

from __future__ import annotations

import numpy as np

from generators.sessions import GENERATORS

JITTER_PX, GLITCH_SHARE, GLITCH_PX = 0.5, 0.01, 10.0


def _camera(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """A 2 x 3 affine map (scaled rows of a random rotation) and its offset."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q * np.sign(np.diag(r))
    return rng.uniform(0.8, 1.2) * rot[:2], rng.uniform(100.0, 500.0, size=2)


def make_two_camera_session(rng: np.random.Generator, cfg: dict) -> np.ndarray:
    T, K, M, C = cfg["frames"], cfg["keypoints"], cfg["members"], cfg["cameras"]
    body = rng.normal(scale=20.0, size=(1, K, 3)) + rng.normal(size=(T, K, 3)).cumsum(axis=0)  # (T, K, 3)
    views = [_camera(rng) for _ in range(C)]
    base = np.stack([body @ P.T + off for P, off in views])  # (C, T, K, 2)
    xy = base[None] + rng.normal(scale=JITTER_PX, size=(M, C, T, K, 2))
    glitch = rng.random(size=(M, C, T, K)) < GLITCH_SHARE
    xy[glitch] += rng.normal(scale=GLITCH_PX, size=(int(glitch.sum()), 2))
    arr = np.empty((M, C, T, K, 3), dtype=np.float32)
    arr[..., :2] = xy
    arr[..., 2] = rng.uniform(0.7, 1.0, size=(M, C, T, K))
    return arr


GENERATORS["make_two_camera_session"] = make_two_camera_session
