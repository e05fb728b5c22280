"""Frozen copies of the port's session recipes, sized by a configuration.

``make_session`` is ``chip_smoke.py::make_session`` (the JAX package's
``bench.py::make_session``): one camera, random-walk keypoints plus
per-member jitter, as a float32 (members, cameras, frames, keypoints, 3)
array of [x, y, likelihood]. They are copied, not imported, so that the yardstick does not
move when the program's scripts do.
"""

from __future__ import annotations

import numpy as np


def make_session(rng: np.random.Generator, cfg: dict) -> np.ndarray:
    T, K, M = cfg["frames"], cfg["keypoints"], cfg["members"]
    truth = rng.normal(size=(1, 1, T, K, 2)).cumsum(axis=2).astype(np.float32)
    arr = np.zeros((M, 1, T, K, 3), dtype=np.float32)
    arr[..., :2] = truth + rng.normal(size=(M, 1, T, K, 2)).astype(np.float32) * 0.5
    arr[..., 2] = rng.uniform(0.7, 1.0, size=(M, 1, T, K)).astype(np.float32)
    return arr


GENERATORS = {"make_session": make_session}


def session_pool(seed: int, cfg: dict, n: int) -> list[np.ndarray]:
    """``n`` sessions of the configuration, each from its own stream of one
    seed sequence: the same seed gives the same pool, and any whole number
    (negative or past 64 bits too) is a seed."""
    streams = np.random.SeedSequence(seed % 2**64).spawn(n)
    make = GENERATORS[cfg["generator"]]
    return [make(np.random.default_rng(s), cfg) for s in streams]
