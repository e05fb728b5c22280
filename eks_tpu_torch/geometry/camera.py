"""Pinhole camera model: Rodrigues, OpenCV distortion, projection, calibration.

Counterpart of ``eks_tpu/geometry/camera.py``. The compute path is plain
PyTorch on the caller's device and dtype; the Anipose calibration TOML is
parsed with stdlib ``tomllib``.

Distortion follows the full OpenCV *rational* model
``radial = (1 + k1 r² + k2 r⁴ + k3 r⁶) / (1 + k4 r² + k5 r⁴ + k6 r⁶)``
plus tangential (p1, p2) and thin-prism (s1..s4) terms; tilt (tx, ty) is
ignored. It matches ``cv2.projectPoints`` for every coefficient count.

The multi-view projector (the calibrated family's EKF emission) holds its
camera parameters as tensors on one device and maps world points
``(..., 3)`` to concatenated pixels ``(..., 2C)``; every camera is one slice
of the same elementwise work, so one forward-mode pass gives its Jacobian
over all cameras (``ops/kalman.py::emission_jacobian``). The projector is a
``functools.partial`` over its tensors, which lets that pass give them zero
tangents, and the distortion uses no Python numbers (``ops/linalg.py::one_plus``).
"""

from __future__ import annotations

import functools
import tomllib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from eks_tpu_torch.geometry.triangulate import triangulate_dlt
from eks_tpu_torch.ops.linalg import one_plus

__all__ = [
    "rodrigues",
    "inverse_rodrigues",
    "parse_dist",
    "make_projection_fn",
    "undistort_points",
    "Camera",
    "CameraGroup",
    "make_projection_from_camgroup",
    "multiview_projection",
    "stack_camera_params",
    "project_point",
    "project_multiview",
]

_DIST_NAMES = ["k1", "k2", "p1", "p2", "k3", "k4", "k5", "k6", "s1", "s2", "s3", "s4"]


def _as(a, like: torch.Tensor | None = None, device=None, dtype=None) -> torch.Tensor:
    """``a`` as a tensor on ``like``'s device and dtype (or the given ones)."""
    if like is not None:
        device, dtype = like.device, like.dtype
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, dtype=dtype, device=device)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(vx)
    return torch.stack([
        torch.stack([zero, -vz, vy], dim=-1),
        torch.stack([vz, zero, -vx], dim=-1),
        torch.stack([-vy, vx, zero], dim=-1),
    ], dim=-2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vectors (..., 3) -> rotation matrices (..., 3, 3), OpenCV
    convention; the first-order ``I + K`` below a 1e-12 rotation angle."""
    theta = torch.linalg.vector_norm(rvec, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    small = theta < 1e-12
    K = _skew(rvec / torch.where(small[..., 0], torch.ones_like(theta[..., 0]), theta[..., 0]))
    general = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(small, eye + _skew(rvec), general)


def inverse_rodrigues(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (3, 3) -> rotation vector (3,), host-side numpy."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-10:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near pi the axis comes from the symmetric part: (R + I) / 2 = a aᵀ
        M = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.clip(np.diagonal(M), 0.0, None))
        # signs from the off-diagonals relative to the largest component
        k = int(np.argmax(axis))
        if axis[k] > 0:
            for i in range(3):
                if i != k:
                    axis[i] = M[i, k] / axis[k]
        axis = axis / np.linalg.norm(axis)
        return theta * axis
    axis = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2.0 * np.sin(theta))
    )
    return theta * axis


def _pad14(dist_coeffs) -> np.ndarray:
    d = np.asarray(dist_coeffs, dtype=np.float64).ravel()[:14]
    return np.pad(d, (0, 14 - d.shape[0]))


def parse_dist(dist_coeffs) -> dict[str, torch.Tensor]:
    """Label OpenCV distortion coefficients, zero-padded to 14, in the order
    ``[k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, tx, ty]``; tilt terms
    are dropped. A (..., 14) tensor gives (...,) entries, anything else is
    padded on the host first."""
    dc = dist_coeffs if torch.is_tensor(dist_coeffs) and dist_coeffs.shape[-1] == 14 \
        else torch.as_tensor(_pad14(dist_coeffs))
    return {name: dc[..., i] for i, name in enumerate(_DIST_NAMES)}


def _distort(x, y, d):
    """OpenCV rational + tangential + thin-prism distortion of normalized
    coordinates. ``p + p`` and ``x + x`` are the exact doubles, free of
    Python numbers, as ``one_plus`` is: the EKF differentiates this
    projection twice over (``ops/linalg.py::one_plus``)."""
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (one_plus(d["k1"] * r2) + d["k2"] * r4 + d["k3"] * r6) / (
        one_plus(d["k4"] * r2) + d["k5"] * r4 + d["k6"] * r6
    )
    p1x2, p2x2 = d["p1"] + d["p1"], d["p2"] + d["p2"]
    x_tan = p1x2 * x * y + d["p2"] * (r2 + (x + x) * x)
    y_tan = d["p1"] * (r2 + (y + y) * y) + p2x2 * x * y
    xd = x * radial + x_tan + d["s1"] * r2 + d["s2"] * r4
    yd = y * radial + y_tan + d["s3"] * r2 + d["s4"] * r4
    return xd, yd


def _project_cameras(Rs, tvecs, Ks, dists, x: torch.Tensor) -> torch.Tensor:
    """World points x (..., 3) through C cameras with rotation matrices
    Rs (C, 3, 3), translations (C, 3), intrinsics Ks (C, 3, 3) and padded
    distortions (C, 14) -> pixels (..., C, 2)."""
    Xc = torch.einsum("...j,cij->...ci", x, Rs) + tvecs
    xn = Xc[..., 0] / Xc[..., 2]
    yn = Xc[..., 1] / Xc[..., 2]
    xd, yd = _distort(xn, yn, parse_dist(dists))
    u = Ks[:, 0, 0] * xd + Ks[:, 0, 1] * yd + Ks[:, 0, 2]
    v = Ks[:, 1, 1] * yd + Ks[:, 1, 2]
    return torch.stack([u, v], dim=-1)


def _concat_views(Rs, tvecs, Ks, dists, x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 2C): every camera's (u, v), in camera order."""
    return _project_cameras(Rs, tvecs, Ks, dists, x).flatten(-2)


def make_projection_fn(
    rvec: np.ndarray,
    tvec: np.ndarray,
    K: np.ndarray,
    dist_coeffs: np.ndarray,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Callable:
    """Build ``project(points (..., 3)) -> (..., 2)``: world -> pixel, with
    full distortion and intrinsic skew (cv2.projectPoints parity), its
    parameters held as ``dtype`` tensors on ``device``."""
    rv = _as(np.asarray(rvec, dtype=np.float64).ravel(), device=device, dtype=dtype)
    R = rodrigues(rv)[None]
    t = _as(np.asarray(tvec, dtype=np.float64).ravel()[None], device=device, dtype=dtype)
    Km = _as(np.asarray(K, dtype=np.float64)[None], device=device, dtype=dtype)
    d = _as(_pad14(dist_coeffs)[None], device=device, dtype=dtype)

    def project(points: torch.Tensor) -> torch.Tensor:
        return _project_cameras(R, t, Km, d, points)[..., 0, :]

    return project


def undistort_points(
    points: torch.Tensor,  # (..., 2) pixel coordinates
    K,
    dist_coeffs,
    num_iters: int = 5,
) -> torch.Tensor:
    """Pixel coordinates -> undistorted *normalized* coordinates, on the
    points' device and dtype: fixed-point inversion of the distortion model
    (the compensation iteration cv2.undistortPoints uses, 5 by default)."""
    K = _as(K, points)
    d = {k: v.to(points) for k, v in parse_dist(dist_coeffs).items()}
    fx, fy, cx, cy, skew = K[0, 0], K[1, 1], K[0, 2], K[1, 2], K[0, 1]
    yd = (points[..., 1] - cy) / fy
    xd = (points[..., 0] - cx - skew * yd) / fx
    x, y = xd, yd
    for _ in range(num_iters):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        inv_radial = (1.0 + d["k4"] * r2 + d["k5"] * r4 + d["k6"] * r6) / (
            1.0 + d["k1"] * r2 + d["k2"] * r4 + d["k3"] * r6
        )
        dx = 2.0 * d["p1"] * x * y + d["p2"] * (r2 + 2.0 * x * x) + d["s1"] * r2 + d["s2"] * r4
        dy = d["p1"] * (r2 + 2.0 * y * y) + 2.0 * d["p2"] * x * y + d["s3"] * r2 + d["s4"] * r4
        x, y = (xd - dx) * inv_radial, (yd - dy) * inv_radial
    return torch.stack([x, y], dim=-1)


# --------------------------------------------------------------------------- #
# calibration container
# --------------------------------------------------------------------------- #
@dataclass
class Camera:
    """One calibrated camera (Anipose TOML section); parameters are host
    numpy arrays, float64."""

    name: str
    matrix: np.ndarray  # (3, 3) intrinsics
    dist: np.ndarray  # distortion coefficients, OpenCV order
    rvec: np.ndarray  # (3,) rotation vector (world -> camera)
    tvec: np.ndarray  # (3,) translation
    size: tuple | None = None

    # aniposelib-compatible accessors
    def get_name(self) -> str:
        return self.name

    def get_rotation(self) -> np.ndarray:
        return self.rvec

    def get_translation(self) -> np.ndarray:
        return self.tvec

    def get_camera_matrix(self) -> np.ndarray:
        return self.matrix

    def get_distortions(self) -> np.ndarray:
        return self.dist

    def extrinsics(self) -> np.ndarray:
        """(3, 4) [R | t] world->camera matrix (host, float64)."""
        R = rodrigues(torch.as_tensor(np.asarray(self.rvec, dtype=np.float64).ravel())).numpy()
        t = np.asarray(self.tvec, dtype=np.float64).reshape(3, 1)
        return np.concatenate([R, t], axis=1)

    def projection_fn(self, device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32) -> Callable:
        return make_projection_fn(self.rvec, self.tvec, self.matrix, self.dist, device, dtype)

    def undistort(self, points: torch.Tensor) -> torch.Tensor:
        return undistort_points(points, self.matrix, self.dist)


class CameraGroup:
    """A set of calibrated cameras with batched triangulation."""

    def __init__(self, cameras: list[Camera], metadata: dict | None = None):
        self.cameras = cameras
        self.metadata = metadata or {}

    @classmethod
    def load(cls, path: str) -> "CameraGroup":
        """Parse an Anipose-style calibration TOML: one ``[cam_*]`` section
        per camera (name, size, matrix, distortions, rotation as a vector or
        a 3 x 3 matrix, translation) and an optional ``[metadata]``."""
        with open(path, "rb") as f:
            data = tomllib.load(f)
        cameras = []
        for key in sorted(k for k in data if k.startswith("cam")):
            sec = data[key]
            rot = np.asarray(sec["rotation"], dtype=np.float64)
            rvec = inverse_rodrigues(rot) if rot.shape == (3, 3) else rot.ravel()
            cameras.append(
                Camera(
                    name=str(sec.get("name", key)),
                    matrix=np.asarray(sec["matrix"], dtype=np.float64),
                    dist=np.asarray(sec["distortions"], dtype=np.float64).ravel(),
                    rvec=rvec,
                    tvec=np.asarray(sec["translation"], dtype=np.float64).ravel(),
                    size=tuple(sec["size"]) if "size" in sec else None,
                )
            )
        return cls(cameras, metadata=data.get("metadata", {}))

    def triangulate(self, points, undistort: bool = True, device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.float32, **_ignored) -> np.ndarray:
        """Batched DLT triangulation: (C, N, 2) pixel points -> (N, 3) host
        array, computed in ``dtype`` on ``device``. Points with NaN in any
        coordinate are dropped per camera; rows with fewer than 2 valid
        views come back NaN (aniposelib.triangulate semantics)."""
        pts = _as(points, device=device, dtype=dtype)
        if undistort:
            pts = torch.stack([cam.undistort(pts[c]) for c, cam in enumerate(self.cameras)])
        extr = _as(np.stack([cam.extrinsics() for cam in self.cameras]), pts)
        return triangulate_dlt(pts, extr).cpu().numpy()


def project_multiview(rvecs, tvecs, Ks, dists, x: torch.Tensor) -> torch.Tensor:
    """Multi-view projector with explicit parameters: world points ``x``
    (..., 3) -> concatenated pixels (..., 2C) in camera order. rvecs and
    tvecs (C, 3), Ks (C, 3, 3) and dists (C, 14) are taken to ``x``'s device
    and dtype; the rotations are computed there."""
    return _concat_views(rodrigues(_as(rvecs, x)), _as(tvecs, x), _as(Ks, x), _as(dists, x), x)


def multiview_projection(Rs: torch.Tensor, tvecs: torch.Tensor, Ks: torch.Tensor,
                         dists: torch.Tensor) -> Callable:
    """The projector ``(..., 3) -> (..., 2C)`` of C cameras given by rotation
    matrices Rs (C, 3, 3), translations (C, 3), intrinsics Ks (C, 3, 3) and
    padded distortions (C, 14), tensors of one device and dtype."""
    return functools.partial(_concat_views, Rs, tvecs, Ks, dists)


def make_projection_from_camgroup(camgroup: CameraGroup, device: str | torch.device = "cuda",
                                  dtype: torch.dtype = torch.float32):
    """Combined multi-view projector ``h_fn: (..., 3) -> (..., 2C)`` plus
    per-camera heads ``(..., 3) -> (..., 2)``, for use as the EKF emission.

    ``h_fn`` closes over the cameras' parameters as ``dtype`` tensors on
    ``device``, the rotation matrices computed there once."""
    rvecs = np.stack([np.asarray(c.rvec, dtype=np.float64).ravel() for c in camgroup.cameras])
    tvecs = np.stack([np.asarray(c.tvec, dtype=np.float64).ravel() for c in camgroup.cameras])
    Ks, dists, _ = stack_camera_params(camgroup)
    params = [_as(a, device=device, dtype=dtype) for a in (rvecs, tvecs, Ks, dists)]
    h_fn = multiview_projection(rodrigues(params[0]), *params[1:])
    h_cams = [cam.projection_fn(device, dtype) for cam in camgroup.cameras]
    return h_fn, h_cams


def stack_camera_params(camgroup: CameraGroup):
    """A camera group's parameters as fixed-shape host arrays, so the
    per-camera geometry runs batched over the camera axis.

    Returns (Ks (C, 3, 3), dists (C, 14) zero-padded, extr (C, 3, 4))."""
    Ks = np.stack([np.asarray(c.matrix, dtype=np.float64) for c in camgroup.cameras])
    dists = np.stack([_pad14(c.dist) for c in camgroup.cameras])
    extr = np.stack([c.extrinsics() for c in camgroup.cameras])
    return Ks, dists, extr


def project_point(pt: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                  K: torch.Tensor, dist14: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> pixels (..., 2) with one camera's explicit
    parameters: rotation matrix R (3, 3), t (3,), K (3, 3), dist14 (14,)."""
    return _project_cameras(R[None], t[None], K[None], dist14[None], pt)[..., 0, :]
