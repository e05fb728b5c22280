"""Camera geometry: Rodrigues, projection/distortion, calibration, DLT."""

from eks_tpu_torch.geometry.camera import (
    Camera,
    CameraGroup,
    inverse_rodrigues,
    make_projection_fn,
    make_projection_from_camgroup,
    parse_dist,
    project_point,
    rodrigues,
    stack_camera_params,
    undistort_points,
)
from eks_tpu_torch.geometry.triangulate import triangulate_dlt

__all__ = [
    "Camera",
    "CameraGroup",
    "inverse_rodrigues",
    "make_projection_fn",
    "make_projection_from_camgroup",
    "parse_dist",
    "project_point",
    "rodrigues",
    "stack_camera_params",
    "undistort_points",
    "triangulate_dlt",
]
