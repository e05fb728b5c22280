"""Host-side utilities: data I/O, frame cropping, device selection."""

from __future__ import annotations

import torch

from eks_tpu_torch.utils.frames import build_R_from_vars, center_predictions, crop_frames, crop_R
from eks_tpu_torch.utils.io import (
    convert_lp_dlc,
    convert_slp_dlc,
    dlc_frame,
    format_data,
    get_keypoint_names,
    make_dlc_pandas_index,
    pull_outputs,
    read_slp_predictions,
    save_dlc_csv,
)

__all__ = [
    "build_R_from_vars",
    "center_predictions",
    "convert_lp_dlc",
    "convert_slp_dlc",
    "crop_frames",
    "crop_R",
    "dlc_frame",
    "format_data",
    "get_keypoint_names",
    "make_dlc_pandas_index",
    "pull_outputs",
    "read_slp_predictions",
    "resolve_device",
    "save_dlc_csv",
]


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. A CUDA request without a visible
    card raises: the port never carries on on the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return device
