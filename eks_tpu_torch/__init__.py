"""eks-tpu-torch: the Ensemble Kalman Smoother in PyTorch and CUDA.

The port of ``eks_tpu`` (JAX, Pallas kernels for the TPU) to PyTorch on an
NVIDIA Hopper card, with hand-written CUDA kernels in ``csrc/``. Entry points
run on the card unless the caller passes ``device="cpu"``, which runs the
plain PyTorch version of every kernel.

Precision: everything is float32, and matrix products and convolutions stay
full float32 on the card. TF32 is switched off for both here, once, at
import; it is the counterpart of the JAX package's ``highest_precision``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from eks_tpu_torch.marker_array import MarkerArray  # noqa: E402
from eks_tpu_torch.models.ibl_paw import fit_eks_multicam_ibl_paw  # noqa: E402
from eks_tpu_torch.models.ibl_pupil import (  # noqa: E402
    ensemble_kalman_smoother_ibl_pupil,
    ensemble_kalman_smoother_ibl_pupil_sessions,
    fit_eks_pupil,
    fit_eks_pupil_sessions,
)
from eks_tpu_torch.models.multicam import (  # noqa: E402
    ensemble_kalman_smoother_multicam,
    fit_eks_mirrored_multicam,
    fit_eks_multicam,
)
from eks_tpu_torch.models.singlecam import (  # noqa: E402
    ensemble_kalman_smoother_singlecam,
    ensemble_kalman_smoother_singlecam_sessions,
    fit_eks_singlecam,
    fit_eks_singlecam_sessions,
)

__all__ = [
    "MarkerArray",
    "ensemble_kalman_smoother_ibl_pupil",
    "ensemble_kalman_smoother_ibl_pupil_sessions",
    "ensemble_kalman_smoother_multicam",
    "ensemble_kalman_smoother_singlecam",
    "ensemble_kalman_smoother_singlecam_sessions",
    "fit_eks_mirrored_multicam",
    "fit_eks_multicam",
    "fit_eks_multicam_ibl_paw",
    "fit_eks_pupil",
    "fit_eks_pupil_sessions",
    "fit_eks_singlecam",
    "fit_eks_singlecam_sessions",
]
