"""Working precision of a reference computation.

``FLOAT64`` is the reference. ``TF32`` is the control: the same code in
float32 with every result rounded to TF32 (8 exponent and 10 mantissa
bits, round to nearest even), the precision one step below the float32,
TF32-off arithmetic the configurations state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0xFFF + keep) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in this precision: cast, and for TF32 rounded (with the
        derivative of the unrounded value, for autograd)."""
        x = x.to(self.dtype)
        if self.name != "tf32":
            return x
        d = x.detach()
        return x + (round_tf32(d) - d)


FLOAT64 = Precision("float64", torch.float64)
TF32 = Precision("tf32", torch.float32)
