"""Type-conversion compute ops (counterpart of ``cvgpuspeedup_tpu/ops/cast.py``)."""

from __future__ import annotations

import torch

from ..graph import ComputeOp, op, static_field
from ..utils import dtypes as dt


@op
class SaturateCast(ComputeOp):
    """OpenCV ``saturate_cast``: round half-to-even, then clamp (NaN to 0),
    for integer destinations; plain convert for float destinations."""

    dst: torch.dtype = static_field()

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return dt.saturate_cast(x, self.dst)


@op
class Cast(ComputeOp):
    """The reference's ``astype``: a float truncates, then saturates (NaN to
    0); an integer keeps its low bits (``utils.dtypes.cast``)."""

    dst: torch.dtype = static_field()

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return dt.cast(x, self.dst)
