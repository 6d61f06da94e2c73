"""Type-conversion compute ops (counterpart of ``cvgpuspeedup_tpu/ops/cast.py``).

A destination of 64 bits is its canonical dtype (``utils.dtypes``), as in
the reference, which runs with 64-bit values off: a ``Cast`` to int64 is one
to int32, either cast to float64 one to float32. A ``SaturateCast`` to int64
or uint64 raises ``OverflowError``: its bounds do not fit the 32-bit
integer that holds them, which is where the reference's jitted call raises."""

from __future__ import annotations

import torch

from ..graph import ComputeOp, op, static_field
from ..utils import dtypes as dt


def saturate_target(dst) -> torch.dtype:
    """The canonical dtype of a saturating conversion into ``dst``; raises
    ``OverflowError`` for int64 and uint64, whose bounds int32 cannot
    hold."""
    d = dt.to_torch_dtype(dst)
    if d in (torch.int64, torch.uint64):
        raise OverflowError(f"a saturating cast to {d}: its bounds do not fit int32, which "
                            "holds 64-bit integers")
    return dt.canonical_dtype(d)


@op
class SaturateCast(ComputeOp):
    """OpenCV ``saturate_cast``: round half-to-even, then clamp (NaN to 0),
    for integer destinations; plain convert for float destinations."""

    dst: torch.dtype = static_field()

    def __post_init__(self):
        object.__setattr__(self, "dst", saturate_target(self.dst))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return dt.saturate_cast(x, self.dst)


@op
class Cast(ComputeOp):
    """The reference's ``astype``: a float truncates, then saturates (NaN to
    0); an integer keeps its low bits (``utils.dtypes.cast``)."""

    dst: torch.dtype = static_field()

    def __post_init__(self):
        object.__setattr__(self, "dst", dt.canonical_dtype(dt.to_torch_dtype(self.dst)))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return dt.cast(x, self.dst)
