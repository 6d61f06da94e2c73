"""Crop read op.

Counterpart of ``cvgpuspeedup_tpu/ops/crop.py`` (``fk::Crop``): a crop
re-indexes its source and copies nothing. Its width and height are static
(they fix the output shape); its origin ``x``, ``y`` is a pair of leaves, so
a moved crop builds no plan.

The origin follows the reference's ``jax.lax.dynamic_slice``: a negative
start counts from the far edge, then the start is clamped so that the crop
lies inside the source. ``x = -3`` on a 12-px-wide source with a width of 5
reads columns 7..11 (-3 -> 9 -> 7); a start past the edge only clamps.
"""

from __future__ import annotations

import torch

from ..graph import ReadOp, op, static_field
from ..utils import dtypes as dt


def crop_start(start, length: int, size: int, device) -> torch.Tensor:
    """The first index a crop of ``size`` reads on an axis of ``length`` from
    the runtime ``start``, as ``dynamic_slice`` places it: negative counts
    from the far edge, then clamp to ``[0, length - size]``. A tensor, so a
    start on the device is never read back to the host."""
    if size > length:
        raise ValueError(f"crop of {size} does not fit an axis of {length}")
    s = torch.as_tensor(start, device=device).to(torch.int64).reshape(())
    s = torch.where(s < 0, s + length, s)
    return s.clamp(0, length - size)


@op
class CropRead(ReadOp):
    """A ``width`` x ``height`` window of a rank-3 (H, W, C) or rank-4
    (N, H, W, C) source; every plane of a batch is cropped alike."""

    source: ReadOp
    x: torch.Tensor  # runtime scalar
    y: torch.Tensor  # runtime scalar
    width: int = static_field()
    height: int = static_field()

    @property
    def batched(self) -> bool:
        return self.source.batched

    def lower(self) -> torch.Tensor:
        src = self.source.lower()
        if src.ndim not in (3, 4):
            raise ValueError(f"crop source must be rank 3 or 4, got {src.ndim}")
        dev = src.device
        h, w = int(src.shape[-3]), int(src.shape[-2])
        rows = crop_start(self.y, h, self.height, dev) + torch.arange(self.height, device=dev)
        cols = crop_start(self.x, w, self.width, dev) + torch.arange(self.width, device=dev)
        return dt.gather(src, lambda s: s.index_select(s.ndim - 3, rows)
                         .index_select(s.ndim - 2, cols))
