"""Border-extension read op.

Counterpart of ``cvgpuspeedup_tpu/ops/border.py``: a read that extends its
source with virtual border pixels, as ``cv2.copyMakeBorder`` does:

====================  =========================================
mode                  edge behaviour for a row ``abcdefgh``
====================  =========================================
CONSTANT              ``iiii | abcdefgh | iiii`` (value i)
REPLICATE             ``aaaa | abcdefgh | hhhh``
REFLECT               ``dcba | abcdefgh | hgfe``
REFLECT_101           ``edcb | abcdefgh | gfed``
WRAP                  ``efgh | abcdefgh | abcd``
====================  =========================================

The reference pads with ``jnp.pad``, which follows ``numpy.pad``: a border
wider than the source repeats the pattern (``torch.nn.functional.pad``
refuses that for ``reflect``). So each axis gets an index map built on the
host with ``numpy.pad`` of the source's indices, and the read is a gather.
On the card the pointwise kernel (``csrc/pointwise.cuh::fold_index``) does
the same folds as index arithmetic; the resampling kernels refuse a
``BorderRead`` source.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import ReadOp, op, static_field
from ..types import BorderMode
from ..utils import dtypes as dt

__all__ = ["BorderMode", "BorderRead", "border_index"]

_PAD_MODE = {
    BorderMode.REPLICATE: "edge",
    BorderMode.REFLECT: "symmetric",
    BorderMode.REFLECT_101: "reflect",
    BorderMode.WRAP: "wrap",
}


def border_index(length: int, before: int, after: int, mode: BorderMode) -> np.ndarray:
    """The source index each position of a padded axis reads, by
    ``numpy.pad``'s rule for ``mode``; CONSTANT reads the nearest edge (the
    caller replaces the border with its value)."""
    pad_mode = _PAD_MODE.get(mode, "edge")
    return np.pad(np.arange(length, dtype=np.int64), (before, after), mode=pad_mode)


@op
class BorderRead(ReadOp):
    """``source`` with ``top``/``bottom``/``left``/``right`` border pixels;
    ``value`` (a scalar or one per channel, cast to the source's dtype) fills
    the CONSTANT border."""

    source: ReadOp
    value: torch.Tensor
    top: int = static_field(default=0)
    bottom: int = static_field(default=0)
    left: int = static_field(default=0)
    right: int = static_field(default=0)
    mode: BorderMode = static_field(default=BorderMode.REFLECT_101)

    @property
    def batched(self) -> bool:
        return self.source.batched

    def lower(self) -> torch.Tensor:
        x = self.source.lower()
        dev = x.device
        h, w = int(x.shape[-3]), int(x.shape[-2])
        rows = border_index(h, self.top, self.bottom, self.mode)
        cols = border_index(w, self.left, self.right, self.mode)
        out = dt.gather(x, lambda s: s.index_select(s.ndim - 3, torch.from_numpy(rows).to(dev))
                        .index_select(s.ndim - 2, torch.from_numpy(cols).to(dev)))
        if self.mode != BorderMode.CONSTANT:
            return out
        val = dt.cast(torch.as_tensor(self.value, device=dev), x.dtype).reshape(-1)
        r = torch.arange(out.shape[-3], device=dev)
        c = torch.arange(out.shape[-2], device=dev)
        inside = (((r >= self.top) & (r < self.top + h))[:, None, None]
                  & ((c >= self.left) & (c < self.left + w))[None, :, None])
        if x.dtype == torch.uint16:  # torch.where has no uint16 kernel on CUDA: same bits as int16
            return torch.where(inside, out.view(torch.int16), val.view(torch.int16)).view(x.dtype)
        return torch.where(inside, out, val)
