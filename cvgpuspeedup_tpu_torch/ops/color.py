"""Colour conversion and channel swizzle compute ops.

Counterpart of ``cvgpuspeedup_tpu/ops/color.py``. ``ColorConversion``
supports the reference's code list (``types.ColorConversionCode``): the 12
RGB/BGR/RGBA/BGRA permutations and the 4 reductions to gray.

Gray matches OpenCV bit for bit: integer images use OpenCV's 15-bit fixed
point, ``(R*9798 + G*19235 + B*3735 + 2^14) >> 15``; float images use
``R*0.299 + G*0.587 + B*0.114`` in their own dtype, each product and sum
rounded once (float32 with subnormals flushed, ``utils.dtypes.fmul``). An
appended alpha channel holds 1.0 for floats and the dtype's maximum for
integers, as ``cv::cvtColor`` fills it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..graph import ComputeOp, op, static_field
from ..types import ColorConversionCode
from ..utils import dtypes as dt

# (in_channels, out_channels, swizzle) or (in_channels, 1, "gray", (r, g, b)
# channel positions in the source)
_CODE_INFO = {
    ColorConversionCode.COLOR_BGR2BGRA: (3, 4, (0, 1, 2)),
    ColorConversionCode.COLOR_RGB2RGBA: (3, 4, (0, 1, 2)),
    ColorConversionCode.COLOR_BGRA2BGR: (4, 3, (0, 1, 2)),
    ColorConversionCode.COLOR_RGBA2RGB: (4, 3, (0, 1, 2)),
    ColorConversionCode.COLOR_BGR2RGBA: (3, 4, (2, 1, 0)),
    ColorConversionCode.COLOR_RGB2BGRA: (3, 4, (2, 1, 0)),
    ColorConversionCode.COLOR_BGRA2RGB: (4, 3, (2, 1, 0)),
    ColorConversionCode.COLOR_RGBA2BGR: (4, 3, (2, 1, 0)),
    ColorConversionCode.COLOR_BGR2RGB: (3, 3, (2, 1, 0)),
    ColorConversionCode.COLOR_RGB2BGR: (3, 3, (2, 1, 0)),
    ColorConversionCode.COLOR_BGRA2RGBA: (4, 4, (2, 1, 0, 3)),
    ColorConversionCode.COLOR_RGBA2BGRA: (4, 4, (2, 1, 0, 3)),
    ColorConversionCode.COLOR_RGB2GRAY: (3, 1, "gray", (0, 1, 2)),
    ColorConversionCode.COLOR_RGBA2GRAY: (4, 1, "gray", (0, 1, 2)),
    ColorConversionCode.COLOR_BGR2GRAY: (3, 1, "gray", (2, 1, 0)),
    ColorConversionCode.COLOR_BGRA2GRAY: (4, 1, "gray", (2, 1, 0)),
}

# OpenCV's fixed-point RGB->GRAY coefficients and shift (bit-exact against
# cv2); the row sums to 2^15, so a uint8 or uint16 sum fits in int32
_R2Y, _G2Y, _B2Y, _GRAY_SHIFT = 9798, 19235, 3735, 15
# float gray coefficients, as float32
GRAY_F32 = (0.299, 0.587, 0.114)


def alpha_fill(dtype):
    """The value of an appended alpha channel: 1.0 for floats, the maximum
    for integers."""
    return 1.0 if dt.is_float(dtype) else dt.max_value(dtype)


@op
class ColorConversion(ComputeOp):
    """``cvGS::cvtColor<code>`` (``fk::ColorConversion<code, I, O>``)."""

    code: ColorConversionCode = static_field()

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        info = _CODE_INFO[self.code]
        in_c, out_c = info[0], info[1]
        if x.shape[-1] != in_c:
            raise ValueError(f"{self.code.name} expects {in_c}-channel input, got {x.shape[-1]}")
        if info[2] == "gray":
            r, g, b = (x[..., i] for i in info[3])
            if dt.is_integer(x.dtype):
                acc = (r.to(torch.int32) * _R2Y + g.to(torch.int32) * _G2Y
                       + b.to(torch.int32) * _B2Y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
                gray = acc.to(x.dtype)
            else:
                c = [torch.tensor(v, dtype=x.dtype, device=x.device) for v in GRAY_F32]
                gray = dt.fadd(dt.fadd(dt.fmul(r, c[0]), dt.fmul(g, c[1])), dt.fmul(b, c[2]))
            return gray[..., None]
        swz = info[2]
        y = dt.gather(x, lambda s: s[..., list(swz)])
        if out_c == 4 and len(swz) == 3:
            alpha = torch.full(y.shape[:-1] + (1,), alpha_fill(x.dtype), dtype=x.dtype,
                               device=x.device)
            y = dt.gather(y, lambda s: torch.cat([s, alpha.view(s.dtype)], dim=-1))
        return y


@op
class VectorReorder(ComputeOp):
    """Channel swizzle (``fk::VectorReorder<T, i0, i1, ...>``)."""

    indices: Tuple[int, ...] = static_field()

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if len(self.indices) != x.shape[-1]:
            raise ValueError(f"VectorReorder{self.indices} on {x.shape[-1]}-channel image")
        return dt.gather(x, lambda s: s[..., list(self.indices)])
