"""NV12/NV21 read and YUV->RGB conversion.

Counterpart of ``cvgpuspeedup_tpu/ops/nv12.py``. An NV12 buffer is a
(H*3/2, W) uint8 array: H rows of luma, then H/2 rows of interleaved
half-resolution UV pairs (VU pairs for NV21). ``ReadYUV`` yields an
(H, W, 3) uint8 YUV image with each chroma pair repeated over its 2x2 luma
block (nearest upsampling).

Conversion (``ConvertYUVToRGB``), in float32, with Kg = 1 - Kr - Kb::

    full:     R = Y + 2(1-Kr)(V-128)
              G = Y - (2 Kb(1-Kb)/Kg)(U-128) - (2 Kr(1-Kr)/Kg)(V-128)
              B = Y + 2(1-Kb)(U-128)
    limited:  Y' = (255/219)(Y-16), U-128 and V-128 scaled by 255/224

bt601 Kr=0.299 Kb=0.114; bt709 Kr=0.2126 Kb=0.0722. The coefficients are
computed in double and rounded to float32 once; every float32 operation is
rounded on its own, in the reference's order, subnormals flushed
(``utils.dtypes.fmul``). Integer outputs are saturate-cast; ``alpha=True``
appends an alpha channel (the dtype's max, or 1.0 for floats).
"""

from __future__ import annotations

import torch

from ..graph import ComputeOp, ReadOp, op, static_field
from ..types import ColorRange, ColorStandard, PixelFormat
from ..utils import dtypes as dt
from .cast import saturate_target
from .color import alpha_fill

_KR_KB = {
    ColorStandard.BT601: (0.299, 0.114),
    ColorStandard.BT709: (0.2126, 0.0722),
}


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32))


#: the limited-range scales (255/219 for luma, 255/224 for chroma)
LIMITED_Y, LIMITED_C = _f32(255.0 / 219.0), _f32(255.0 / 224.0)


def conversion_coefficients(standard: ColorStandard):
    """``(rv, gu, gv, bu)``: the float32 coefficients of V in R, of U and V
    in G, and of U in B."""
    kr, kb = _KR_KB[standard]
    kg = 1.0 - kr - kb
    return (_f32(2.0 * (1.0 - kr)), _f32(2.0 * kb * (1.0 - kb) / kg),
            _f32(2.0 * kr * (1.0 - kr) / kg), _f32(2.0 * (1.0 - kb)))


@op
class ReadYUV(ReadOp):
    """Read an NV12/NV21 buffer as an (H, W, 3) uint8 YUV image."""

    buffer: torch.Tensor  # (H*3/2, W) uint8
    pixel_format: PixelFormat = static_field(default=PixelFormat.NV12)

    def lower_native_planes(self):
        """The Y plane (H, W) and the chroma pairs (H/2, W/2, 2) as (U, V),
        at their native resolutions."""
        buf = torch.as_tensor(self.buffer)
        if buf.ndim == 3 and buf.shape[-1] == 1:
            buf = buf[..., 0]
        total_rows, width = buf.shape
        height = (total_rows * 2) // 3
        if height % 2 or width % 2:
            raise ValueError(f"NV12 luma dims must be even, got {width}x{height}")
        y = buf[:height]
        uv = buf[height:].reshape(height // 2, width // 2, 2)
        if self.pixel_format == PixelFormat.NV21:
            uv = uv.flip(-1)
        return y, uv

    def lower(self) -> torch.Tensor:
        y, uv = self.lower_native_planes()
        uv_full = uv.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        return torch.stack([y, uv_full[..., 0], uv_full[..., 1]], dim=-1)


@op
class ConvertYUVToRGB(ComputeOp):
    """YUV -> RGB(A): a pointwise 3x3 matrix with offsets."""

    color_range: ColorRange = static_field(default=ColorRange.FULL)
    standard: ColorStandard = static_field(default=ColorStandard.BT601)
    alpha: bool = static_field(default=False)
    out_dtype: torch.dtype = static_field(default=torch.uint8)

    def __post_init__(self):  # a saturating conversion: ops.cast.saturate_target
        object.__setattr__(self, "out_dtype", saturate_target(self.out_dtype))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        rv, gu, gv, bu = conversion_coefficients(self.standard)
        y = x[..., 0].to(torch.float32)
        u = dt.fsub(x[..., 1].to(torch.float32), 128.0)
        v = dt.fsub(x[..., 2].to(torch.float32), 128.0)
        if self.color_range == ColorRange.LIMITED:
            y = dt.fmul(dt.fsub(y, 16.0), LIMITED_Y)
            u = dt.fmul(u, LIMITED_C)
            v = dt.fmul(v, LIMITED_C)
        r = dt.fadd(y, dt.fmul(rv, v))
        g = dt.fsub(dt.fsub(y, dt.fmul(gu, u)), dt.fmul(gv, v))
        b = dt.fadd(y, dt.fmul(bu, u))
        rgb = dt.saturate_cast(torch.stack([r, g, b], dim=-1), self.out_dtype)
        if self.alpha:
            a = torch.full(rgb.shape[:-1] + (1,), alpha_fill(self.out_dtype),
                           dtype=self.out_dtype, device=rgb.device)
            rgb = torch.cat([rgb, a], dim=-1)
        return rgb
