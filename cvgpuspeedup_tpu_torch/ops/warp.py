"""Affine and perspective warp read ops.

Counterpart of ``cvgpuspeedup_tpu/ops/warp.py``: ``fk::Warping`` with the
**inverse** (destination -> source) map as its parameter. The factory
inverts the user's forward matrix on the host in float64
(:func:`invert_affine`, :func:`invert_perspective`) and stores the inverse
twice: as per-axis float32 coordinate terms (:func:`decompose_inverse_map`),
which the eager version adds, and as the float32 coefficients themselves,
from which the CUDA kernel recomputes the same terms bit for bit.

Sampling is INTER_LINEAR with a constant border: a tap outside the source
reads the per-channel border value (:func:`sample_constant_border`). The
output is float32; append a cast for another type.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..graph import ReadOp, op, static_field
from ..types import Size, WarpType
from ..utils import dtypes as dt


def invert_affine(m) -> np.ndarray:
    """``cv::invertAffineTransform`` of a 2x3 matrix, float64 on the host."""
    m = np.asarray(m, dtype=np.float64)
    a_inv = np.linalg.inv(m[:, :2])
    b_inv = -a_inv @ m[:, 2]
    return np.concatenate([a_inv, b_inv[:, None]], axis=1)


def invert_perspective(m) -> np.ndarray:
    """``cv::Mat::inv`` of a 3x3 homography, float64 on the host."""
    return np.linalg.inv(np.asarray(m, dtype=np.float64))


def tap_axis(t0f: torch.Tensor, length: int):
    """``((valid0, index0), (valid1, index1))`` of the taps ``t0`` and
    ``t0 + 1`` on an axis of ``length``, from the floored coordinate ``t0f``.
    An invalid tap (NaN included) has index 0; the caller replaces it."""
    v0 = (t0f >= 0) & (t0f < length)
    v1 = (t0f >= -1) & (t0f < length - 1)
    i0 = torch.where(v0, t0f, 0.0).to(torch.int64)
    i1 = torch.where(v1, t0f + 1, 0.0).to(torch.int64)
    return (v0, i0), (v1, i1)


def sample_constant_border(src: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                           border: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of a float32 (H, W, C) source at float coordinates
    (sx, sy) of shape (h, w); a tap outside the source reads ``border`` (C,).

    The reference's op order: floor, the fractions, four taps with the
    out-of-source ones replaced (a select, which keeps a subnormal), the
    horizontal lerps, then the vertical, each float32 op with subnormals
    flushed (``utils.dtypes.flush_subnormal``).
    Validity is decided on the floored coordinate in float, before any
    integer conversion, so a coordinate far outside int32 reads the border
    like any other outside tap (the reference's int32 taps, saturated or
    wrapped, are out of range there too)."""
    h, w = src.shape[0], src.shape[1]
    x0f = dt.ffloor(sx)
    y0f = dt.ffloor(sy)
    wx = dt.fsub(sx, x0f)[..., None]
    wy = dt.fsub(sy, y0f)[..., None]

    xs, ys = tap_axis(x0f, w), tap_axis(y0f, h)

    def tap(xa, ya):
        (vx, ix), (vy, iy) = xa, ya
        return torch.where((vx & vy)[..., None], src[iy, ix], border)

    v00 = tap(xs[0], ys[0])
    v01 = tap(xs[1], ys[0])
    v10 = tap(xs[0], ys[1])
    v11 = tap(xs[1], ys[1])
    return dt.lerp(dt.lerp(v00, v01, wx), dt.lerp(v10, v11, wx), wy)


def decompose_inverse_map(inv, dsize: Size):
    """The inverse map as per-axis float32 coordinate terms (OpenCV's
    adelta/bdelta split): ``sx(y, x) = col_x[x] + row_x[y]``, the same for
    ``sy`` and, for a perspective map, the denominator ``col_w + row_w``.

    The coefficients are rounded to float32 first; each product and sum is
    then one float32 operation, so a kernel recomputes any term bit for bit
    from the coefficients. Returns numpy arrays, ``None`` for ``col_w`` and
    ``row_w`` of an affine map."""
    inv = np.asarray(inv, np.float64)
    c = inv.astype(np.float32)
    xs = np.arange(dsize.width, dtype=np.float32)
    ys = np.arange(dsize.height, dtype=np.float32)
    perspective = inv.shape[0] == 3
    return {
        "col_x": c[0, 0] * xs,
        "row_x": c[0, 1] * ys + c[0, 2],
        "col_y": c[1, 0] * xs,
        "row_y": c[1, 1] * ys + c[1, 2],
        "col_w": c[2, 0] * xs if perspective else None,
        "row_w": c[2, 1] * ys + c[2, 2] if perspective else None,
    }


@op
class WarpRead(ReadOp):
    """Warp a source read through an inverse map, held as the per-axis
    coordinate terms of :func:`decompose_inverse_map` and as its float32
    coefficients (6 or 9, row-major)."""

    source: ReadOp
    col_x: torch.Tensor  # (W,)
    row_x: torch.Tensor  # (H,)
    col_y: torch.Tensor
    row_y: torch.Tensor
    col_w: object        # (W,), or None for an affine map
    row_w: object
    coeffs: torch.Tensor
    default: torch.Tensor  # per-channel border value, float32
    dsize: Size = static_field()
    warp_type: WarpType = static_field()

    def coordinates(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The source coordinates ``(sx, sy)`` of every output pixel, each
        (H, W) float32, from the term vectors."""

        def term(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        sx = dt.fadd(term(self.col_x)[None, :], term(self.row_x)[:, None])
        sy = dt.fadd(term(self.col_y)[None, :], term(self.row_y)[:, None])
        if self.warp_type == WarpType.PERSPECTIVE:
            den = dt.fadd(term(self.col_w)[None, :], term(self.row_w)[:, None])
            den = torch.where(den == 0.0, 1.0, den)
            sx = dt.fdiv(sx, den)
            sy = dt.fdiv(sy, den)
        return sx, sy

    def lower(self) -> torch.Tensor:
        src = self.source.lower().to(torch.float32)
        sx, sy = self.coordinates(src.device)
        border = torch.as_tensor(self.default, dtype=torch.float32, device=src.device)
        return sample_constant_border(src, sx, sy, border)
