"""Bilinear resize read ops: one frame (``ResizeRead``) and the flagship
batched crop-resize (``BatchResizeRead``).

Counterpart of ``cvgpuspeedup_tpu/ops/resize.py``. The coordinate helpers
here are the port's single source of truth for the bilinear numerics.
``csrc/batch_resize.cu`` and ``csrc/frame_resize.cu`` repeat the same
arithmetic per pixel, operation for operation:

- rational source coordinates ``num = (2q+1)*src - dst``, ``den = 2*dst``,
  with a *floor* division for the left tap and one correctly rounded f32
  division for the weight (:func:`axis_lerp`, :func:`axis_taps`);
- the f32 division and truncating int conversion of the letterbox fit
  (:func:`letterbox_geometry`);
- the lerp association of :func:`bilinear_sample`: horizontal first, then
  vertical, each as ``a*(1-w) + b*w``, nothing contracted into an FMA, and
  float32 subnormals flushed at every op (``utils.dtypes.flush_subnormal``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..graph import FusedRead, ReadOp, op, static_field
from ..types import AspectRatio, InterpolationType, Size
from ..utils import dtypes as dt
from ..utils.dtypes import as_device_tensor
from .nv12 import ConvertYUVToRGB, ReadYUV


def axis_lerp(q, src_len, dst_len):
    """Per-output-index source taps and weight for one axis, OpenCV
    INTER_LINEAR semantics on exact rational coordinates::

        s = ((2q + 1) * src - dst) / (2 * dst)

    ``i0 = floor(num / den)`` is exact; the weight ``(num - i0*den) / den``
    is one correctly rounded f32 division of exact integers. The weight is
    forced to 0 when the left tap clamps at either edge, as ``cv::resize``
    does.

    ``q``: int output indices (may be offset for letterboxing);
    ``src_len``/``dst_len``: ints or int tensors broadcastable with ``q``.
    Returns ``(i0, i1, w)``: int32 taps and f32 weights shaped like ``q``.
    """
    q = torch.as_tensor(q, dtype=torch.int32)
    src_len = torch.as_tensor(src_len, dtype=torch.int32, device=q.device)
    dst_len = torch.as_tensor(dst_len, dtype=torch.int32, device=q.device)
    num = (2 * q + 1) * src_len - dst_len
    den = 2 * dst_len
    i0 = torch.div(num, den, rounding_mode="floor")
    w = (num - i0 * den).to(torch.float32) / den.to(torch.float32)
    w = torch.where(i0 < 0, 0.0, w)
    i0 = torch.clamp_min(i0, 0)
    w = torch.where(i0 >= src_len - 1, 0.0, w)
    i0 = torch.minimum(i0, src_len - 1)
    i1 = torch.minimum(i0 + 1, src_len - 1)
    return i0, i1, w


def letterbox_geometry(crop_w, crop_h, dsize: Size, mode: AspectRatio):
    """Target sub-rectangle ``(new_w, new_h, ox, oy)`` for one crop size, or
    for a tensor of them.

    Scale to the target height and truncate the scaled width; if it
    overflows, scale to the target width instead. Offsets centre the
    sub-rect, except PRESERVE_AR_LEFT, which anchors it at (0, 0).
    PRESERVE_AR_RN_EVEN rounds the fitted dims up to even. Returns int32
    tensors shaped like ``crop_w``.
    """
    dst_w, dst_h = dsize.width, dsize.height
    cw = torch.as_tensor(crop_w).to(torch.float32)
    ch = torch.as_tensor(crop_h).to(device=cw.device, dtype=torch.float32)
    if mode == AspectRatio.IGNORE_AR:
        zero = torch.zeros(cw.shape, dtype=torch.int32, device=cw.device)
        return zero + dst_w, zero + dst_h, zero, zero
    scale = torch.tensor(dst_h, dtype=torch.float32, device=cw.device) / ch
    new_w = (scale * cw).to(torch.int32)  # trunc, as static_cast<int>
    overflow = new_w > dst_w
    scale2 = torch.tensor(dst_w, dtype=torch.float32, device=cw.device) / cw
    new_h2 = (scale2 * ch).to(torch.int32)
    new_w = torch.where(overflow, dst_w, new_w)
    new_h = torch.where(overflow, new_h2, dst_h)
    if mode == AspectRatio.PRESERVE_AR_RN_EVEN:
        new_w = torch.clamp_max(torch.div(new_w + 1, 2, rounding_mode="floor") * 2, dst_w)
        new_h = torch.clamp_max(torch.div(new_h + 1, 2, rounding_mode="floor") * 2, dst_h)
    if mode == AspectRatio.PRESERVE_AR_LEFT:
        ox = torch.zeros_like(new_w)
        oy = torch.zeros_like(new_h)
    else:
        ox = torch.div(dst_w - new_w, 2, rounding_mode="floor")
        oy = torch.div(dst_h - new_h, 2, rounding_mode="floor")
    return new_w, new_h, ox, oy


def bilinear_sample(v00, v01, v10, v11, wx, wy):
    """Bilinear lerp of four f32 corner values: horizontal first, then
    vertical, each as ``a*(1-w) + b*w`` (``utils.dtypes.lerp``: every
    product and sum one float32 op with subnormals flushed). The association
    is fixed so that the eager version and the CUDA kernel agree bit for
    bit."""
    return dt.lerp(dt.lerp(v00, v01, wx), dt.lerp(v10, v11, wx), wy)


# ---------------------------------------------------------------------------
# static geometry: one frame, taps known on the host
# ---------------------------------------------------------------------------

#: the reference resizes an axis by strided slices ("polyphase") when both
#: axes have at most this many phases, and by gathers or dense matmuls
#: otherwise (``cvgpuspeedup_tpu/ops/resize.py:172``)
MAX_PHASES = 32


def keeps_edge_weight(src_h: int, src_w: int, dsize: Size) -> bool:
    """Which edge rule the reference applies to a static resize.

    With at most :data:`MAX_PHASES` phases on both axes it resizes by
    strided slices of an edge-padded source: a tap past an edge reads the
    edge pixel and keeps its weight, ``v*(1-w) + v*w``, and a weight of 0
    keeps the source value itself. Otherwise it gathers (or multiplies by
    dense matrices with the same taps), which zero the weight at a clamped
    edge, as :func:`axis_lerp` does. The two differ by up to 1 ulp at the
    edges, which can flip a .5 tie of a uint8 output, so the port follows
    the same rule.
    The NV12 plane-space read follows it too: its half-resolution plan
    exists only within the phase cap, and past it the reference gathers.
    """
    qx = dsize.width // math.gcd(src_w, dsize.width)
    qy = dsize.height // math.gcd(src_h, dsize.height)
    return qx <= MAX_PHASES and qy <= MAX_PHASES


def axis_taps(src_len: int, dst_len: int, keep_edge: bool):
    """``(i0, i1, w)`` of one axis of a static resize: int64 taps inside
    ``[0, src_len - 1]`` and float32 weights, by the rule
    :func:`keeps_edge_weight` chose. The numpy form of :func:`axis_lerp`,
    computed once per geometry on the host."""
    q = np.arange(dst_len, dtype=np.int64)
    num = (2 * q + 1) * src_len - dst_len
    den = 2 * dst_len
    i0 = num // den
    w = (num - i0 * den).astype(np.float32) / np.float32(den)
    if keep_edge:
        return np.clip(i0, 0, src_len - 1), np.clip(i0 + 1, 0, src_len - 1), w
    w = np.where((i0 < 0) | (i0 >= src_len - 1), np.float32(0.0), w)
    i0 = np.clip(i0, 0, src_len - 1)
    return i0, np.minimum(i0 + 1, src_len - 1), w


def half_taps(i0, i1):
    """Chroma taps of an NV12 read: the half-resolution pair under the
    full-resolution taps (``t // 2``). On clamped taps this equals the
    reference's ``(i0 // 2, (i0 + 1) // 2)`` of the unclamped tap, clamped
    into the half plane (``ops/resize.py:260-290``), since the width is even."""
    return i0 // 2, i1 // 2


def sample_frame(src, taps_x, taps_y, keep_edge: bool) -> torch.Tensor:
    """One channel-last (H, W, C) source resized to (len(taps_y),
    len(taps_x), C) float32. ``taps_x``/``taps_y`` are ``(i0, i1, w)``
    tensors on the source's device. Horizontal lerp first, then vertical;
    with ``keep_edge`` a weight of 0 takes the first tap's value itself, a
    select that keeps a subnormal, as the reference's strided slice does."""
    x0, x1, wx = taps_x
    y0, y1, wy = taps_y
    rows0 = dt.gather(src, lambda s: s.index_select(0, y0))
    rows1 = dt.gather(src, lambda s: s.index_select(0, y1))
    wx = wx[None, :, None]
    wy = wy[:, None, None]

    def lerp(a, b, w):
        a = a.to(torch.float32)
        v = dt.lerp(a, b.to(torch.float32), w)
        return torch.where(w == 0.0, a, v) if keep_edge else v

    def cols(rows, x):
        return dt.gather(rows, lambda s: s.index_select(1, x))

    h0 = lerp(cols(rows0, x0), cols(rows0, x1), wx)
    h1 = lerp(cols(rows1, x0), cols(rows1, x1), wx)
    return lerp(h0, h1, wy)


def _device_taps(taps, device):
    i0, i1, w = taps
    return (as_device_tensor(i0, device, canonical=False),
            as_device_tensor(i1, device, canonical=False), as_device_tensor(w, device))


@op
class ResizeRead(ReadOp):
    """Single-frame bilinear resize over any read op
    (``cvGS::resize<T, INTER_LINEAR>(src, dsize)``). Emits float32.

    The geometry is static: per-axis tap tables are built on the host
    (:func:`axis_taps`), with the edge rule the reference's lowering of the
    same geometry uses (:func:`keeps_edge_weight`), so the output equals the
    reference's bit for bit.
    """

    source: ReadOp
    dsize: Size = static_field()
    interp: InterpolationType = static_field(default=InterpolationType.INTER_LINEAR)

    def _commuted_source(self):
        """``(read_yuv, conversion)`` when the source is an NV12 read fused
        with one float YUV->RGB conversion, else None. The conversion is
        affine and the bilinear weights sum to 1, so it commutes with the
        resize: it is applied to destination pixels only, and each plane is
        resized at its native resolution."""
        src = self.source
        if not isinstance(src, FusedRead) or len(src.chain) != 1:
            return None
        conv = src.chain[0]
        if not isinstance(conv, ConvertYUVToRGB) or not isinstance(src.read, ReadYUV):
            return None
        if not dt.is_float(conv.out_dtype):
            return None  # an integer output saturates: not affine
        return src.read, conv

    def lower(self) -> torch.Tensor:
        dst_w, dst_h = self.dsize.width, self.dsize.height
        commuted = self._commuted_source()
        if commuted is not None:
            readop, conv = commuted
            y, uv = readop.lower_native_planes()
            src_h, src_w = int(y.shape[0]), int(y.shape[1])
            keep = keeps_edge_weight(src_h, src_w, self.dsize)
            tx, ty = axis_taps(src_w, dst_w, keep), axis_taps(src_h, dst_h, keep)
            cx = half_taps(*tx[:2]) + (tx[2],)
            cy = half_taps(*ty[:2]) + (ty[2],)
            dev = y.device
            y_r = sample_frame(y[..., None], _device_taps(tx, dev), _device_taps(ty, dev), keep)
            uv_r = sample_frame(uv, _device_taps(cx, dev), _device_taps(cy, dev), keep)
            return conv.apply(torch.cat([y_r, uv_r], dim=-1))
        src = self.source.lower()
        if src.ndim != 3:
            raise ValueError("ResizeRead expects a single (H, W, C) source")
        src_h, src_w = int(src.shape[0]), int(src.shape[1])
        keep = keeps_edge_weight(src_h, src_w, self.dsize)
        return sample_frame(src, _device_taps(axis_taps(src_w, dst_w, keep), src.device),
                            _device_taps(axis_taps(src_h, dst_h, keep), src.device), keep)


def source_index(t, length: int):
    """Where a gather reads absolute source index ``t`` on an axis of
    ``length``, as the reference's indexing does: a negative index counts
    from the far end (``t + length``), then the index is clamped into
    ``[0, length - 1]``."""
    return torch.where(t < 0, t + length, t).clamp(0, length - 1)


def sample_batch(src, rects, dsize: Size, mode: AspectRatio, background,
                 used_planes=None, stack_mode: bool = False) -> torch.Tensor:
    """The N resized crops, channel-last (N, dstH, dstW, C) float32.

    ``src`` is one frame (H, W, C), or with ``stack_mode`` a stack
    (N, H, W, C); ``rects`` (N, 4) ``[x, y, w, h]``. Each tap is addressed
    by :func:`source_index`: a rect that hangs off the right or bottom edge
    repeats the edge pixel, one left of or above the frame reads from the
    far edge. Pixels outside the letterbox sub-rect, and every pixel of a
    plane ``z >= used_planes``, take ``background``.
    """
    dev = src.device
    dst_w, dst_h = dsize.width, dsize.height
    rects = rects.to(device=dev, dtype=torch.int32)
    x0, y0, w, h = rects.unbind(1)
    n = rects.shape[0]
    new_w, new_h, ox, oy = letterbox_geometry(w, h, dsize, mode)
    col = torch.arange(dst_w, dtype=torch.int32, device=dev)
    row = torch.arange(dst_h, dtype=torch.int32, device=dev)
    qx = col[None, :] - ox[:, None]
    qy = row[None, :] - oy[:, None]
    # a letterbox side of length 0 masks its whole axis; clamping its
    # divisor to 1 only keeps the integer division defined
    i0x, i1x, wx = axis_lerp(qx, w[:, None], new_w.clamp_min(1)[:, None])
    i0y, i1y, wy = axis_lerp(qy, h[:, None], new_h.clamp_min(1)[:, None])
    src_h, src_w = src.shape[-3], src.shape[-2]
    cx0 = source_index(x0[:, None] + i0x, src_w)[:, None, :]
    cx1 = source_index(x0[:, None] + i1x, src_w)[:, None, :]
    ry0 = source_index(y0[:, None] + i0y, src_h)[:, :, None]
    ry1 = source_index(y0[:, None] + i1y, src_h)[:, :, None]
    if stack_mode:
        z = torch.arange(n, device=dev)[:, None, None]

        def gather(r, c):
            return dt.gather(src, lambda s: s[z, r, c]).to(torch.float32)
    else:

        def gather(r, c):
            return dt.gather(src, lambda s: s[r, c]).to(torch.float32)

    val = bilinear_sample(
        gather(ry0, cx0), gather(ry0, cx1), gather(ry1, cx0), gather(ry1, cx1),
        wx[:, None, :, None], wy[:, :, None, None],
    )
    inside = (
        ((col[None, :] >= ox[:, None]) & (col[None, :] < (ox + new_w)[:, None]))[:, None, :, None]
        & ((row[None, :] >= oy[:, None]) & (row[None, :] < (oy + new_h)[:, None]))[:, :, None, None]
    )
    bg = torch.as_tensor(background, device=dev).to(torch.float32)
    val = torch.where(inside, val, bg)
    if used_planes is not None:
        used = torch.as_tensor(used_planes, device=dev).reshape(())
        z = torch.arange(n, device=dev).reshape(n, 1, 1, 1)
        val = torch.where(z < used, val, bg)
    return val


@op
class BatchResizeRead(ReadOp):
    """The flagship: N variable-geometry crops -> dsize in one pass.

    Exactly one of ``frame``/``stack`` is set:

    - *rect mode*: ``frame`` (H, W, C) + ``rects`` (N, 4) int32
      ``[x, y, w, h]``: N crops of one frame;
    - *stack mode*: ``stack`` (N, maxH, maxW, C) zero-padded stack + ``rects``
      with x=y=0 and each plane's true dims: N independent images.

    ``used_planes`` (runtime scalar) masks ragged batches: planes from it on
    emit ``background``, a per-channel float32 vector that also fills the
    letterbox borders of the PRESERVE_AR modes. Output: (N, dstH, dstW, C)
    float32. With ``packed_channels=C`` the source rows are channel
    interleaved, frame (H, W*C) or stack (N, H, W*C), as the reference
    package ingests host frames.
    """

    frame: Optional[torch.Tensor]
    stack: Optional[torch.Tensor]
    rects: torch.Tensor
    used_planes: Optional[torch.Tensor]
    background: torch.Tensor
    dsize: Size = static_field()
    aspect_ratio: AspectRatio = static_field(default=AspectRatio.IGNORE_AR)
    interp: InterpolationType = static_field(default=InterpolationType.INTER_LINEAR)
    packed_channels: int = static_field(default=0)

    batched = True

    @property
    def num_planes(self) -> int:
        return self.rects.shape[0]

    def source(self):
        """The logical source: frame (H, W, C) or stack (N, H, W, C)."""
        s = self.frame if self.frame is not None else self.stack
        if self.packed_channels:
            c = self.packed_channels
            s = s.reshape(s.shape[:-1] + (s.shape[-1] // c, c))
        return s

    def source_dims(self):
        """(src_h, src_w, nch) of the logical source plane."""
        s = self.frame if self.frame is not None else self.stack
        off = 0 if self.frame is not None else 1
        if self.packed_channels:
            c = self.packed_channels
            return int(s.shape[off]), int(s.shape[off + 1]) // c, c
        return int(s.shape[off]), int(s.shape[off + 1]), int(s.shape[-1])

    def lower(self) -> torch.Tensor:
        return sample_batch(
            self.source(), torch.as_tensor(self.rects), self.dsize, self.aspect_ratio,
            self.background, self.used_planes, stack_mode=self.stack is not None,
        )
