"""cvgpuspeedup_tpu_torch: the fused vision-preprocessing engine on PyTorch
and CUDA.

The port of ``cvgpuspeedup_tpu`` to one NVIDIA H100, module for module. The
public factory surface mirrors the reference package: factories build ops and
execute nothing; :func:`execute_operations` runs the whole chain: on a CUDA
device as one launch of a hand-written CUDA kernel (the batched crop-resize,
the full-frame resize, the warp or, for every read of one source pixel per
output pixel, the pointwise kernel), through the eager PyTorch version on the
CPU and for what no kernel takes. ``pipelines.presets`` holds the deployment
calls, ``interop.cv2_compat`` the OpenCV-typed shim, ``utils.frameloader`` the
native frame source. The package imports torch and never jax or cv2.

Example (the flagship 50-crop pipeline, the fused NV12 frame read, a batched
warp, a divergent batch and a ring of processed frames)::

    import numpy as np, torch
    import cvgpuspeedup_tpu_torch as cvgs

    frame = torch.from_numpy(frame_u8_hwc).cuda()
    out = cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=0.3),
        cvgs.subtract((3.2, 0.6, 11.8)),
        cvgs.divide((128.0, 128.0, 128.0)),
        cvgs.split_tensor(),            # planar (N, C, H, W)
    )
    rgb = cvgs.execute_operations(      # (3, 1080, 1920) float32
        cvgs.resize(cvgs.fuse(cvgs.read_yuv(nv12_buffer),
                              cvgs.convert_yuv_to_rgb(standard=cvgs.ColorStandard.BT709,
                                                      out_dtype=np.float32)),
                    cvgs.Size(1920, 1080)),
        cvgs.multiply(1 / 255.0),
        cvgs.split_tensor(),
    )
    warped = cvgs.execute_operations(   # (8, 3, 360, 640): 8 matrices, 1 launch
        cvgs.warp_batch([cvgs.image(frame)] * 8, matrices, cvgs.Size(640, 360),
                        used_planes=7, default=3.0),
        cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.split_tensor(),
    )
    mixed = cvgs.launch_divergent_batch(  # (8, 128, 64, 3) f32: 1 launch
        [1, 2, 1, 2, 1, 2, 1, 2],
        cvgs.build_operation_sequence(cvgs.resize_batch(frame, rects=rects8, dsize=cvgs.Size(64, 128)),
                                      cvgs.convert_to(np.float32, alpha=0.5), cvgs.write_tensor()),
        cvgs.build_operation_sequence(cvgs.image(planes_f32), cvgs.multiply(2.0), cvgs.write_tensor()),
    )
    ring = cvgs.CircularTensor(64, 128, 3, 32, device="cuda")   # (32, 3, 128, 64) f32
    ring.update(cvgs.resize(cvgs.image(frame), cvgs.Size(64, 128)),
                cvgs.convert_to(np.float32, alpha=1 / 255.0))
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .data.circular_tensor import CircularTensor
from .exec.executor import (Pipeline, build_operation_sequence, build_pipeline, clear_cache,
                            default_device, describe_backend, execute_operations, last_backend,
                            launch_divergent_batch, meta_lower)
from .graph import ComputeOp, FusedCompute, IOp, PendingReadOp, ReadOp, WriteOp, fuse
from .ops.arithmetic import Add, Div, Mul, StaticLoop, Sub
from .ops.border import BorderRead
from .ops.cast import Cast, SaturateCast, saturate_target
from .ops.color import ColorConversion, VectorReorder
from .ops.crop import CropRead
from .ops.memory import (BatchRead, CircularBatchRead, ImageRead, SplitWrite, TensorSplit,
                         TensorSplitPacked, TensorTSplit, TensorWrite, Write2D)
from .ops.nv12 import ConvertYUVToRGB, ReadYUV
from .ops.resize import BatchResizeRead, ResizeRead
from .ops.warp import WarpRead, decompose_inverse_map, invert_affine, invert_perspective
from .types import (AspectRatio, BorderMode, CircularTensorOrder, ColorConversionCode,
                    ColorPlanes, ColorRange, ColorStandard, InterpolationType, ParBackend,
                    PixelFormat, Point, Rect, Size, WarpType)
from .utils import dtypes as _dt
from .utils.dtypes import saturate_cast as saturate_cast_fn

__version__ = "0.1.0"

ArrayLike = Union[np.ndarray, torch.Tensor]


def _np_or_tensor(value, dtype):
    """Factory constants stay numpy (packed into one host-to-device copy per
    call); tensors pass through on their own device."""
    if isinstance(value, torch.Tensor):
        return _dt.canonicalize(value)
    return np.asarray(value, _dt.to_numpy_dtype(dtype))


def _host_or_tensor(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# pointwise factories
# ---------------------------------------------------------------------------


def convert_to(dst_dtype, alpha: Optional[float] = None, beta: Optional[float] = None) -> ComputeOp:
    """``cvGS::convertTo<I, O>([alpha[, beta]])``: OpenCV ``convertTo``
    semantics, ``saturate_cast<O>(src * alpha + beta)``, with the multiply
    and add computed in float when the output is integral. ``np.float64`` is
    float32's; ``np.int64`` raises ``OverflowError``, as the reference's call
    does (``ops.cast.saturate_target``)."""
    dst = saturate_target(dst_dtype)
    if alpha is None and beta is None:
        return SaturateCast(dst=dst)
    if alpha is None:
        alpha = 1.0
    stages: list = []
    if _dt.is_float(dst):
        stages.append(SaturateCast(dst=dst))
        stages.append(Mul(value=_np_or_tensor(alpha, dst)))
        if beta is not None:
            stages.append(Add(value=_np_or_tensor(beta, dst)))
    else:
        stages.append(Cast(dst=torch.float32))
        stages.append(Mul(value=_np_or_tensor(alpha, np.float32)))
        if beta is not None:
            stages.append(Add(value=_np_or_tensor(beta, np.float32)))
        stages.append(SaturateCast(dst=dst))
    return FusedCompute(ops=tuple(stages))


def multiply(value) -> ComputeOp:
    return Mul(value=_np_or_tensor(value, np.float32))


def add(value) -> ComputeOp:
    return Add(value=_np_or_tensor(value, np.float32))


def subtract(value) -> ComputeOp:
    return Sub(value=_np_or_tensor(value, np.float32))


def divide(value) -> ComputeOp:
    return Div(value=_np_or_tensor(value, np.float32))


def cvt_color(code: ColorConversionCode) -> ComputeOp:
    """``cvGS::cvtColor<code>``."""
    return ColorConversion(code=code)


def vector_reorder(*indices: int) -> ComputeOp:
    """``fk::VectorReorder<idx...>``: output channel ``k`` takes channel
    ``indices[k]``."""
    return VectorReorder(indices=tuple(indices))


def static_loop(body: ComputeOp, n: int) -> ComputeOp:
    """``fk::StaticLoop<Op, N>``: ``body`` applied ``n`` times."""
    return StaticLoop(body=body, n=n)


def convert_yuv_to_rgb(
    color_range: ColorRange = ColorRange.FULL,
    standard: ColorStandard = ColorStandard.BT601,
    alpha: bool = False,
    out_dtype=np.uint8,
) -> ComputeOp:
    """``fk::ConvertYUVToRGB<NV12, range, standard, alpha, out>``."""
    return ConvertYUVToRGB(color_range=color_range, standard=standard, alpha=alpha,
                           out_dtype=_dt.to_torch_dtype(out_dtype))


# ---------------------------------------------------------------------------
# read factories
# ---------------------------------------------------------------------------


def image(source: ArrayLike, channels: Optional[int] = None) -> ReadOp:
    """Wrap a channel-last (H, W, C) or (N, H, W, C) image as a read op.

    ``channels=C`` declares channel-interleaved rows, (H, W*C) or
    (N, H, W*C), as a raw row-major frame buffer holds them.
    """
    arr = _host_or_tensor(source)
    if channels is not None:
        if arr.ndim not in (2, 3):
            raise ValueError("image(channels=) expects packed (H, W*C) or (N, H, W*C) rows")
        if arr.shape[-1] % channels:
            raise ValueError(
                f"packed row length {arr.shape[-1]} is not a multiple of channels={channels}"
            )
        return ImageRead(data=arr, is_batch=(arr.ndim == 3), packed_channels=int(channels))
    return ImageRead(data=arr, is_batch=(arr.ndim == 4))


def read_yuv(buffer: ArrayLike, pixel_format: PixelFormat = PixelFormat.NV12) -> ReadOp:
    """An NV12/NV21 buffer, (H*3/2, W) uint8, read as (H, W, 3) YUV."""
    return ReadYUV(buffer=_host_or_tensor(buffer), pixel_format=pixel_format)


def _as_read(source) -> ReadOp:
    if isinstance(source, ReadOp):
        return source
    arr = _host_or_tensor(source)
    return ImageRead(data=arr, is_batch=(arr.ndim == 4))


def resize(
    source=None,
    dsize: Optional[Size] = None,
    fx: float = 0.0,
    fy: float = 0.0,
    interpolation: InterpolationType = InterpolationType.INTER_LINEAR,
):
    """``cvGS::resize<T, INTER_LINEAR>(src, dsize, fx, fy)``. Output is
    float32; append :func:`convert_to` to cast.

    Called with only a size (``resize(Size(w, h))`` or ``resize(dsize=...)``)
    it returns a geometry op that binds to the preceding, possibly fused,
    read (the ``cvGS::resize<INTER_F>(dsize)`` overload that follows a fused
    NV12 read). With ``dsize`` omitted or ``Size(0, 0)`` the size is
    ``round(W * fx) x round(H * fy)`` of an array source, read from its
    shape without running anything."""
    if dsize is None and isinstance(source, Size):
        source, dsize = None, source
    if source is None:
        if dsize is None:
            raise ValueError("resize needs a dsize")
        return PendingReadOp(lambda src: ResizeRead(source=src, dsize=dsize, interp=interpolation))
    src = _as_read(source)
    if dsize is None or dsize == Size(0, 0):
        if isinstance(source, ReadOp) or not (fx > 0 and fy > 0):
            raise ValueError("resize with dsize=(0,0) needs fx, fy > 0 and an array source")
        dsize = Size(int(round(src.data.shape[1] * fx)), int(round(src.data.shape[0] * fy)))
    return ResizeRead(source=src, dsize=dsize, interp=interpolation)


def resize_batch(
    source: Union[ArrayLike, Sequence[ArrayLike]],
    dsize: Size,
    rects: Optional[ArrayLike] = None,
    used_planes: Optional[ArrayLike] = None,
    background=0.0,
    aspect_ratio: AspectRatio = AspectRatio.IGNORE_AR,
    interpolation: InterpolationType = InterpolationType.INTER_LINEAR,
    channels: Optional[int] = None,
) -> BatchResizeRead:
    """The flagship batched variable-geometry resize
    (``cvGS::resize<T, INTER_LINEAR, NPtr, AR>``).

    - ``source`` = one frame + ``rects`` (N, 4) ``[x, y, w, h]`` (crops of a
      frame), or a list of independent images, zero-padded to the largest
      and stacked.
    - ``used_planes``: runtime active-plane count (ragged batch); inactive
      planes emit ``background``.
    - ``background``: scalar or per-channel; fills inactive planes and the
      letterbox borders of the PRESERVE_AR modes.
    """
    used = None if used_planes is None else _np_or_tensor(used_planes, np.int32)
    if rects is not None:
        frame = _host_or_tensor(source)
        if frame.ndim == 2:
            frame = frame[..., None]
        rect_arr = _host_or_tensor(rects)
        if not isinstance(rect_arr, torch.Tensor):
            rect_arr = rect_arr.astype(np.int32)
        if rect_arr.ndim != 2 or rect_arr.shape[1] != 4:
            raise ValueError("rects must be (N, 4) [x, y, w, h]")
        nch = channels or int(frame.shape[-1])
        return BatchResizeRead(
            frame=frame, stack=None, rects=rect_arr, used_planes=used,
            background=_dt.as_channel_vector(background, nch, np.float32),
            dsize=dsize, aspect_ratio=aspect_ratio, interp=interpolation,
        )
    imgs = [_host_or_tensor(s) for s in source]
    imgs = [im[..., None] if im.ndim == 2 else im for im in imgs]
    nch = channels or int(imgs[0].shape[-1])
    max_h = max(int(im.shape[0]) for im in imgs)
    max_w = max(int(im.shape[1]) for im in imgs)
    shape = (len(imgs), max_h, max_w, nch)
    if isinstance(imgs[0], torch.Tensor):
        stack = torch.zeros(shape, dtype=imgs[0].dtype, device=imgs[0].device)
    else:
        stack = np.zeros(shape, dtype=imgs[0].dtype)
    for z, im in enumerate(imgs):
        stack[z, : im.shape[0], : im.shape[1], :] = im
    rect_arr = np.asarray([(0, 0, im.shape[1], im.shape[0]) for im in imgs], np.int32)
    return BatchResizeRead(
        frame=None, stack=stack, rects=rect_arr, used_planes=used,
        background=_dt.as_channel_vector(background, nch, np.float32),
        dsize=dsize, aspect_ratio=aspect_ratio, interp=interpolation,
    )


def crop(source=None, rect: Optional[Rect] = None):
    """``cvGS::crop(backIOp, rect)``: a re-indexing read of ``rect`` (a
    :class:`Rect`; its origin is a runtime value, its size static). Called
    with only a rect it returns a geometry op that binds to the preceding
    read (``cvGS::crop(rect)``)."""
    if rect is None and isinstance(source, Rect):
        source, rect = None, source
    if rect is None:
        raise ValueError("crop needs a rect")

    def build(src: ReadOp) -> ReadOp:
        return CropRead(source=src, x=_np_or_tensor(rect.x, np.int32),
                        y=_np_or_tensor(rect.y, np.int32), width=int(rect.width),
                        height=int(rect.height))

    if source is None:
        return PendingReadOp(build)
    return build(_as_read(source))


def crop_batch(source, rects: Sequence[Rect]) -> BatchRead:
    """``cvGS::crop<BATCH>(rects)``: N crops of one size as one batched read."""
    if len({(r.width, r.height) for r in rects}) != 1:
        raise ValueError("crop_batch requires equal crop sizes (shape is static); "
                         "use resize_batch for variable geometry")
    src = _as_read(source)
    return BatchRead(ops=tuple(crop(src, r) for r in rects), used_planes=None, default=None)


def set_to(value, shape, dtype=np.float32, device=None) -> torch.Tensor:
    """``fk::setTo(value, ptr)``: a filled tensor (returned, not written
    into a buffer). ``device`` defaults as in :func:`execute_operations`:
    the current CUDA device, and the CPU only when asked for."""
    return torch.full(tuple(shape), value, dtype=_dt.canonical_dtype(_dt.to_torch_dtype(dtype)),
                      device=default_device(device))


def make_border(source, top: int, bottom: int, left: int, right: int,
                mode: Optional[BorderMode] = None, value=0.0) -> BorderRead:
    """A border-extension read (``cv2.copyMakeBorder``); ``mode`` defaults to
    REFLECT_101, ``value`` fills the CONSTANT border."""
    return BorderRead(source=_as_read(source), value=_np_or_tensor(value, np.float32),
                      top=int(top), bottom=int(bottom), left=int(left), right=int(right),
                      mode=mode or BorderMode.REFLECT_101)


def circular_batch_read(data: ArrayLike, first, ascendent: bool = True,
                        channels: Optional[int] = None) -> CircularBatchRead:
    """A ring of planes read from the runtime plane ``first`` (``fk::
    CircularBatchRead``). A host (numpy) ring of shape (N, H, W, C) is taken
    as packed (N, H, W*C) rows, as the reference's factory takes it;
    ``channels=C`` declares an already packed ring."""
    packed = 0
    arr = _host_or_tensor(data)
    if channels is not None:
        if arr.ndim != 3 or arr.shape[-1] % channels:
            raise ValueError("circular_batch_read(channels=) expects a packed (N, H, W*C) ring")
        packed = int(channels)
    elif isinstance(arr, np.ndarray) and arr.ndim == 4 and arr.shape[-1] > 1:
        packed = int(arr.shape[-1])
        arr = np.ascontiguousarray(arr).reshape(arr.shape[0], arr.shape[1], arr.shape[2] * packed)
    return CircularBatchRead(data=arr, first=_np_or_tensor(first, np.int32), ascendent=ascendent,
                             packed_channels=packed)


def _channels(read: ReadOp) -> int:
    """The channel count of a read's value, from shapes alone (no device
    work)."""
    return int(meta_lower(read).shape[-1])


def warp(
    source,
    matrix: ArrayLike,
    dsize: Size,
    warp_type: WarpType = WarpType.AFFINE,
    default=0.0,
    channels: Optional[int] = None,
) -> WarpRead:
    """``cvGS::warp<WarpType, I>(src, 2x3/3x3, dstSize)``. The forward matrix
    is inverted on the host, as the reference wrapper does; pass
    ``warp_type=PERSPECTIVE`` with a 3x3 homography. ``default`` is the
    border value, a scalar or one per channel. Output is float32."""
    m = np.asarray(matrix, np.float64)
    if warp_type == WarpType.AFFINE:
        if m.shape != (2, 3):
            raise ValueError("affine warp needs a 2x3 matrix")
        inv = invert_affine(m)
    else:
        if m.shape != (3, 3):
            raise ValueError("perspective warp needs a 3x3 matrix")
        inv = invert_perspective(m)
    src = _as_read(source)
    nch = channels
    if nch is None:
        if isinstance(source, ReadOp):
            nch = _channels(source)
        else:
            nch = 1 if src.data.ndim == 2 else int(src.data.shape[-1])
    return WarpRead(
        source=src,
        coeffs=inv.astype(np.float32).ravel(),
        default=_dt.as_channel_vector(default, nch, np.float32),
        dsize=dsize,
        warp_type=warp_type,
        **decompose_inverse_map(inv, dsize),
    )


def warp_batch(
    sources: Sequence,
    matrices: Sequence[ArrayLike],
    dsize: Size,
    warp_type: WarpType = WarpType.AFFINE,
    used_planes: Optional[ArrayLike] = None,
    default=0.0,
    border_value=0.0,
) -> BatchRead:
    """Batched warp with one matrix per source (``cvGS::warp<WT, I, BATCH>``),
    ragged with ``used_planes``. ``border_value`` fills taps outside a
    source; ``default`` fills the planes from ``used_planes`` on. One
    source passed N times is read from one buffer."""
    if len(sources) != len(matrices):
        raise ValueError("need one matrix per source image")
    warps = [warp(s, m, dsize, warp_type=warp_type, default=border_value)
             for s, m in zip(sources, matrices)]
    return batch_read(warps, used_planes=used_planes,
                      default=default if used_planes is not None else None)


def batch_read(ops: Sequence[ReadOp], used_planes: Optional[ArrayLike] = None,
               default=None) -> BatchRead:
    """``fk::BatchRead<N, CONDITIONAL_WITH_DEFAULT>`` over per-plane read ops."""
    if used_planes is not None and default is None:
        raise ValueError("batch_read with used_planes needs a default value "
                         "for the masked planes (CONDITIONAL_WITH_DEFAULT)")
    return BatchRead(
        ops=tuple(ops),
        used_planes=None if used_planes is None else _np_or_tensor(used_planes, np.int32),
        default=None if default is None else _np_or_tensor(default, np.float32),
    )


# ---------------------------------------------------------------------------
# write factories
# ---------------------------------------------------------------------------


def write() -> WriteOp:
    """Packed channel-last output (``cvGS::write<O>(GpuMat)``)."""
    return Write2D()


def write_tensor() -> WriteOp:
    """Packed batch tensor (N, H, W, C) (``fk::TensorWrite``)."""
    return TensorWrite()


def split() -> WriteOp:
    """Per-channel separate buffers (``cvGS::split<O>(vector<GpuMat>)``)."""
    return SplitWrite()


def split_tensor() -> WriteOp:
    """Planar (N, C, H, W) tensor (``cvGS::split<O>(GpuMat, planeDims)``)."""
    return TensorSplit()


def split_tensor_transposed() -> WriteOp:
    """Channel-major (C, N, H, W) tensor (``cvGS::splitT``)."""
    return TensorTSplit()


def split_tensor_packed() -> WriteOp:
    """Planar tensor as (N, C, H/f, f*W), row-major identical to
    :func:`split_tensor` (``reshape(N, C, H, W)`` recovers it)."""
    return TensorSplitPacked()


__all__ = [
    # graph
    "IOp", "ReadOp", "ComputeOp", "WriteOp", "FusedCompute", "fuse",
    "Pipeline", "build_pipeline", "execute_operations", "describe_backend",
    "last_backend", "clear_cache",
    "build_operation_sequence", "launch_divergent_batch",
    # types
    "Size", "Point", "Rect", "InterpolationType", "AspectRatio", "ParBackend", "ColorConversionCode",
    "ColorRange", "ColorStandard", "PixelFormat", "WarpType", "BorderMode",
    "CircularTensorOrder", "ColorPlanes",
    # factories
    "convert_to", "multiply", "add", "subtract", "divide", "cvt_color", "vector_reorder",
    "static_loop", "convert_yuv_to_rgb",
    "image", "read_yuv", "crop", "crop_batch", "resize", "resize_batch", "warp", "warp_batch",
    "batch_read", "circular_batch_read", "set_to", "make_border",
    "write", "write_tensor", "split", "split_tensor", "split_tensor_transposed",
    "split_tensor_packed",
    # ops the factories above return and callers name
    "StaticLoop", "VectorReorder",
    # data
    "CircularTensor",
    # utils
    "saturate_cast_fn",
]
