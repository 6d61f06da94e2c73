"""Preset end-to-end pipelines: the calls a deployment makes.

Counterpart of ``cvgpuspeedup_tpu/pipelines/presets.py``, with the same
constructor arguments and defaults plus a ``device=`` that is passed through
(None is the current CUDA device, as everywhere in the port; ``"cpu"`` for
the CPU). On the card every call is one launch:

- :class:`detection_preprocessor`: N detection crops of one frame, resized,
  normalized and written planar (the batched crop-resize kernel);
- :class:`temporal_window`: a ``CircularTensor`` sliding window for temporal
  models; a push resizes and scales the new frame straight into its ring
  slot (the full-frame kernel with ``out=``);
- :class:`video_stream`: a raw video file through the native prefetch ring,
  each frame resized, normalized and written planar (the full-frame kernel,
  from packed RGB rows or NV12 buffers);
- :class:`camera_pipeline`: an NV12 camera frame to RGB(A), with a resize
  (the full-frame kernel) or without (the pointwise kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import (AspectRatio, CircularTensor, CircularTensorOrder, ColorConversionCode,
                ColorPlanes, ColorRange, ColorStandard, ParBackend, PixelFormat, Size,
                convert_to, convert_yuv_to_rgb, cvt_color, default_device, divide,
                execute_operations, fuse, image, read_yuv, resize, resize_batch, split_tensor,
                subtract)


class detection_preprocessor:
    """Fused N-crop detection preprocessing: one launch per frame batch.

    >>> prep = detection_preprocessor(dsize=Size(64, 128), mean=(127.5,)*3,
    ...                               scale=(128.0,)*3, alpha=1.0)
    >>> planar = prep(frame, rects, n_valid)   # (N, C, 128, 64) float32
    """

    def __init__(
        self,
        dsize: Size,
        mean: Union[float, Sequence[float]] = 0.0,
        scale: Union[float, Sequence[float]] = 1.0,
        alpha: float = 1.0,
        background: Union[float, Sequence[float]] = 0.0,
        aspect_ratio: AspectRatio = AspectRatio.IGNORE_AR,
        backend: ParBackend = ParBackend.AUTO,
        device=None,
    ):
        self.dsize = dsize
        self.mean = mean
        self.scale = scale
        self.alpha = alpha
        self.background = background
        self.aspect_ratio = aspect_ratio
        self.backend = backend
        self.device = device

    def __call__(self, frame, rects, used_planes=None):
        return execute_operations(
            resize_batch(frame, rects=rects, dsize=self.dsize, used_planes=used_planes,
                         background=self.background, aspect_ratio=self.aspect_ratio),
            convert_to(np.float32, alpha=self.alpha),
            subtract(self.mean),
            divide(self.scale),
            split_tensor(),
            backend=self.backend, device=self.device,
        )


class temporal_window:
    """Sliding temporal window: push frames, read the (BATCH, C, H, W) ring.

    A ``push`` resizes and scales the new frame and stores it into the next
    ring slot in one launch (``CircularTensor.update``).
    """

    def __init__(
        self,
        window: int,
        dsize: Size,
        channels: int = 3,
        alpha: float = 1.0 / 255.0,
        order: CircularTensorOrder = CircularTensorOrder.NEWEST_FIRST,
        planes: ColorPlanes = ColorPlanes.STANDARD,
        device=None,
    ):
        self.dsize = dsize
        self.alpha = alpha
        self.ring = CircularTensor(width=dsize.width, height=dsize.height, channels=channels,
                                   batch=window, order=order, planes=planes, dtype=np.float32,
                                   device=device)

    def push(self, frame):
        self.ring.update(resize(image(frame), self.dsize),
                         convert_to(np.float32, alpha=self.alpha))
        return self.ring.tensor

    @property
    def tensor(self):
        return self.ring.tensor


class _Staging:
    """Pinned host buffers that carry the loader's frames to the card.

    The view a :class:`~..utils.frameloader.FrameLoader` yields is recycled
    at its next iteration, and is not pinned. So a frame is copied into a
    pinned buffer and leaves it in one non-blocking copy; an event marks that
    copy, and a buffer is written again only after its event has passed.
    """

    def __init__(self, shape, device: torch.device, depth: int = 2):
        self.device = device
        self.buffers = [torch.empty(shape, dtype=torch.uint8).pin_memory() for _ in range(depth)]
        self.events = [torch.cuda.Event() for _ in range(depth)]
        self.used = [False] * depth
        self.k = 0

    def to_device(self, frame: np.ndarray) -> torch.Tensor:
        k, self.k = self.k, (self.k + 1) % len(self.buffers)
        if self.used[k]:
            self.events[k].synchronize()
        self.buffers[k].numpy()[...] = frame
        with torch.cuda.device(self.device):
            out = self.buffers[k].to(self.device, non_blocking=True)
            self.events[k].record()
        self.used[k] = True
        return out


class video_stream:
    """End-to-end raw video streaming: the native prefetch-ring frame loader,
    then one launch per frame.

    The loader yields zero-copy numpy views of raw row-major frames, which is
    the packed (H, W*C) layout ``image(frame, channels=C)`` reads, so no byte
    is reshaped on the host. ``fmt="nv12"`` streams NV12 buffers through the
    fused YUV read instead. On a CUDA device each frame reaches the card in
    one non-blocking copy from a pinned staging buffer.

    >>> for planar in video_stream("cam.raw", 1920, 1080, dsize=Size(640, 360),
    ...                            mean=(0.485, 0.456, 0.406),
    ...                            scale=(0.229, 0.224, 0.225)):
    ...     model(planar)                       # (C, 360, 640) float32
    """

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        dsize: Optional[Size] = None,
        mean: Union[float, Sequence[float]] = 0.0,
        scale: Union[float, Sequence[float]] = 1.0,
        alpha: float = 1.0 / 255.0,
        channels: int = 3,
        fmt: str = "rgb",
        standard: ColorStandard = ColorStandard.BT601,
        color_range: ColorRange = ColorRange.FULL,
        ring_depth: int = 4,
        backend: ParBackend = ParBackend.AUTO,
        device=None,
    ):
        from ..utils.frameloader import FrameLoader, frame_shape_nv12, frame_shape_packed

        self.fmt = fmt
        self.width, self.height, self.channels = width, height, channels
        self.dsize = dsize or Size(width, height)
        self.mean, self.scale, self.alpha = mean, scale, alpha
        self.standard, self.color_range = standard, color_range
        self.backend = backend
        self.device = default_device(device)
        shape = (frame_shape_nv12(width, height) if fmt == "nv12"
                 else frame_shape_packed(width, height, channels))
        self.loader = FrameLoader(path, shape, np.uint8, ring_depth=ring_depth)
        self._staging = (_Staging(shape, self.device) if self.device.type == "cuda" else None)

    def _head(self, frame):
        if self.fmt == "nv12":
            return resize(
                fuse(read_yuv(frame),
                     convert_yuv_to_rgb(color_range=self.color_range, standard=self.standard,
                                        out_dtype=np.float32)),
                self.dsize)
        # packed rows pass straight through (channels= declares the layout)
        return resize(image(frame, channels=self.channels), self.dsize)

    def __iter__(self):
        for frame in self.loader:
            if self._staging is not None:
                frame = self._staging.to_device(frame)
            yield execute_operations(
                self._head(frame),
                convert_to(np.float32, alpha=self.alpha),
                subtract(self.mean),
                divide(self.scale),
                split_tensor(),
                backend=self.backend, device=self.device,
            )


class camera_pipeline:
    """An NV12 camera frame to RGB(A), optionally fused with a resize (the
    conversion then runs on the resized pixels only, inside the read)."""

    def __init__(
        self,
        standard: ColorStandard = ColorStandard.BT601,
        color_range: ColorRange = ColorRange.FULL,
        alpha: bool = False,
        out_size: Optional[Size] = None,
        pixel_format: PixelFormat = PixelFormat.NV12,
        device=None,
    ):
        self.standard = standard
        self.color_range = color_range
        self.alpha = alpha
        self.out_size = out_size
        self.pixel_format = pixel_format
        self.device = device

    def __call__(self, nv12_buffer):
        if self.out_size is None:
            # the conversion, alpha included, in one launch
            return execute_operations(
                read_yuv(nv12_buffer, pixel_format=self.pixel_format),
                convert_yuv_to_rgb(color_range=self.color_range, standard=self.standard,
                                   alpha=self.alpha, out_dtype=np.uint8),
                device=self.device,
            )
        virtual = fuse(
            read_yuv(nv12_buffer, pixel_format=self.pixel_format),
            convert_yuv_to_rgb(color_range=self.color_range, standard=self.standard,
                               alpha=False, out_dtype=np.float32),
        )
        ops = [resize(virtual, self.out_size), convert_to(np.uint8)]
        if self.alpha:
            # the alpha channel is appended in the same launch (RGB -> RGBA)
            ops.append(cvt_color(ColorConversionCode.COLOR_RGB2RGBA))
        return execute_operations(*ops, device=self.device)
