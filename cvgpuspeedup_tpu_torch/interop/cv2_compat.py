"""cv2-typed convenience shim: the ``cvGS`` surface over OpenCV's constants.

Counterpart of ``cvgpuspeedup_tpu/interop/cv2_compat.py``. The original's
public API is OpenCV-typed (``cvGS::`` functions taking ``CV_8UC3``,
``cv::COLOR_*``, ``cv::INTER_LINEAR``); this shim lets code written against
cv2's constants migrate without renaming (the caller imports cv2, or uses
the literals below):

    from cvgpuspeedup_tpu_torch.interop import cv2_compat as cvGS
    out = cvGS.executeOperations(
        cvGS.resize_batch(frame, rects, (64, 128)),
        cvGS.convertTo(cv2.CV_32F, alpha=0.3),
        cvGS.cvtColor(cv2.COLOR_RGB2BGR),
        cvGS.subtract((3.2, 0.6, 11.8)),
        cvGS.divide((128.0,) * 3),
        cvGS.split(),
    )

The package never imports cv2: OpenCV's integer codes are literals here (its
``core/hal/interface.h`` and ``imgproc.hpp``), and the tests hold every one
against cv2's own constant.
"""

from __future__ import annotations

import numpy as np

from .. import AspectRatio, ColorConversionCode, InterpolationType, Rect, Size, WarpType
from .. import add as _add
from .. import convert_to as _convert_to
from .. import crop as _crop
from .. import cvt_color as _cvt_color
from .. import divide as _divide
from .. import execute_operations as _execute
from .. import multiply as _multiply
from .. import resize as _resize
from .. import resize_batch as _resize_batch
from .. import split as _split
from .. import split_tensor as _split_tensor
from .. import split_tensor_transposed as _split_tensor_transposed
from .. import subtract as _subtract
from .. import warp as _warp
from .. import write as _write
from .. import write_tensor as _write_tensor

# OpenCV's depth codes, CV_8U .. CV_64F
CV_8U, CV_8S, CV_16U, CV_16S, CV_32S, CV_32F, CV_64F = range(7)
CV_MAT_DEPTH_MASK = 7
INTER_LINEAR = 1
#: cv2.COLOR_<name> of the 16 whitelisted codes (RGB and BGR twins share a value)
CV_COLOR_CODES = {
    "BGR2BGRA": 0, "RGB2RGBA": 0, "BGRA2BGR": 1, "RGBA2RGB": 1,
    "BGR2RGBA": 2, "RGB2BGRA": 2, "BGRA2RGB": 3, "RGBA2BGR": 3,
    "BGR2RGB": 4, "RGB2BGR": 4, "BGRA2RGBA": 5, "RGBA2BGRA": 5,
    "RGB2GRAY": 7, "RGBA2GRAY": 11, "BGR2GRAY": 6, "BGRA2GRAY": 10,
}

_DEPTH_TO_DTYPE = {
    CV_8U: np.uint8, CV_8S: np.int8, CV_16U: np.uint16, CV_16S: np.int16,
    CV_32S: np.int32, CV_32F: np.float32, CV_64F: np.float64,
}
# twins share a value and swizzle alike; the later name of the enum wins, as
# in the reference's table
_COLOR_CODES = {CV_COLOR_CODES[c.value]: c for c in ColorConversionCode}
_INTERP = {INTER_LINEAR: InterpolationType.INTER_LINEAR}


def _dtype_of(cv_type):
    """A CV_8UC3-style code or a depth -> numpy dtype (the CUDA_T macro)."""
    if cv_type in _DEPTH_TO_DTYPE:
        return _DEPTH_TO_DTYPE[cv_type]
    depth = cv_type & CV_MAT_DEPTH_MASK
    if depth in _DEPTH_TO_DTYPE:
        return _DEPTH_TO_DTYPE[depth]
    raise ValueError(f"unsupported cv type code {cv_type}")


def convertTo(cv_type, alpha=None, beta=None):
    """``cvGS::convertTo``; a CV_64F depth converts to float32, as the
    reference's does (``convert_to``)."""
    return _convert_to(_dtype_of(cv_type), alpha=alpha, beta=beta)


def cvtColor(code):
    if code not in _COLOR_CODES:
        raise ValueError(f"unsupported color conversion code {code} "
                         f"(the whitelist: 16 RGB/BGR/GRAY codes)")
    return _cvt_color(_COLOR_CODES[code])


def multiply(scalar):
    return _multiply(scalar)


def add(scalar):
    return _add(scalar)


def subtract(scalar):
    return _subtract(scalar)


def divide(scalar):
    return _divide(scalar)


def _interp(interpolation):
    if interpolation not in _INTERP:
        raise ValueError("only cv2.INTER_LINEAR is supported (the original's whitelist)")
    return _INTERP[interpolation]


def resize(src=None, dsize=None, fx=0.0, fy=0.0, interpolation=None):
    interp = (_interp(interpolation) if interpolation is not None
              else InterpolationType.INTER_LINEAR)
    size = Size(*dsize) if dsize is not None else None
    if src is None:
        return _resize(dsize=size, interpolation=interp)
    return _resize(src, size, fx=fx, fy=fy, interpolation=interp)


def resize_batch(frame, rects, dsize, usedPlanes=None, backgroundValue=0.0,
                 aspectRatio=AspectRatio.IGNORE_AR, interpolation=None):
    interp = (_interp(interpolation) if interpolation is not None
              else InterpolationType.INTER_LINEAR)
    return _resize_batch(
        frame, rects=np.asarray(rects, np.int32), dsize=Size(*dsize), used_planes=usedPlanes,
        background=backgroundValue, aspect_ratio=aspectRatio, interpolation=interp,
    )


def crop(src=None, rect=None):
    """rect: an (x, y, w, h) tuple (cv::Rect's layout)."""
    if rect is None and isinstance(src, (tuple, list)):
        src, rect = None, src
    r = Rect(*rect)
    return _crop(src, r) if src is not None else _crop(r)


def warpAffine(src, M, dsize, borderValue=0.0):
    return _warp(src, M, Size(*dsize), warp_type=WarpType.AFFINE, default=borderValue)


def warpPerspective(src, M, dsize, borderValue=0.0):
    return _warp(src, M, Size(*dsize), warp_type=WarpType.PERSPECTIVE, default=borderValue)


split = _split
split_tensor = _split_tensor
splitT = _split_tensor_transposed
write = _write
write_tensor = _write_tensor


def executeOperations(*iops, **kw):
    return _execute(*iops, **kw)
