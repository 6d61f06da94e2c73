"""Geometry primitives and public enums of the port.

Counterpart of ``cvgpuspeedup_tpu/types.py``. The enums keep the reference
package's member names, so a pipeline carried across by
``interop.from_jax`` maps member for member. ``ParBackend`` names the port's
two lowerings: the eager PyTorch version and the hand-written CUDA kernels.
"""

from __future__ import annotations

import enum
from typing import NamedTuple


class Size(NamedTuple):
    """Width x height, OpenCV argument order (``cv::Size(w, h)``)."""

    width: int
    height: int


class Point(NamedTuple):
    """A position ``(x, y, z)``; ``z`` is the plane of a batch."""

    x: int = 0
    y: int = 0
    z: int = 0


class Rect(NamedTuple):
    """Crop rectangle ``[x, y, width, height]``."""

    x: int
    y: int
    width: int
    height: int


class InterpolationType(enum.Enum):
    INTER_LINEAR = "linear"


class AspectRatio(enum.Enum):
    IGNORE_AR = "ignore"
    PRESERVE_AR = "preserve"
    PRESERVE_AR_RN_EVEN = "preserve_round_even"
    PRESERVE_AR_LEFT = "preserve_left"


class WarpType(enum.Enum):
    """The inverse map of a warp: a 2x3 affine or a 3x3 perspective matrix.
    (The reference package defines it in ``ops/warp.py``.)"""

    AFFINE = "affine"
    PERSPECTIVE = "perspective"


class BorderMode(enum.Enum):
    """``cv::BorderTypes`` of a border-extension read. (The reference package
    defines it in ``ops/border.py``.)"""

    CONSTANT = "constant"
    REPLICATE = "replicate"
    REFLECT = "reflect"
    REFLECT_101 = "reflect_101"
    WRAP = "wrap"


class CircularTensorOrder(enum.Enum):
    NEWEST_FIRST = "newest_first"
    OLDEST_FIRST = "oldest_first"


class ColorPlanes(enum.Enum):
    STANDARD = "standard"      # (N, C, H, W): the TensorSplit layout
    TRANSPOSED = "transposed"  # (C, N, H, W): the TensorTSplit layout
    PACKED = "packed"          # (N, H, W, C): the TensorWrite layout


class ColorRange(enum.Enum):
    FULL = "full"
    LIMITED = "limited"


class ColorStandard(enum.Enum):
    BT601 = "bt601"
    BT709 = "bt709"


class PixelFormat(enum.Enum):
    NV12 = "nv12"
    NV21 = "nv21"


class ColorConversionCode(enum.Enum):
    """``cv::ColorConversionCodes`` that ``ColorConversion`` supports: the 12
    RGB/BGR/RGBA/BGRA permutations and the 4 reductions to gray. (The
    reference package defines it in ``ops/color.py``; it lives here so that
    ``interop.from_jax`` finds every enum in one module.)"""

    COLOR_BGR2BGRA = "BGR2BGRA"
    COLOR_RGB2RGBA = "RGB2RGBA"
    COLOR_BGRA2BGR = "BGRA2BGR"
    COLOR_RGBA2RGB = "RGBA2RGB"
    COLOR_BGR2RGBA = "BGR2RGBA"
    COLOR_RGB2BGRA = "RGB2BGRA"
    COLOR_BGRA2RGB = "BGRA2RGB"
    COLOR_RGBA2BGR = "RGBA2BGR"
    COLOR_BGR2RGB = "BGR2RGB"
    COLOR_RGB2BGR = "RGB2BGR"
    COLOR_BGRA2RGBA = "BGRA2RGBA"
    COLOR_RGBA2BGRA = "RGBA2BGRA"
    COLOR_RGB2GRAY = "RGB2GRAY"
    COLOR_RGBA2GRAY = "RGBA2GRAY"
    COLOR_BGR2GRAY = "BGR2GRAY"
    COLOR_BGRA2GRAY = "BGRA2GRAY"


class ParBackend(enum.Enum):
    """Backend selector.

    ``AUTO`` takes a CUDA kernel for a CUDA source whenever one supports the
    pipeline, else the eager PyTorch version. ``TORCH`` forces the eager
    version. ``CUDA`` forces a kernel and raises where none can run (a CPU
    tensor, or a pipeline no kernel encodes).
    """

    AUTO = "auto"
    TORCH = "torch"
    CUDA = "cuda"
