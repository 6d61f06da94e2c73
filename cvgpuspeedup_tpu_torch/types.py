"""Geometry primitives and public enums of the port.

Counterpart of ``cvgpuspeedup_tpu/types.py``. The enums keep the reference
package's member names, so a pipeline carried across by
``interop.from_jax`` maps member for member. ``ParBackend`` names the port's
two lowerings: the eager PyTorch version and the hand-written CUDA kernel.
"""

from __future__ import annotations

import enum
from typing import NamedTuple


class Size(NamedTuple):
    """Width x height, OpenCV argument order (``cv::Size(w, h)``)."""

    width: int
    height: int


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


class ParBackend(enum.Enum):
    """Backend selector.

    ``AUTO`` takes the CUDA kernel for a CUDA source whenever the kernel
    supports the pipeline, else the eager PyTorch version. ``TORCH`` forces
    the eager version. ``CUDA`` forces the kernel and raises where it cannot
    run (a CPU tensor, or a pipeline the kernel does not encode).
    """

    AUTO = "auto"
    TORCH = "torch"
    CUDA = "cuda"
