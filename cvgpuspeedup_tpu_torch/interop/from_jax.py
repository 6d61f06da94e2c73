"""Carry a pipeline built with the JAX package across to the port.

The system has no learned weights: its state is the op graph and the arrays
at its leaves. :func:`from_jax` rebuilds a ``cvgpuspeedup_tpu`` op (or
``Pipeline``) as the port's op of the same class name, field by field. Leaves
become numpy arrays in their canonical dtype (``utils.dtypes.canonicalize``:
an int64 numpy leaf, which the reference converts at dispatch, is int32),
static fields keep their values, with enums (``BorderMode`` among them),
sizes and dtypes mapped to the port's types (the ops bring a 64-bit
dtype to its canonical one, ``ops/cast.py``). It never imports jax: it
reads the reference ops through ``dataclasses.fields`` only.
:func:`ring_from_jax` carries a reference ``CircularTensor``'s window across
through its ``state_dict``, so both rings hold the same frames.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .. import types as port_types
from ..data.circular_tensor import CircularTensor
from ..exec.executor import Pipeline
from ..graph import FusedCompute, FusedRead
from ..ops.arithmetic import Add, Div, Mul, StaticLoop, Sub
from ..ops.border import BorderRead
from ..ops.cast import Cast, SaturateCast
from ..ops.color import ColorConversion, VectorReorder
from ..ops.crop import CropRead
from ..ops.memory import (BatchRead, CircularBatchRead, ImageRead, SplitWrite, TensorSplit,
                          TensorSplitPacked, TensorTSplit, TensorWrite, Write2D)
from ..ops.nv12 import ConvertYUVToRGB, ReadYUV
from ..ops.resize import BatchResizeRead, ResizeRead
from ..ops.warp import WarpRead
from ..utils.dtypes import canonicalize, to_torch_dtype

_CLASSES = {
    c.__name__: c
    for c in (Pipeline, FusedCompute, FusedRead, ImageRead, Write2D, TensorWrite, TensorSplit,
              TensorSplitPacked, TensorTSplit, SplitWrite, SaturateCast, Cast, Mul, Add, Sub,
              Div, StaticLoop, VectorReorder, ColorConversion, BatchResizeRead, ResizeRead,
              ReadYUV, ConvertYUVToRGB, WarpRead, BatchRead, CircularBatchRead, CropRead,
              BorderRead)
}

#: static fields that only size TPU kernels; the port has no use for them
_TPU_ONLY_FIELDS = {
    "BatchResizeRead": {"max_crop_w", "max_crop_h", "uniform_wh"},
    "WarpRead": {"sep_buckets", "gen_buckets", "uni_buckets"},
}


def _static(v):
    if isinstance(v, enum.Enum):
        return getattr(port_types, type(v).__name__)[v.name]
    if type(v).__name__ == "Size":
        return port_types.Size(*v)
    if isinstance(v, np.dtype):
        return to_torch_dtype(v)
    return v


def from_jax(obj):
    """The port's counterpart of a reference op, pipeline or tuple of ops."""
    if obj is None:
        return None
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_jax(v) for v in obj)
    if not (dataclasses.is_dataclass(obj) and not isinstance(obj, type)):
        return np.asarray(canonicalize(obj))
    name = type(obj).__name__
    cls = _CLASSES.get(name)
    if cls is None:
        raise TypeError(f"{name} has no counterpart in the port yet")
    port_fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for f in dataclasses.fields(obj):
        if f.name not in port_fields:
            if f.name in _TPU_ONLY_FIELDS.get(name, ()):
                continue
            raise TypeError(f"{name}.{f.name} has no counterpart in the port")
        v = getattr(obj, f.name)
        kwargs[f.name] = _static(v) if port_fields[f.name].metadata.get("static") else from_jax(v)
    return cls(**kwargs)


def ring_from_jax(ring, device=None) -> CircularTensor:
    """The port's ``CircularTensor`` holding the logical window of a
    reference ring (its ``state_dict()``), on ``device``: the same planes in
    the same order and layout, as after ``batch`` updates."""
    return CircularTensor.from_state_dict(ring.state_dict(), device=device)
