"""Dtype helpers and OpenCV-semantics saturating casts on torch tensors.

Counterpart of ``cvgpuspeedup_tpu/utils/dtypes.py``. Images are
channel-last ``(..., C)`` tensors. Static dtype fields of ops hold a
``torch.dtype``; factories also accept numpy dtypes and convert them with
:func:`to_torch_dtype`. A value or dtype of 64 bits takes its canonical
32-bit dtype where it enters (:func:`canonical_dtype`), as in the reference,
which runs with jax's 64-bit values off.
"""

from __future__ import annotations

import math
import operator
from typing import Any, Sequence, Union

import numpy as np
import torch

DTypeLike = Any

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def to_torch_dtype(dtype: DTypeLike) -> torch.dtype:
    """A ``torch.dtype`` for a torch dtype, a numpy dtype or a numpy type."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def to_numpy_dtype(dtype: DTypeLike) -> np.dtype:
    """A numpy dtype for a torch dtype, a numpy dtype or a numpy type."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)


#: the reference's rule with 64-bit values off (jax's default, which the JAX
#: package keeps): what each 64-bit dtype becomes where a value enters
_CANONICAL = {np.dtype(np.int64): np.dtype(np.int32), np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.float64): np.dtype(np.float32)}
_CANONICAL_TORCH = {torch.int64: torch.int32, torch.uint64: torch.uint32,
                    torch.float64: torch.float32}
_INT32 = np.iinfo(np.int32)


def canonical_dtype(dtype: DTypeLike):
    """The dtype a value of ``dtype`` takes in the reference, which runs with
    64-bit values off: int64 becomes int32, uint64 uint32 and float64
    float32; every other dtype stays. A torch dtype gives a torch dtype, any
    other a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _CANONICAL_TORCH.get(dtype, dtype)
    d = np.dtype(dtype)
    return _CANONICAL.get(d, d)


def canonicalize(x):
    """``x`` in its :func:`canonical_dtype`, as ``jnp.asarray`` converts it:
    an integer keeps its low 32 bits, a float64 rounds to nearest (past
    float32's range to an infinity; subnormals are kept). A tensor is
    converted with ``.to()`` on its device, anything else with numpy. A
    Python int outside int32's range raises ``OverflowError``, as the
    reference's dispatch does."""
    if isinstance(x, torch.Tensor):
        return x.to(_CANONICAL_TORCH.get(x.dtype, x.dtype))
    if isinstance(x, int) and not isinstance(x, bool) and not _INT32.min <= x <= _INT32.max:
        raise OverflowError(f"Python int {x} too large to convert to int32")
    a = np.asarray(x)
    d = _CANONICAL.get(a.dtype)
    if d is None:
        return a
    with np.errstate(over="ignore"):  # a float64 past float32's range is an infinity
        return a.astype(d)


def as_device_tensor(x, device: torch.device, canonical: bool = True) -> torch.Tensor:
    """``x`` as a tensor on ``device``. Host values bound for a CUDA device
    go through pinned memory and a non-blocking copy, so the host never
    waits for the device's stream. A user value is brought to its
    :func:`canonical_dtype` first (host values with numpy, before the copy,
    which then moves half the bytes; a tensor with ``.to()``); the port's
    own index tables pass ``canonical=False`` and keep int64."""
    if isinstance(x, torch.Tensor):
        return canonicalize(x) if canonical else x
    a = canonicalize(x) if canonical else np.asarray(x)
    t = torch.from_numpy(a if a.flags.c_contiguous else np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def kernel_source(x, device: torch.device) -> torch.Tensor:
    """A kernel's source on ``device``: host values as :func:`as_device_tensor`
    gives them, a tensor as it is. The kernels read an int64 or float64
    tensor at load as its canonical dtype, with no conversion launched
    before them; their plain versions :func:`canonicalize` it."""
    return x if isinstance(x, torch.Tensor) else as_device_tensor(x, device)


def is_float(dtype: DTypeLike) -> bool:
    return to_torch_dtype(dtype).is_floating_point


def is_integer(dtype: DTypeLike) -> bool:
    d = to_torch_dtype(dtype)
    return not d.is_floating_point and not d.is_complex and d != torch.bool


#: Depths supported by the reference wrapper (CV_8U..CV_64F).
SUPPORTED_DEPTHS = (torch.uint8, torch.int8, torch.uint16, torch.int16, torch.int32,
                    torch.float32, torch.float64)
#: Channel counts supported (C1..C4).
SUPPORTED_CHANNELS = (1, 2, 3, 4)


def min_value(dtype: DTypeLike):
    """``fk::minValue<T>``: the smallest value of an integer or float dtype."""
    d = to_torch_dtype(dtype)
    if is_integer(d):
        return torch.iinfo(d).min
    return float(torch.finfo(d).min)


def max_value(dtype: DTypeLike):
    """``fk::maxValue<T>``: the largest value of an integer or float dtype."""
    d = to_torch_dtype(dtype)
    if is_integer(d):
        return torch.iinfo(d).max
    return float(torch.finfo(d).max)


def channels(x) -> int:
    """Channel count of a channel-last image tensor (``fk::cn<T>``)."""
    if x.ndim == 0:
        return 1
    return int(x.shape[-1])


def float_to_integer(x: torch.Tensor, dtype: torch.dtype, round_first: bool) -> torch.Tensor:
    """A float tensor converted to the integer ``dtype`` as XLA converts it,
    whatever the platform does with a value out of range: NaN becomes 0,
    the value is rounded half to even (``round_first``) or truncated, then
    clamped to the destination's range. The clamp is exact: it runs in
    float64 for a destination wider than 16 bits (2^31 - 1 is not a
    float32), and a value at or past 2^63 gives int64's maximum."""
    info = torch.iinfo(dtype)
    x = x.to(torch.float64 if info.bits > 16 else torch.float32)
    x = torch.nan_to_num(torch.round(x) if round_first else torch.trunc(x), nan=0.0)
    y = torch.clamp(x, info.min, info.max).to(dtype)
    if info.bits == 64:
        y = torch.where(x >= 2.0 ** 63, info.max, y)
    return y


#: float32's smallest normal magnitude, 2^-126, and its largest subnormal
F32_MIN_NORMAL = 1.1754943508222875e-38
F32_MAX_SUBNORMAL = 1.1754942106924411e-38


def flush_subnormal(x):
    """``x`` with each float32 subnormal replaced by a zero of its sign.

    The reference computes float32 as its XLA program on the CPU does, with
    x86 FTZ and DAZ set: a float32 operand of an arithmetic op, a
    comparison, ``floor``, ``max`` or ``min`` that is subnormal (below
    2^-126 in magnitude) reads as a zero of its sign, and a subnormal
    result is written as one. The port applies that rule in its eager ops
    (:func:`fmul`, :func:`fadd`, :func:`fsub`, :func:`fdiv`, :func:`ffloor`
    flush each operand and each result of one elementary op) and its kernels
    are compiled with ``-ftz=true``, whose float32 instructions do the same.
    What moves values and computes none keeps subnormals, in both packages:
    reads, gathers, crops, border fills, selects, layout writes, negation
    and ``abs``, and a float64 value rounded to float32 where it enters.
    float16 is not flushed: the reference computes its ops in float32, where
    its values are normal. Any other tensor, and a Python number that is
    not a float32 subnormal, is returned as it is."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.float32:
            return x
        # two passes: every magnitude up to the largest subnormal to +0, then
        # the sign back (NaN and the infinities pass through both)
        return torch.nn.functional.hardshrink(x, F32_MAX_SUBNORMAL).copysign_(x)
    if isinstance(x, (float, np.floating)) and 0.0 < abs(x) < F32_MIN_NORMAL:
        return math.copysign(0.0, x)
    return x


def _flushed(fn, a, b):
    return flush_subnormal(fn(flush_subnormal(a), flush_subnormal(b)))


def _result(fn, a, b):
    """``fn(a, b)`` with its result flushed, for operands already flushed."""
    return flush_subnormal(fn(a, b))


def fmul(a, b):
    """``a * b`` as one float32 multiply of the reference (``__fmul_rn``
    under ``-ftz=true``): operands and result flushed
    (:func:`flush_subnormal`)."""
    return _flushed(operator.mul, a, b)


def fadd(a, b):
    """``a + b``, operands and result flushed (``__fadd_rn``)."""
    return _flushed(operator.add, a, b)


def fsub(a, b):
    """``a - b``, operands and result flushed (``__fsub_rn``)."""
    return _flushed(operator.sub, a, b)


def fdiv(a, b):
    """``a / b``, operands and result flushed (``__fdiv_rn``)."""
    return _flushed(operator.truediv, a, b)


def ffloor(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)`` with a subnormal operand read as a zero of its sign:
    ``floor(-1e-40)`` is ``-0``, not ``-1``."""
    return torch.floor(flush_subnormal(x))


def lerp(a, b, w):
    """``a*(1-w) + b*w``, each product and the sum one flushed float32 op
    (``chain.cuh::lerp_rn``). Each operand is flushed once; the products
    are results of flushed ops already."""
    a, b, w = flush_subnormal(a), flush_subnormal(b), flush_subnormal(w)
    return _result(operator.add, _result(operator.mul, a, _result(operator.sub, 1.0, w)),
                   _result(operator.mul, b, w))


def saturate_cast(x: torch.Tensor, dtype: DTypeLike) -> torch.Tensor:
    """OpenCV ``saturate_cast`` semantics, elementwise.

    float -> integer: round half-to-even (``torch.round``, like ``cvRound``),
    then clamp to the destination range, NaN to 0 (:func:`float_to_integer`).
    integer -> integer: widen first, because the destination bounds may not
    fit the source type (int8 -> uint8), then clamp. anything -> float:
    plain convert.
    """
    dtype = to_torch_dtype(dtype)
    if x.dtype == dtype:
        return x
    if is_integer(dtype):
        if x.dtype.is_floating_point:
            return float_to_integer(x, dtype, round_first=True)
        info = torch.iinfo(dtype)
        return torch.clamp(x.to(torch.int64), info.min, info.max).to(dtype)
    return x.to(dtype)


def cast(x: torch.Tensor, dtype: DTypeLike) -> torch.Tensor:
    """``fk::Cast``, as the reference's ``astype`` converts: float ->
    integer truncates, then saturates, NaN to 0 (:func:`float_to_integer`:
    3.7 -> 3, 297.5 -> 255 for uint8, -0.5 -> 0); integer -> integer keeps
    the low bits (int32 16777217 -> uint8 1); anything -> float is a plain
    convert."""
    dtype = to_torch_dtype(dtype)
    if x.dtype == dtype:
        return x
    if is_integer(dtype) and x.dtype.is_floating_point:
        return float_to_integer(x, dtype, round_first=False)
    return x.to(dtype)


#: a value stored into a buffer of another dtype (the divergent merge, a
#: ring slot, ``out=``) converts as :func:`cast` does
astype = cast


def gather(x: torch.Tensor, fn):
    """``fn(x)``, an index, gather or concatenation that moves ``x``'s
    elements and computes none. A uint16 tensor is moved as its int16 bits:
    CUDA has no index, gather or concatenation kernel of uint16."""
    if x.dtype == torch.uint16:
        return fn(x.view(torch.int16)).view(torch.uint16)
    return fn(x)


ScalarLike = Union[int, float, Sequence[float], np.ndarray, torch.Tensor]


def as_channel_vector(value: ScalarLike, num_channels: int, dtype: DTypeLike = np.float32):
    """cv::Scalar -> per-channel constant vector of shape ``(num_channels,)``.

    A scalar broadcasts to every channel; a sequence must have
    ``num_channels`` entries. Host values stay numpy, so that the executor
    can pack them with the other host parameters in one copy; a tensor stays
    a tensor on its own device.
    """
    if isinstance(value, torch.Tensor):
        arr = value.to(to_torch_dtype(dtype)).reshape(-1)
        if arr.shape[0] == 1:
            return arr.expand(num_channels).contiguous()
    else:
        arr = np.asarray(value, dtype=to_numpy_dtype(dtype)).reshape(-1)
        if arr.shape[0] == 1:
            return np.full((num_channels,), arr[0], dtype=arr.dtype)
    if arr.shape[0] != num_channels:
        raise ValueError(
            f"scalar has {arr.shape[0]} components, image has {num_channels} channels"
        )
    return arr
