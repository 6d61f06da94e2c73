"""The lazy operation-graph IR of the port.

Counterpart of ``cvgpuspeedup_tpu/graph.py:52-240``. Factories build frozen
dataclass ops that execute nothing; ``execute_operations`` runs the whole
chain. Each op's fields are of two kinds:

- *static* fields (:func:`static_field`): dtypes, output sizes, modes. They
  form the op's structure and go into the plan cache key;
- every other field holds a child op, a tuple of ops, ``None`` or a *leaf*:
  a tensor, a numpy array or a number. Leaves are runtime parameters (frames,
  rects, scalars) and may change on every call without rebuilding anything.

:func:`flatten` returns ``(structure_key, leaves)``: the key records the op
classes, the static values and each leaf's shape and dtype, never a leaf's
values. :func:`map_leaves` rebuilds an op with every leaf replaced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from .utils.dtypes import canonical_dtype

__all__ = [
    "IOp",
    "PendingReadOp",
    "ReadOp",
    "ComputeOp",
    "WriteOp",
    "FusedRead",
    "FusedCompute",
    "op",
    "static_field",
    "fuse",
    "flatten",
    "map_leaves",
]


def static_field(**kwargs):
    """Mark a dataclass field as static (part of the structure key)."""
    metadata = dict(kwargs.pop("metadata", ()) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def op(cls):
    """Class decorator: a frozen dataclass op."""
    return dataclasses.dataclass(frozen=True)(cls)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float))


def _leaf_signature(x) -> Tuple:
    """A leaf's shape and dtype: a tensor's own, a host value's canonical one
    (``utils.dtypes.canonical_dtype``), which it takes on its way to the
    device."""
    if isinstance(x, torch.Tensor):
        return ("leaf", tuple(x.shape), str(x.dtype).removeprefix("torch."))
    arr = np.asarray(x)
    return ("leaf", arr.shape, canonical_dtype(arr.dtype).name)


def _walk(x, leaves: List) -> Any:
    if x is None:
        return None
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        parts = [type(x).__name__]
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if f.metadata.get("static"):
                parts.append((f.name, v))
            else:
                parts.append((f.name, _walk(v, leaves)))
        return tuple(parts)
    if isinstance(x, (tuple, list)):
        return ("seq",) + tuple(_walk(v, leaves) for v in x)
    if _is_leaf(x):
        leaves.append(x)
        return _leaf_signature(x)
    raise TypeError(f"cannot flatten a {type(x).__name__} inside an op")


def flatten(x) -> Tuple[Tuple, List]:
    """``(structure_key, leaves)`` of an op, leaves in field order."""
    leaves: List = []
    key = _walk(x, leaves)
    return key, leaves


def map_leaves(x, fn: Callable[[Any], Any]):
    """A copy of ``x`` with every leaf ``v`` replaced by ``fn(v)``."""
    if x is None:
        return None
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        changes = {
            f.name: map_leaves(getattr(x, f.name), fn)
            for f in dataclasses.fields(x)
            if not f.metadata.get("static")
        }
        return dataclasses.replace(x, **changes)
    if isinstance(x, (tuple, list)):
        return type(x)(map_leaves(v, fn) for v in x)
    if _is_leaf(x):
        return fn(x)
    raise TypeError(f"cannot map a {type(x).__name__} inside an op")


class IOp:
    """Base of all instantiable operations. Executes nothing on its own."""

    def then(self, other: "IOp") -> "IOp":
        raise NotImplementedError


class ComputeOp(IOp):
    """Pointwise stage: maps a channel-last tensor to a channel-last tensor."""

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def then(self, other: IOp) -> IOp:
        if isinstance(other, ComputeOp):
            return FusedCompute(ops=_chain_of(self) + _chain_of(other))
        raise TypeError(f"cannot compose ComputeOp with {type(other).__name__}")


class ReadOp(IOp):
    """Source stage. ``lower()`` returns the full channel-last value tensor:
    ``(H, W, C)`` for single-plane reads, ``(N, H, W, C)`` for batched ones."""

    #: True when ``lower()`` has a leading plane axis. A class attribute, not
    #: a dataclass field, so that it is neither a leaf nor in the key.
    batched = False

    def lower(self) -> torch.Tensor:
        raise NotImplementedError

    def lower_planes(self, planes) -> torch.Tensor:
        """Only the planes of a static list of a batched read, in its order
        (the divergent launcher lowers each sequence's own planes). The
        default lowers the whole read and takes the planes."""
        if not self.batched:
            raise ValueError("lower_planes needs a batched read")
        x = self.lower()
        return x[torch.as_tensor([int(z) for z in planes], device=x.device)]

    def then(self, other: IOp) -> IOp:
        if isinstance(other, ComputeOp):
            return FusedRead(read=self, chain=_chain_of(other))
        if isinstance(other, PendingReadOp):
            return other.bind(self)
        raise TypeError(f"cannot compose ReadOp with {type(other).__name__}")


class PendingReadOp(IOp):
    """A geometry op waiting for its source, bound by ``read.then(op)``."""

    def __init__(self, bind):
        self._bind = bind

    def bind(self, source: "ReadOp") -> "ReadOp":
        return self._bind(source)

    def then(self, other: IOp) -> IOp:
        raise TypeError("a geometry op must be bound to a read first (read.then(op))")


class WriteOp(IOp):
    """Terminal stage: maps the computed channel-last tensor to its layout."""

    def write(self, x: torch.Tensor):
        raise NotImplementedError

    def then(self, other: IOp) -> IOp:
        raise TypeError("write ops are terminal")


@op
class FusedCompute(ComputeOp):
    """A fused chain of pointwise stages (``fk::FusedOperation``)."""

    ops: Tuple[ComputeOp, ...]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        for o in self.ops:
            x = o.apply(x)
        return x


@op
class FusedRead(ReadOp):
    """A read op with a fused pointwise tail (``fk::fuse(read, ops...)``)."""

    read: ReadOp
    chain: Tuple[ComputeOp, ...]

    @property
    def batched(self) -> bool:
        return self.read.batched

    def lower(self) -> torch.Tensor:
        x = self.read.lower()
        for o in self.chain:
            x = o.apply(x)
        return x

    def then(self, other: IOp) -> IOp:
        if isinstance(other, ComputeOp):
            return FusedRead(read=self.read, chain=self.chain + _chain_of(other))
        if isinstance(other, PendingReadOp):
            return other.bind(self)
        raise TypeError(f"cannot compose ReadOp with {type(other).__name__}")


def _chain_of(o: ComputeOp) -> Tuple[ComputeOp, ...]:
    if isinstance(o, FusedCompute):
        return o.ops
    return (o,)


def fuse(*iops: IOp) -> IOp:
    """Variadic sequential fusion (``fk::fuse(iop, ...)``)."""
    if not iops:
        raise ValueError("fuse() needs at least one op")
    out = iops[0]
    for nxt in iops[1:]:
        out = out.then(nxt)
    return out
