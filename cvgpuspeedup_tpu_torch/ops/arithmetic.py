"""Pointwise arithmetic ops and the unrolled loop.

Counterpart of ``cvgpuspeedup_tpu/ops/arithmetic.py``. Float tensors use
IEEE arithmetic, float32 with its subnormal operands and results flushed to
zero as the reference's XLA program computes (``utils.dtypes.fmul`` and its
kin). Integer tensors compute in float32 and saturate back
to their own dtype (OpenCV's ``add/subtract/multiply/divide`` round half to
even and clamp rather than wrap). The scalar operand broadcasts over the
channels, or applies per channel when it has C entries.
"""

from __future__ import annotations

import torch

from ..graph import ComputeOp, op, static_field
from ..utils import dtypes as dt


class _BinaryWithScalar(ComputeOp):
    """Shared machinery for Mul/Add/Sub/Div. ``value`` is a leaf, so a new
    value never rebuilds a plan."""

    def _combine(self, x, v):
        raise NotImplementedError

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        v = torch.as_tensor(self.value, device=x.device)  # type: ignore[attr-defined]
        if v.ndim > 1:
            raise ValueError("binary op scalar must be rank 0 or 1 (per-channel)")
        if v.ndim == 1 and v.shape[0] not in (1, x.shape[-1]):
            raise ValueError(
                f"Incompatible shapes for broadcasting: shapes=[{tuple(x.shape)}, {tuple(v.shape)}]"
            )
        if dt.is_integer(x.dtype):
            y = self._combine(x.to(torch.float32), v.to(torch.float32))
            return dt.saturate_cast(y, x.dtype)
        return self._combine(x, v.to(x.dtype))


@op
class Mul(_BinaryWithScalar):
    value: torch.Tensor

    def _combine(self, x, v):
        return dt.fmul(x, v)


@op
class Add(_BinaryWithScalar):
    value: torch.Tensor

    def _combine(self, x, v):
        return dt.fadd(x, v)


@op
class Sub(_BinaryWithScalar):
    value: torch.Tensor

    def _combine(self, x, v):
        return dt.fsub(x, v)


@op
class Div(_BinaryWithScalar):
    value: torch.Tensor

    def _combine(self, x, v):
        return dt.fdiv(x, v)


@op
class StaticLoop(ComputeOp):
    """Apply ``body`` ``n`` times (``fk::StaticLoop<Op, N>``)."""

    body: ComputeOp
    n: int = static_field()

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n):
            x = self.body.apply(x)
        return x
