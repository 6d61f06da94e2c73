"""Channel swizzle (counterpart of ``cvgpuspeedup_tpu/ops/color.py:122``).

Only ``VectorReorder`` is here so far; ``ColorConversion`` comes with the
frame slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..graph import ComputeOp, op, static_field


@op
class VectorReorder(ComputeOp):
    """Channel swizzle (``fk::VectorReorder<T, i0, i1, ...>``)."""

    indices: Tuple[int, ...] = static_field()

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if len(self.indices) != x.shape[-1]:
            raise ValueError(f"VectorReorder{self.indices} on {x.shape[-1]}-channel image")
        return x[..., list(self.indices)]
