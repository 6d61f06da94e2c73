"""Memory read and write ops: the image source, the batch read and the
output layouts.

Counterpart of ``cvgpuspeedup_tpu/ops/memory.py``. ``BatchRead`` stacks
sub-reads on a plane axis, with a ragged ``used_planes`` count;
``CircularBatchRead`` presents a ring of planes from a runtime ``first``.
The writes:

  ========================  =============================  =======================
  reference op              layout written                 here
  ========================  =============================  =======================
  PerThreadWrite<_2D,T>     packed HWC image               (H, W, C) / (N, H, W, C)
  TensorWrite<T>            packed, one image per plane    (N, H, W, C)
  TensorSplit<T>            planar per image               (N, C, H, W)
  TensorTSplit<T>           channel-major over the batch   (C, N, H, W)
  SplitWrite<_2D,T>         C separate buffers             tuple of (N, H, W)
  ========================  =============================  =======================

Every write returns contiguous tensors in its layout. ``SplitWrite`` returns
the C planes of one (C, N, H, W) buffer, which is what the CUDA kernel
writes too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..graph import ReadOp, WriteOp, op, static_field
from ..utils import dtypes as dt


@op
class ImageRead(ReadOp):
    """Read a packed channel-last image (H, W, C) or stack (N, H, W, C).

    Grayscale arrays without a channel axis are read as C=1. With
    ``packed_channels=C`` the rows are channel-interleaved: ``data`` is
    (H, W*C), or (N, H, W*C) batched, and ``lower`` views it as (.., W, C).
    """

    data: torch.Tensor
    is_batch: bool = static_field(default=False)
    packed_channels: int = static_field(default=0)

    def lower(self) -> torch.Tensor:
        x = self.data
        if self.packed_channels:
            c = self.packed_channels
            return x.reshape(x.shape[:-1] + (x.shape[-1] // c, c))
        min_rank = 4 if self.is_batch else 3
        if x.ndim == min_rank - 1:
            x = x[..., None]
        return x

    @property
    def batched(self) -> bool:
        return self.is_batch

    def lower_planes(self, planes) -> torch.Tensor:
        x = self.lower()
        idx = torch.as_tensor([int(z) for z in planes], device=x.device)
        return dt.gather(x, lambda s: s[idx])


@op
class BatchRead(ReadOp):
    """N same-shaped sub-reads stacked on a new leading plane axis
    (``fk::BatchRead<N, CONDITIONAL_WITH_DEFAULT>``).

    With ``used_planes``, planes ``z >= used_planes`` hold ``default``, cast
    to the value's dtype, instead of their read. ``used_planes`` is a
    runtime leaf: changing the count builds no new plan.
    """

    ops: Tuple[ReadOp, ...]
    used_planes: Optional[torch.Tensor]
    default: Optional[torch.Tensor]  # scalar or (C,)

    batched = True

    def _mask(self, x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
        if self.used_planes is None:
            return x
        z = planes.reshape((-1,) + (1,) * (x.ndim - 1))
        used = torch.as_tensor(self.used_planes, device=x.device)
        default = dt.cast(torch.as_tensor(self.default, device=x.device), x.dtype)
        if x.dtype == torch.uint16:  # a select moves elements: uint16's as int16 bits
            return torch.where(z < used, x.view(torch.int16),
                               default.view(torch.int16)).view(torch.uint16)
        return torch.where(z < used, x, default)

    @staticmethod
    def _stack(xs) -> torch.Tensor:
        """The planes on a new leading axis; uint16 ones moved as their
        int16 bits, as ``utils.dtypes.gather`` moves them."""
        if xs[0].dtype == torch.uint16:
            return torch.stack([x.view(torch.int16) for x in xs], dim=0).view(torch.uint16)
        return torch.stack(xs, dim=0)

    def lower(self) -> torch.Tensor:
        x = self._stack([o.lower() for o in self.ops])
        return self._mask(x, torch.arange(x.shape[0], device=x.device))

    def lower_planes(self, planes) -> torch.Tensor:
        """Only the planes of a static list, in its order."""
        x = self._stack([self.ops[int(z)].lower() for z in planes])
        return self._mask(x, torch.as_tensor([int(z) for z in planes], device=x.device))


@op
class CircularBatchRead(ReadOp):
    """A ring of N planes read from a runtime start
    (``fk::CircularBatchRead``): output plane ``z`` reads ring plane
    ``(first + z) mod N`` (``ascendent``) or ``(first - z) mod N``, with the
    floor modulo, so ``first = -1`` starts at plane N - 1. ``first`` is a
    leaf: a new value builds no plan. With ``packed_channels=C`` the ring is
    (N, H, W*C), as the reference's factory packs host rings.
    """

    data: torch.Tensor  # (N, H, W, C), or (N, H, W*C) when packed
    first: torch.Tensor  # scalar int
    ascendent: bool = static_field(default=True)
    packed_channels: int = static_field(default=0)

    batched = True

    @property
    def num_planes(self) -> int:
        """Output planes: the ring's (a rank's view of it has fewer)."""
        return int(self.data.shape[0])

    def _take(self, z: torch.Tensor) -> torch.Tensor:
        x = self.data
        first = torch.as_tensor(self.first, device=x.device).to(torch.int64).reshape(())
        src = torch.remainder(first + z if self.ascendent else first - z, x.shape[0])
        x = dt.gather(x, lambda s: s.index_select(0, src))
        if self.packed_channels:
            c = self.packed_channels
            x = x.reshape(x.shape[:-1] + (x.shape[-1] // c, c))
        return x

    def lower(self) -> torch.Tensor:
        return self._take(torch.arange(self.num_planes, device=self.data.device))

    def lower_planes(self, planes) -> torch.Tensor:
        return self._take(torch.as_tensor([int(z) for z in planes], device=self.data.device))


@op
class Write2D(WriteOp):
    """Packed channel-last output (``fk::PerThreadWrite``)."""

    def write(self, x: torch.Tensor):
        return x.contiguous()


@op
class TensorWrite(WriteOp):
    """Packed tensor, one image per plane (``fk::TensorWrite``): (N, H, W, C)."""

    def write(self, x: torch.Tensor):
        if x.ndim != 4:
            raise ValueError(f"TensorWrite expects a batched (N,H,W,C) value, got {tuple(x.shape)}")
        return x.contiguous()


@op
class TensorSplit(WriteOp):
    """Planar split per image (``fk::TensorSplit``): (N, C, H, W) or (C, H, W)."""

    def write(self, x: torch.Tensor):
        if x.ndim == 4:
            return x.permute(0, 3, 1, 2).contiguous()
        if x.ndim == 3:
            return x.permute(2, 0, 1).contiguous()
        raise ValueError(f"TensorSplit expects (N,H,W,C) or (H,W,C), got {tuple(x.shape)}")


def pack_factor(height: int, width: int) -> int:
    """Row-packing factor for :class:`TensorSplitPacked`: how many consecutive
    output rows share one 128-lane vector row. 1 when the width already fills
    the lanes (or the height does not divide)."""
    f = max(1, 128 // max(1, width))
    while f > 1 and height % f:
        f //= 2
    return f


@op
class TensorSplitPacked(WriteOp):
    """Planar split as (N, C, H/f, f*W), ``f = pack_factor(H, W)``.

    Row-major identical to :class:`TensorSplit`: ``out.reshape(N, C, H, W)``
    is the TensorSplit output. The reference package fills 128-lane TPU rows
    with it; here it is a reshape view of the TensorSplit buffer.
    """

    def write(self, x: torch.Tensor):
        if x.ndim != 4:
            raise ValueError(
                f"TensorSplitPacked expects a batched (N,H,W,C) value, got {tuple(x.shape)}"
            )
        n, h, w, c = x.shape
        f = pack_factor(h, w)
        return x.permute(0, 3, 1, 2).contiguous().reshape(n, c, h // f, f * w)


@op
class TensorTSplit(WriteOp):
    """Transposed planar split (``fk::TensorTSplit``): (C, N, H, W)."""

    def write(self, x: torch.Tensor):
        if x.ndim != 4:
            raise ValueError(f"TensorTSplit expects a batched (N,H,W,C) value, got {tuple(x.shape)}")
        return x.permute(3, 0, 1, 2).contiguous()


@op
class SplitWrite(WriteOp):
    """One buffer per channel (``fk::SplitWrite``): a tuple of C tensors of
    shape (H, W), or (N, H, W) for batched pipelines."""

    def write(self, x: torch.Tensor):
        return tuple(torch.movedim(x, -1, 0).contiguous().unbind(0))
