"""CircularTensor: a ring of the last BATCH processed frames.

Counterpart of ``cvgpuspeedup_tpu/data/circular_tensor.py``
(``fk::CircularTensor``). The ring is stored in slot order and never
shifted: frame ``j`` (1-based) lives in slot ``(j - 1) % BATCH``, and the
logical order is applied by the readers. After ``k`` updates, NEWEST_FIRST
plane ``z`` holds frame ``k - z`` and OLDEST_FIRST plane ``z`` holds frame
``k - (BATCH - 1 - z)``.

``update`` runs the new frame's pipeline through ``execute_operations`` (a
resize update runs the full-frame kernel on the card) and writes the one
slot in place with ``copy_``, after the reference's ``astype`` to the
ring's dtype (float -> integer clamps, then truncates). ``read_batch``
returns a :class:`~..ops.memory.CircularBatchRead` over the raw ring whose
runtime ``first`` applies the logical order, and ``.tensor`` gathers the
ordered window into a new buffer.

Layouts: STANDARD (N, C, H, W), TRANSPOSED (C, N, H, W), PACKED (N, H, W, C).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..exec.executor import default_device, execute_operations
from ..graph import ComputeOp, FusedCompute, IOp, ReadOp, WriteOp
from ..ops.memory import CircularBatchRead, ImageRead, TensorSplit, TensorTSplit, TensorWrite
from ..types import CircularTensorOrder, ColorPlanes
from ..utils import dtypes as dt

_LAYOUT_FOR_WRITE = {
    TensorSplit: ColorPlanes.STANDARD,
    TensorTSplit: ColorPlanes.TRANSPOSED,
    TensorWrite: ColorPlanes.PACKED,
}


class CircularTensor:
    """A BATCH-deep ring of processed frames on ``device``: the current CUDA
    device unless the caller names one (``device="cpu"`` for the CPU)."""

    def __init__(
        self,
        width: int,
        height: int,
        channels: int,
        batch: int,
        order: CircularTensorOrder = CircularTensorOrder.NEWEST_FIRST,
        planes: ColorPlanes = ColorPlanes.STANDARD,
        dtype=np.float32,
        device=None,
    ):
        self.width = width
        self.height = height
        self.channels = channels
        self.batch = batch
        self.order = order
        self.planes = planes
        self.dtype = dt.to_torch_dtype(dtype)
        if planes == ColorPlanes.STANDARD:
            shape = (batch, channels, height, width)
        elif planes == ColorPlanes.TRANSPOSED:
            shape = (channels, batch, height, width)
        else:
            shape = (batch, height, width, channels)
        self._ring = torch.zeros(shape, dtype=self.dtype, device=default_device(device))
        self._count = 0  # frames ever inserted

    def _plane_axis(self) -> int:
        return 1 if self.planes == ColorPlanes.TRANSPOSED else 0

    def _slot_perm(self, count: int) -> np.ndarray:
        """The slot of each logical plane after ``count`` updates."""
        z = np.arange(self.batch, dtype=np.int64)
        if self.order == CircularTensorOrder.NEWEST_FIRST:
            return (count - 1 - z) % self.batch
        return (count + z) % self.batch

    @property
    def tensor(self) -> torch.Tensor:
        """The window in logical order, gathered into a new buffer (valid
        across later updates)."""
        perm = torch.from_numpy(self._slot_perm(self._count)).to(self._ring.device)
        return self._ring.index_select(self._plane_axis(), perm)

    def snapshot(self) -> torch.Tensor:
        """A copy of the window in logical order (the same as ``.tensor``)."""
        return self.tensor

    def read_batch(self) -> CircularBatchRead:
        """A read of the raw ring in logical order, for the head of any
        pipeline: its runtime ``first`` applies the order, nothing moves.
        The plane axis must lead (STANDARD or PACKED)."""
        if self.planes == ColorPlanes.TRANSPOSED:
            raise ValueError("read_batch() needs the plane axis leading; TRANSPOSED rings "
                             "store (C, N, H, W): read .tensor instead")
        if self.order == CircularTensorOrder.NEWEST_FIRST:
            return CircularBatchRead(data=self._ring,
                                     first=np.int32((self._count - 1) % self.batch),
                                     ascendent=False)
        return CircularBatchRead(data=self._ring, first=np.int32(self._count % self.batch),
                                 ascendent=True)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._ring.shape)

    def size_in_bytes(self) -> int:
        return self._ring.numel() * self._ring.element_size()

    def update(self, *iops: IOp, input=None) -> None:
        """Insert one frame: run its read and compute ops and write the
        result into the next slot, in place.

        ``iops`` are an optional leading read (or pass ``input=``), compute
        ops and an optional write op, which must match the ring's layout.
        """
        ops_list = list(iops)
        if input is not None:
            ops_list.insert(0, ImageRead(data=input, is_batch=False))
        if not ops_list or not isinstance(ops_list[0], ReadOp):
            raise ValueError("update needs a read op or input= array")
        read, rest = ops_list[0], ops_list[1:]
        if rest and isinstance(rest[-1], WriteOp):
            layout = _LAYOUT_FOR_WRITE.get(type(rest[-1]))
            if layout is not None and layout != self.planes:
                raise ValueError(f"write op {type(rest[-1]).__name__} does not match "
                                 f"CircularTensor layout {self.planes.name}")
            rest = rest[:-1]
        compute: list = []
        for o in rest:
            if isinstance(o, FusedCompute):
                compute.extend(o.ops)
            elif isinstance(o, ComputeOp):
                compute.append(o)
            else:
                raise TypeError(f"unexpected op {type(o).__name__} in update chain")
        x = execute_operations(read, *compute, device=self._ring.device)
        expect = (self.height, self.width, self.channels)
        if tuple(x.shape) != expect:
            raise ValueError(f"update produced {tuple(x.shape)}, the ring holds {expect} planes")
        x = dt.astype(x, self.dtype)
        slot = self._count % self.batch
        if self.planes == ColorPlanes.STANDARD:
            self._ring[slot].copy_(x.permute(2, 0, 1))
        elif self.planes == ColorPlanes.TRANSPOSED:
            self._ring[:, slot].copy_(x.permute(2, 0, 1))
        else:
            self._ring[slot].copy_(x)
        self._count += 1

    def state_dict(self) -> dict:
        """The window in logical order and the ring's settings, on the host."""
        return {
            "tensor": self.tensor.cpu().numpy(),
            "order": self.order.value,
            "planes": self.planes.value,
            "width": self.width,
            "height": self.height,
            "channels": self.channels,
            "batch": self.batch,
        }

    def save(self, path: str) -> None:
        np.savez(path, **self.state_dict())

    @classmethod
    def load(cls, path: str, device=None) -> "CircularTensor":
        d = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        logical = d["tensor"]
        ct = cls(width=int(d["width"]), height=int(d["height"]), channels=int(d["channels"]),
                 batch=int(d["batch"]), order=CircularTensorOrder(str(d["order"])),
                 planes=ColorPlanes(str(d["planes"])), dtype=logical.dtype, device=device)
        # the logical window goes back into slot order at count = batch
        ct._count = ct.batch
        axis = ct._plane_axis()
        perm = torch.from_numpy(ct._slot_perm(ct.batch))
        phys = torch.empty_like(torch.from_numpy(logical))
        phys.index_copy_(axis, perm, torch.from_numpy(logical))
        ct._ring.copy_(phys)
        return ct
