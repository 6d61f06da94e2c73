"""CircularTensor: a ring of the last BATCH processed frames.

Counterpart of ``cvgpuspeedup_tpu/data/circular_tensor.py``
(``fk::CircularTensor``). The ring is stored in slot order and never
shifted: frame ``j`` (1-based) lives in slot ``(j - 1) % BATCH``, and the
logical order is applied by the readers. After ``k`` updates, NEWEST_FIRST
plane ``z`` holds frame ``k - z`` and OLDEST_FIRST plane ``z`` holds frame
``k - (BATCH - 1 - z)``.

``update`` runs the new frame's pipeline with the slot's view of the ring as
its output (``exec.executor.run_pipeline(out=)``): on the card one launch
stores the frame into its slot, in the ring's layout and with the
reference's ``astype`` to the ring's dtype (``utils.dtypes.astype``: a float
truncates, then saturates; an integer into a narrower one wraps), with no
temporary of the frame: the full-frame kernel for a resize head, the
pointwise kernel for a plain or cropped frame, into a ring of any dtype of
``exec.cuda_batch_resize.TYPE_CODES`` (uint8, int8, uint16, int16, int32,
float16, float32). A ring's dtype is its canonical one, as the
reference's ``jnp.zeros`` gives it: ``np.float64`` makes a float32 ring,
``np.int64`` an int32 one (``utils.dtypes.canonical_dtype``). On the CPU an
update takes a temporary and a ``copy_``. ``read_batch``
returns a :class:`~..ops.memory.CircularBatchRead` over the raw ring whose
runtime ``first`` applies the logical order, and ``.tensor`` gathers the
ordered window into a new buffer.

Layouts: STANDARD (N, C, H, W), TRANSPOSED (C, N, H, W), PACKED (N, H, W, C).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..exec.cuda_batch_resize import OutShapeError
from ..exec.executor import build_pipeline, default_device, run_pipeline
from ..graph import ComputeOp, FusedCompute, IOp, ReadOp, WriteOp
from ..ops.memory import (CircularBatchRead, ImageRead, TensorSplit, TensorTSplit, TensorWrite,
                          Write2D)
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
        self.dtype = dt.canonical_dtype(dt.to_torch_dtype(dtype))
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
        return dt.gather(self._ring, lambda r: r.index_select(self._plane_axis(), perm))

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
        slot = self._count % self.batch
        if self.planes == ColorPlanes.PACKED:
            view, write = self._ring[slot], Write2D()           # (H, W, C)
        elif self.planes == ColorPlanes.STANDARD:
            view, write = self._ring[slot], TensorSplit()       # (C, H, W)
        else:
            view, write = self._ring[:, slot], TensorSplit()    # (C, H, W), strided
        pipeline = build_pipeline(read, *compute, write)
        if pipeline.read.batched:
            raise ValueError("update takes one frame, the read gives a batch of planes")
        try:
            run_pipeline(pipeline, device=self._ring.device, out=view)
        except OutShapeError as e:  # raised before anything launches
            raise ValueError(f"{e}: the ring holds "
                             f"{(self.height, self.width, self.channels)} planes") from None
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
    def from_state_dict(cls, d, device=None) -> "CircularTensor":
        """A ring holding the logical window of a :meth:`state_dict` (this
        class's or the reference's), as after ``batch`` updates."""
        logical = np.asarray(d["tensor"])
        ct = cls(width=int(d["width"]), height=int(d["height"]), channels=int(d["channels"]),
                 batch=int(d["batch"]), order=CircularTensorOrder(str(d["order"])),
                 planes=ColorPlanes(str(d["planes"])), dtype=logical.dtype, device=device)
        # the logical window goes back into slot order at count = batch
        ct._count = ct.batch
        phys = np.empty_like(logical)
        phys[(slice(None),) * ct._plane_axis() + (ct._slot_perm(ct.batch),)] = logical
        ct._ring.copy_(torch.from_numpy(phys))
        return ct

    @classmethod
    def load(cls, path: str, device=None) -> "CircularTensor":
        d = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        return cls.from_state_dict(d, device=device)
