"""The batch (plane) axis of a fused pipeline sharded over a device mesh.

Counterpart of ``cvgpuspeedup_tpu/parallel/mesh.py``. The reference runs one
``shard_map`` program over a ``jax.sharding.Mesh`` from a single controller;
PyTorch runs one process per card (``torchrun --nproc-per-node=N``), each
with its rank on a one-dimensional ``DeviceMesh``. The semantics are the
reference's: each rank runs the SAME fused kernel on its slice of the planes
(each plane's pipeline is independent of the others), and nothing is
gathered unless the caller asks (``DTensor.full_tensor()``).

Rank ``index`` of ``nsh`` owns planes ``[index*ln, (index+1)*ln)``, ``ln =
N / nsh``. Its local pipeline (:func:`_local_pipeline`):

- per-plane leaves are sliced: ``rects`` and ``stack`` of a
  ``BatchResizeRead``, ``data`` of a batched ``ImageRead``, the ``ops`` of a
  ``BatchRead``;
- shared leaves are not copied: the frame, the chain scalars, a source that
  is the same object on every plane of a ``BatchRead``;
- a ragged ``used_planes`` is rebased to ``clip(used - index*ln, 0, ln)``,
  on the host for a host value and by ``torch.clamp`` on the device for a
  tensor, so that nothing waits for the device;
- a ``CircularBatchRead`` becomes :class:`_LocalRingView`: the whole ring,
  ``first`` moved by ``index*ln`` (back for a descending ring), ``ln``
  output planes.

Every rank's local pipeline has the same structure key (``graph.flatten``),
so one plan serves every rank; only runtime values differ. The output is a
``DTensor`` made with ``from_local`` and the global shape, sharded on the
write layout's plane axis: no collective and no synchronisation per call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from ..exec.executor import (Pipeline, _plane_ids, build_pipeline, launch_divergent_batch,
                             meta_lower, run_pipeline)
from ..graph import IOp, flatten, op, static_field
from ..ops.memory import BatchRead, CircularBatchRead, ImageRead, TensorTSplit
from ..ops.resize import BatchResizeRead
from ..types import ParBackend

__all__ = ["initialize_distributed", "make_mesh", "execute_sharded",
           "execute_divergent_sharded", "scaling_efficiency"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device_type: str = "cuda",
) -> DeviceMesh:
    """Join the process group and return the batch mesh over all of it.

    Arguments not given come from the environment as ``torchrun`` sets it:
    ``RANK``, ``WORLD_SIZE`` and, with no ``coordinator_address``,
    ``MASTER_ADDR`` and ``MASTER_PORT``. ``coordinator_address`` is
    ``host:port`` or an ``init_method`` URL (``tcp://``, ``file://``). On the
    card (the default) the group is NCCL and the process takes the card
    ``LOCAL_RANK`` (else its rank modulo the cards); ``device_type="cpu"``
    runs gloo on the CPU.
    """
    env = os.environ
    rank = int(env["RANK"] if process_id is None else process_id)
    world = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass device_type="cpu" to run on '
                               "the CPU")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return make_mesh(device_type=device_type)


def make_mesh(n: Optional[int] = None, axis: str = "batch",
              device_type: str = "cuda") -> DeviceMesh:
    """A one-dimensional mesh named ``axis`` over every rank of the process
    group (which ``init_device_mesh`` joins from the environment where it
    does not exist yet). The reference's ``make_mesh(n)`` takes the first
    ``n`` devices; here ``n`` must be the world size: a process outside the
    mesh would have no planes."""
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: the batch mesh spans "
                         "every rank")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


@op
class _LocalRingView(CircularBatchRead):
    """One rank's planes of a replicated ring: ``local_n`` output planes
    from ``first``, taken modulo the whole ring. Lowers, and runs in the
    pointwise and divergent kernels, as its base class does."""

    local_n: int = static_field(default=1)

    @property
    def num_planes(self) -> int:
        return self.local_n


def _plane_count(read) -> int:
    """The plane count of a read ``execute_sharded`` can shard; raises the
    reference's exception for any other."""
    if not read.batched:
        raise ValueError("execute_sharded needs a batched read op")
    if isinstance(read, (ImageRead, CircularBatchRead)):
        return int(read.data.shape[0])
    if isinstance(read, BatchResizeRead):
        return read.num_planes
    if isinstance(read, BatchRead):
        if len({flatten(o)[0] for o in read.ops}) != 1:
            raise NotImplementedError(
                "BatchRead sharding needs structurally identical sub-reads "
                "(same op types and static fields on every plane)")
        return len(read.ops)
    raise NotImplementedError(
        f"sharding of {type(read).__name__} is not supported (its plane semantics are not a "
        "plain partition)")


def _local_count(n_planes: int, nsh: int) -> int:
    if n_planes % nsh:
        raise ValueError(f"plane count {n_planes} must divide mesh size {nsh}")
    return n_planes // nsh


def _rebase_used(used, start: int, ln: int):
    """A global ragged count as one rank's."""
    if used is None:
        return None
    if isinstance(used, torch.Tensor):
        return torch.clamp(used - start, 0, ln)
    used = np.asarray(used)
    return np.clip(used - start, 0, ln).astype(used.dtype)


def _shift(first, off: int):
    """``first + off`` in ``first``'s own kind and dtype."""
    if isinstance(first, torch.Tensor):
        return first + off
    first = np.asarray(first)
    return (first + off).astype(first.dtype)


def _local_pipeline(pipeline: Pipeline, index: int, nsh: int,
                    n_planes: Optional[int] = None) -> Pipeline:
    """The pipeline of rank ``index`` of ``nsh``: its ``ln`` planes of the
    ``n_planes`` (the read's own count unless given: a divergent batch's
    sequences share the first one's)."""
    read = pipeline.read
    own = _plane_count(read)  # refuses what cannot be sharded
    ln = _local_count(own if n_planes is None else n_planes, nsh)
    s, e = index * ln, (index + 1) * ln
    if isinstance(read, ImageRead):
        read = dataclasses.replace(read, data=read.data[s:e])
    elif isinstance(read, BatchResizeRead):
        read = dataclasses.replace(
            read, rects=read.rects[s:e], stack=None if read.stack is None else read.stack[s:e],
            used_planes=_rebase_used(read.used_planes, s, ln))
    elif isinstance(read, BatchRead):
        read = dataclasses.replace(read, ops=read.ops[s:e],
                                   used_planes=_rebase_used(read.used_planes, s, ln))
    else:
        read = _LocalRingView(data=read.data, first=_shift(read.first, s if read.ascendent else -s),
                              ascendent=read.ascendent, packed_channels=read.packed_channels,
                              local_n=ln)
    return dataclasses.replace(pipeline, read=read)


def _coords(mesh: DeviceMesh) -> Tuple[int, int]:
    """``(index, nsh)`` of this process on the mesh's batch axis."""
    axis = mesh.mesh_dim_names[0]
    return mesh.get_local_rank(axis), mesh.size(0)


def _as_dtensor(local: torch.Tensor, mesh: DeviceMesh, dim: int) -> DTensor:
    """The global tensor whose shard ``dim`` this rank holds, from the local
    one and the global shape: no collective checks it."""
    shape = list(local.shape)
    shape[dim] *= mesh.size(0)
    stride, acc = [], 1
    for d in reversed(shape):
        stride.insert(0, acc)
        acc *= d
    return DTensor.from_local(local, mesh, [Shard(dim)], run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _sharded(out, mesh: DeviceMesh, write):
    """The local output as DTensors on the write layout's plane axis:
    ``TensorTSplit``'s (C, N, H, W) on axis 1, ``SplitWrite``'s buffers
    each on axis 0, every other layout on axis 0."""
    if isinstance(out, tuple):
        return tuple(_as_dtensor(o, mesh, 0) for o in out)
    return _as_dtensor(out, mesh, 1 if isinstance(write, TensorTSplit) else 0)


def execute_sharded(*iops: IOp, mesh: DeviceMesh, input=None,
                    backend: ParBackend = ParBackend.AUTO):
    """Run a batched fused pipeline with its plane axis sharded over
    ``mesh``: this process runs its rank's planes, one launch of the kernel
    the pipeline takes, on the mesh's device type (host leaves move there).

    The plane count must divide the mesh size. Returns a ``DTensor`` (a
    tuple of them for ``SplitWrite``) sharded on the plane axis; each
    process holds its own planes, ``full_tensor()`` gathers them.
    """
    pipeline = build_pipeline(*iops, input=input)
    index, nsh = _coords(mesh)
    local = _local_pipeline(pipeline, index, nsh)
    return _sharded(run_pipeline(local, backend, mesh.device_type), mesh, pipeline.write)


def execute_divergent_sharded(selector, *sequences: Pipeline, mesh: DeviceMesh,
                              backend: ParBackend = ParBackend.AUTO):
    """A divergent batch (``launch_divergent_batch``) sharded over the
    mesh's plane axis: this process runs its rank's planes of every
    sequence in ONE launch. Its plane ids are its slice of the global map;
    a plan is built once per distinct local routing. Plane stacks and rects
    are sliced, shared frames stay shared, rings become rank views.
    ``BatchRead`` sequences (warps, NV12 cameras) are refused, as in the
    reference.
    """
    if not sequences:
        raise ValueError("need at least one operation sequence")
    seqs = tuple(sequences)
    n_planes = int(meta_lower(seqs[0].read).shape[0])
    plane_ids = _plane_ids(selector, n_planes, len(seqs))
    index, nsh = _coords(mesh)
    ln = _local_count(n_planes, nsh)
    for seq in seqs:
        if isinstance(seq.read, BatchRead):
            raise NotImplementedError(
                "sharded divergent BatchRead sequences are not supported (their per-plane "
                "structure is global-plane indexed); shard warp_batch via execute_sharded "
                "instead")
    local = tuple(_local_pipeline(seq, index, nsh, n_planes) for seq in seqs)
    out = launch_divergent_batch(plane_ids[index * ln:(index + 1) * ln], *local,
                                 backend=backend, device=mesh.device_type)
    return _sharded(out, mesh, seqs[0].write)


def scaling_efficiency(images_per_sec_n: float, images_per_sec_1: float, n: int) -> float:
    """Linear-scaling efficiency metric from the north star (>= 0.85 target)."""
    return images_per_sec_n / (n * images_per_sec_1)
