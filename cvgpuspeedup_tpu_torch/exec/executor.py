"""The executor: ``build_pipeline``, ``execute_operations`` and the plan cache.

Counterpart of ``cvgpuspeedup_tpu/exec/executor.py:70-276``. A pipeline's
structure (op classes, static fields, leaf shapes and dtypes) is its
``flatten`` key; its runtime values (frames, rects, scalars) are leaves. The
first call with a given structure, device type and backend request builds a
plan: the backend choice and, for a kernel, its op-code table, parameter
layout and tables. Every later call with new values reuses it.
``PLAN_BUILDS`` counts the builds.

Devices: tensor leaves stay on their own device and must all share one.
Numpy and Python leaves move to ``device``, which defaults to the device of
the tensor leaves and, where there is none, to the current CUDA device: a
pipeline of host arrays runs on the card, raises where there is no card, and
runs on the CPU only with ``device="cpu"``. Backends: ``AUTO`` tries, for a CUDA
pipeline, the batched crop-resize kernel (``cuda:batch_resize``), the
full-frame resize kernel (``cuda:frame_resize``), the warp kernel
(``cuda:warp``, single and batched warps), then the pointwise kernel
(``cuda:pointwise``: every head that reads one source pixel per output
pixel), so that a pipeline is one launch; it takes the eager PyTorch version
(one launch per op) only for what an f32 register cannot hold: int32, int64,
float16 and float64 values and chain scalars that are not float32. An
explicit ``ParBackend.CUDA`` raises where no kernel can run. Nothing falls
back from a failed build or launch.

The divergent launcher (``build_operation_sequence``,
``launch_divergent_batch``, ``executor.py:282-396`` of the reference) runs
different sequences on different planes of one batch: on CUDA tensors in one
launch of the divergent kernel (``cuda:divergent``), else through the eager
merge (``torch:divergent``). Its plans are keyed on the sequences'
structure, the plane ids, the device type and the backend request.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..graph import (ComputeOp, FusedCompute, FusedRead, IOp, PendingReadOp, ReadOp, WriteOp,
                     flatten, map_leaves, op)
from ..ops.memory import ImageRead, Write2D
from ..types import ParBackend
from ..utils.dtypes import as_device_tensor
from . import (cuda_batch_resize, cuda_divergent, cuda_frame_resize, cuda_pointwise,
               cuda_warp)

__all__ = [
    "Pipeline",
    "build_pipeline",
    "build_operation_sequence",
    "execute_operations",
    "launch_divergent_batch",
    "clear_cache",
    "describe_backend",
    "last_backend",
    "run_pipeline",
    "meta_lower",
]


@op
class Pipeline:
    """A normalized pipeline: read head, pointwise chain, write tail."""

    read: ReadOp
    compute: Tuple[ComputeOp, ...]
    write: WriteOp

    def lower(self):
        """The eager PyTorch version of the whole pipeline."""
        x = self.read.lower()
        for o in self.compute:
            x = o.apply(x)
        return self.write.write(x)


def build_pipeline(*iops: IOp, input=None) -> Pipeline:
    """Normalize a user op list into a :class:`Pipeline`.

    ``input=`` supplies the source when the first op is not a read; rank-4
    sources are batched (N, H, W, C). A missing terminal write defaults to
    the packed layout.
    """
    ops_list = list(iops)
    if input is not None:
        if ops_list and isinstance(ops_list[0], ReadOp):
            raise ValueError("pass either an input array or a leading read op, not both")
        ops_list.insert(0, ImageRead(data=input, is_batch=(input.ndim == 4)))
    if not ops_list or not isinstance(ops_list[0], ReadOp):
        raise ValueError("pipeline needs a read op or an input array at its head")
    read = ops_list[0]

    if isinstance(ops_list[-1], WriteOp):
        write = ops_list[-1]
        middle = ops_list[1:-1]
    else:
        write = Write2D()
        middle = ops_list[1:]

    compute: list = []
    for o in middle:
        if isinstance(o, PendingReadOp):
            if compute:
                read = FusedRead(read=read, chain=tuple(compute))
                compute = []
            read = o.bind(read)
        elif isinstance(o, FusedCompute):
            compute.extend(o.ops)
        elif isinstance(o, ComputeOp):
            compute.append(o)
        else:
            raise TypeError(f"mid-pipeline ops must be compute ops, got {type(o).__name__}")
    return Pipeline(read=read, compute=tuple(compute), write=write)


@dataclasses.dataclass(frozen=True)
class _Plan:
    backend: str     # "torch" or the name of a kernel in _KERNELS
    kernel: object   # the kernel module's plan, None for "torch"
    module: object   # the kernel module (its ``run`` takes the plan), None for "torch"


#: the kernels, in the order the executor tries them
_KERNELS = (("cuda:batch_resize", cuda_batch_resize), ("cuda:frame_resize", cuda_frame_resize),
            ("cuda:warp", cuda_warp), ("cuda:pointwise", cuda_pointwise))
_TORCH = _Plan("torch", None, None)


_PLANS: Dict[Tuple, _Plan] = {}
#: plane counts of divergent batches, by the sequences' structure
_PLANE_COUNTS: Dict[Tuple, int] = {}
#: plans built in this process; a call with new values only must not add one
PLAN_BUILDS = 0
_LAST_BACKEND: Optional[str] = None


def clear_cache() -> None:
    _PLANS.clear()
    _PLANE_COUNTS.clear()


def meta_lower(read: ReadOp):
    """A read's value with shapes only: an image's lowering is a view; any
    other read is lowered with every leaf on the meta device, which computes
    nothing and reads nothing back from a card."""
    if isinstance(read, ImageRead):
        return read.lower()
    meta = torch.device("meta")
    return map_leaves(read, lambda v: v.to(meta) if isinstance(v, torch.Tensor)
                      else as_device_tensor(v, meta)).lower()


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is the current CUDA device. A
    CUDA device where there is none raises: nothing runs on the CPU unless
    the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device is available; "
                               'pass device="cpu" to run on the CPU')
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _resolve_device(leaves, device) -> torch.device:
    devices = {v.device for v in leaves if isinstance(v, torch.Tensor)}
    if device is None and devices:
        if len(devices) > 1:
            raise ValueError(f"pipeline leaves lie on several devices: {sorted(map(str, devices))}")
        return devices.pop()
    dev = default_device(device)
    stray = [str(d) for d in devices if d != dev]
    if stray:
        raise ValueError(f"pipeline leaves on {sorted(stray)} cannot run on {dev}")
    return dev


def _select(pipeline: Pipeline, backend: ParBackend, dev: torch.device) -> _Plan:
    """The backend decision, made before anything launches."""
    if backend == ParBackend.TORCH:
        return _TORCH
    if backend == ParBackend.CUDA and dev.type != "cuda":
        raise ValueError(f"ParBackend.CUDA needs CUDA tensors, the pipeline is on {dev}")
    if dev.type != "cuda":
        return _TORCH
    refusals = []
    for name, module in _KERNELS:
        try:
            return _Plan(name, module.build_plan(pipeline), module)
        except module.Unsupported as e:
            refusals.append(f"{name}: {e}")
    if backend == ParBackend.CUDA:
        raise ValueError(f"ParBackend.CUDA cannot run this pipeline: {'; '.join(refusals)}")
    return _TORCH


def _plan(pipeline: Pipeline, key, backend: ParBackend, dev: torch.device) -> _Plan:
    global PLAN_BUILDS
    cache_key = (key, dev.type, backend)
    plan = _PLANS.get(cache_key)
    if plan is None:
        plan = _select(pipeline, backend, dev)
        PLAN_BUILDS += 1
        _PLANS[cache_key] = plan
    return plan


def describe_backend(*iops: IOp, input=None, backend: ParBackend = ParBackend.AUTO,
                     device=None) -> str:
    """Which backend :func:`execute_operations` would run for this op list:
    ``"cuda:batch_resize"``, ``"cuda:frame_resize"``, ``"cuda:warp"``,
    ``"cuda:pointwise"`` or ``"torch"``."""
    pipeline = build_pipeline(*iops, input=input)
    _, leaves = flatten(pipeline)
    return _select(pipeline, backend, _resolve_device(leaves, device)).backend


def last_backend() -> Optional[str]:
    """The backend of the most recent :func:`execute_operations` call in this
    process (None before any)."""
    return _LAST_BACKEND


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches in this process so far (its ``LAUNCHES``), by
    the backend name :func:`last_backend` reports for it."""
    return {name: module.LAUNCHES for name, module in
            _KERNELS + (("cuda:divergent", cuda_divergent),)}


def execute_operations(*iops: IOp, input=None, backend: ParBackend = ParBackend.AUTO,
                       device=None):
    """Run the op chain. Returns the output tensor (or a tuple of tensors for
    ``SplitWrite``). On the kernel path the work is queued on the current
    CUDA stream and the call returns without waiting for it. ``device``
    defaults to the tensor leaves' device and, with host arrays only, to
    the current CUDA device (:func:`default_device`)."""
    return run_pipeline(build_pipeline(*iops, input=input), backend, device)


def run_pipeline(pipeline: Pipeline, backend: ParBackend = ParBackend.AUTO, device=None,
                 out: Optional[torch.Tensor] = None):
    """Run a built pipeline; what :func:`execute_operations` does after
    ``build_pipeline``. With ``out``, a tensor view of the write's shape (of
    any strides: a ring slot), the result is stored there, cast as
    ``utils.dtypes.astype`` casts: by the kernel's own store, in the same
    launch, wherever its store reaches ``out``'s dtype, else through a
    temporary and a ``copy_``."""
    global _LAST_BACKEND
    key, leaves = flatten(pipeline)
    dev = _resolve_device(leaves, device)
    plan = _plan(pipeline, key, backend, dev)
    _LAST_BACKEND = plan.backend
    if plan.kernel is None:
        result = map_leaves(pipeline, lambda v: as_device_tensor(v, dev)).lower()
    elif out is None or plan.module.can_store(plan.kernel, out.dtype):
        return plan.module.run(pipeline, plan.kernel, dev, out)
    else:
        result = plan.module.run(pipeline, plan.kernel, dev)
    if out is None:
        return result
    return cuda_batch_resize.reference_into(result, out, dev)


def build_operation_sequence(*iops: IOp) -> Pipeline:
    """One per-plane operation sequence (``fk::buildOperationSequence``)."""
    return build_pipeline(*iops)


def _plane_ids(selector, n_planes: int, n_seqs: int) -> Tuple[int, ...]:
    if callable(selector):
        ids = tuple(int(selector(z)) for z in range(n_planes))
    else:
        ids = tuple(int(i) for i in selector)
        if len(ids) != n_planes:
            raise ValueError(f"selector list has {len(ids)} entries for {n_planes} planes")
    for z, sid in enumerate(ids):
        if not 1 <= sid <= n_seqs:
            raise ValueError(f"selector({z}) = {sid} out of range")
    return ids


def _select_divergent(seqs, plane_ids, backend: ParBackend, dev: torch.device) -> _Plan:
    """The divergent backend decision, made before anything launches."""
    if backend == ParBackend.TORCH:
        return _Plan("torch:divergent", None, None)
    if backend == ParBackend.CUDA and dev.type != "cuda":
        raise ValueError(f"ParBackend.CUDA needs CUDA tensors, the batch is on {dev}")
    if dev.type != "cuda":
        return _Plan("torch:divergent", None, None)
    try:
        return _Plan("cuda:divergent", cuda_divergent.build_plan(seqs, plane_ids), cuda_divergent)
    except cuda_divergent.Unsupported as e:
        if backend == ParBackend.CUDA:
            raise ValueError(f"ParBackend.CUDA cannot run this divergent batch: {e}") from e
    return _Plan("torch:divergent", None, None)


def launch_divergent_batch(selector: Union[Callable[[int], int], Sequence[int]],
                           *sequences: Pipeline, backend: ParBackend = ParBackend.AUTO,
                           device=None):
    """Run different op sequences on different planes of one batch.

    ``selector(z)`` gives the 1-based sequence id of plane ``z``
    (``SequenceSelector::at``); a list of ids may be passed instead. The
    plane count is the first sequence's, from shapes alone. Each sequence
    computes only its own planes; the merged batch takes the dtype of plane
    0's sequence (other values are cast to it by clamping, then
    truncating) and the first sequence's write layout. On CUDA tensors it is
    one launch of the divergent kernel; returns without waiting for it.
    ``device`` defaults as in :func:`execute_operations`.
    """
    global PLAN_BUILDS, _LAST_BACKEND
    if not sequences:
        raise ValueError("need at least one operation sequence")
    seqs = tuple(sequences)
    key, leaves = flatten(seqs)
    n_planes = _PLANE_COUNTS.get(key)
    if n_planes is None:
        n_planes = _PLANE_COUNTS[key] = int(meta_lower(seqs[0].read).shape[0])
    plane_ids = _plane_ids(selector, n_planes, len(seqs))
    dev = _resolve_device(leaves, device)
    cache_key = (key, "divergent", plane_ids, dev.type, backend)
    plan = _PLANS.get(cache_key)
    if plan is None:
        plan = _select_divergent(seqs, plane_ids, backend, dev)
        PLAN_BUILDS += 1
        _PLANS[cache_key] = plan
    _LAST_BACKEND = plan.backend
    if plan.kernel is None:
        return cuda_divergent.merge(map_leaves(seqs, lambda v: as_device_tensor(v, dev)),
                                    plane_ids)
    return plan.module.run(seqs, plan.kernel, dev)
