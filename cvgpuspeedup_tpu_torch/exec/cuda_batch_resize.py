"""The batched crop-resize kernel: plan, chain encoder, plain version, wrapper.

Counterpart of ``cvgpuspeedup_tpu/exec/pallas_backend.py``. One launch of
``csrc/batch_resize.cu`` computes a whole pipeline of the form

    BatchResizeRead -> pointwise chain -> write

:func:`build_plan` turns the pipeline's structure into a :class:`KernelPlan`
once: the chain becomes a table of op codes (``OPS`` rows of
``[code, param offset, param stride, aux]``) over one f32 parameter block
that starts with the background. :func:`prepare` gathers one call's runtime
arguments, packing every host leaf (rects, ``used_planes``, background and
chain scalars) into one buffer that reaches the device in one copy.
:func:`batch_resize` is the wrapper: on a CUDA tensor it launches the
kernel, on a CPU tensor it runs :func:`batch_resize_reference`, the plain
PyTorch version. The plain version runs the eager resize, each chain op's
own ``apply`` and the write op, and reads neither the op table nor the
parameter block, so holding the kernel against it also checks the encoder.

The chain's running dtype and channel count are tracked statically: values
stay in f32 registers, every op on a uint8 value is followed by a
saturation back to uint8, as ``ops/arithmetic.py`` does, and a colour
conversion may change the channel count. :func:`encode_chain` is shared
with the full-frame kernel (``cuda_frame_resize``); both kernels interpret
the table with ``csrc/chain.cuh``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph import FusedCompute, flatten
from ..ops.arithmetic import Add, Div, Mul, StaticLoop, Sub
from ..ops.cast import Cast, SaturateCast
from ..ops.color import _CODE_INFO, ColorConversion, VectorReorder, alpha_fill
from ..ops.memory import (SplitWrite, TensorSplit, TensorSplitPacked, TensorTSplit,
                          TensorWrite, Write2D, pack_factor)
from ..ops.resize import BatchResizeRead, sample_batch
from ..types import AspectRatio, InterpolationType, Size
from ..utils import dtypes as dt
from ..utils import bounds
from ..utils.dtypes import as_device_tensor
from . import _build

#: launches of the CUDA kernel in this process
LAUNCHES = 0

# op codes; keep in step with csrc/chain.cuh
(OP_MUL, OP_ADD, OP_SUB, OP_DIV, OP_SAT_U8, OP_CAST_U8, OP_REORDER, OP_ALPHA, OP_GRAY_U8,
 OP_GRAY_F32, OP_SAT_I8, OP_SAT_U16, OP_SAT_I16, OP_CAST_I8, OP_CAST_U16,
 OP_CAST_I16) = range(1, 17)
_ARITH = {Mul: OP_MUL, Add: OP_ADD, Sub: OP_SUB, Div: OP_DIV}
# the saturate and the truncate row of each integer dtype a chain may hold
_SAT = {torch.uint8: OP_SAT_U8, torch.int8: OP_SAT_I8, torch.uint16: OP_SAT_U16,
        torch.int16: OP_SAT_I16}
_CAST = {torch.uint8: OP_CAST_U8, torch.int8: OP_CAST_I8, torch.uint16: OP_CAST_U16,
         torch.int16: OP_CAST_I16}
#: the integer dtypes of the resampling kernels' chains, and of the pointwise
#: kernel's (the wide table of ``csrc/chain.cuh``): all exact in an f32 register
NARROW_INTS = (torch.uint8,)
WIDE_INTS = tuple(_SAT)
_MODES = {
    AspectRatio.IGNORE_AR: 0,
    AspectRatio.PRESERVE_AR: 1,
    AspectRatio.PRESERVE_AR_RN_EVEN: 2,
    AspectRatio.PRESERVE_AR_LEFT: 3,
}
_LAYOUTS = {
    TensorSplit: "split",
    TensorSplitPacked: "split_packed",
    TensorTSplit: "tsplit",
    TensorWrite: "packed",
    Write2D: "packed",
    SplitWrite: "split_write",
}
_MAX_CHANNELS = 4
_MAX_PLANES = 65535  # grid.z
#: the source dtypes the kernels read
SRC_DTYPES = {"uint8": torch.uint8, "float32": torch.float32}
#: the element types of an output buffer; keep in step with csrc/chain.cuh
TYPE_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3, torch.float32: 4}


class Unsupported(ValueError):
    """The kernel cannot run this pipeline."""


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Everything about one pipeline structure that the kernel needs."""

    n_planes: int
    nch: int
    out_ch: int
    dsize: Size
    aspect_ratio: AspectRatio
    stack_mode: bool
    src_dtype: torch.dtype
    out_dtype: torch.dtype
    layout: str
    ops: np.ndarray  # (n_ops, 4) int32
    n_fparams: int
    #: per-device copies of the op table and the default ``used_planes``
    device_consts: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def consts(self, device: torch.device):
        c = self.device_consts.get(device)
        if c is None:
            c = (
                torch.from_numpy(self.ops.reshape(-1).copy()).to(device),
                torch.full((1,), self.n_planes, dtype=torch.int32, device=device),
            )
            self.device_consts[device] = c
        return c


def _leaf_dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _n_leaves(o) -> int:
    return len(flatten(o)[1])


def _reorder_row(indices) -> List[int]:
    """Output channel ``k`` takes channel ``indices[k]``; the channel count
    becomes ``len(indices)``."""
    packed = sum(i << (4 * k) for k, i in enumerate(indices))
    return [OP_REORDER, 0, 0, packed | (len(indices) << 16)]


def encode_chain(chain, nch: int, first_param: int = 0, dtype: torch.dtype = torch.float32,
                 int_dtypes=NARROW_INTS):
    """``(ops, out_dtype, out_ch, n_params)`` for a chain applied to values
    of ``dtype`` (float32, or an integer dtype of ``int_dtypes`` read from
    such a source) with ``nch`` channels; the kernel holds them in f32
    registers either way. A cast to an integer dtype outside ``int_dtypes``
    is refused. Parameter offsets count from ``first_param`` in the order
    :func:`~..graph.flatten` visits the leaves; ``n_params`` is the offset
    past the last one."""
    rows: List[List[int]] = []

    def enc(o, dtype, ch, pos):
        if isinstance(o, FusedCompute):
            for sub in o.ops:
                dtype, ch, pos = enc(sub, dtype, ch, pos)
            return dtype, ch, pos
        if isinstance(o, StaticLoop):
            end = pos + _n_leaves(o.body)
            for _ in range(o.n):
                dtype, ch, _ = enc(o.body, dtype, ch, pos)
            return dtype, ch, end
        if type(o) in _ARITH:
            v = o.value
            shape = tuple(v.shape) if hasattr(v, "shape") else ()
            size = int(np.prod(shape)) if shape else 1
            if len(shape) > 1 or size not in (1, ch):
                raise Unsupported(f"{type(o).__name__} scalar of shape {shape} on {ch} channels")
            if _leaf_dtype_name(v) != "float32":
                raise Unsupported(f"{type(o).__name__} scalar is {_leaf_dtype_name(v)}, not float32")
            rows.append([_ARITH[type(o)], pos, 0 if size == 1 else 1, 0])
            if dtype != torch.float32:
                rows.append([_SAT[dtype], 0, 0, 0])
            return dtype, ch, pos + size
        if isinstance(o, (SaturateCast, Cast)):
            if o.dst == torch.float32:
                return torch.float32, ch, pos
            if o.dst in int_dtypes:
                if dtype != o.dst:
                    table = _SAT if isinstance(o, SaturateCast) else _CAST
                    rows.append([table[o.dst], 0, 0, 0])
                return o.dst, ch, pos
            raise Unsupported(f"cast to {o.dst}")
        if isinstance(o, VectorReorder):
            idx = tuple(o.indices)
            if len(idx) != ch or any(not 0 <= i < ch for i in idx):
                raise Unsupported(f"VectorReorder{idx} on {ch} channels")
            rows.append(_reorder_row(idx))
            return dtype, ch, pos
        if isinstance(o, ColorConversion):
            info = _CODE_INFO[o.code]
            if ch != info[0]:
                raise Unsupported(f"{o.code.name} on {ch} channels")
            if info[2] == "gray":
                r, g, b = info[3]
                code = OP_GRAY_F32 if dtype == torch.float32 else OP_GRAY_U8
                rows.append([code, 0, 0, r | (g << 4) | (b << 8)])
                return dtype, 1, pos
            rows.append(_reorder_row(info[2]))
            if info[1] > len(info[2]):
                rows.append([OP_ALPHA, 0, 0, int(alpha_fill(dtype))])
            return dtype, info[1], pos
        raise Unsupported(f"{type(o).__name__} has no op code")

    ch, pos = nch, first_param
    for o in chain:
        dtype, ch, pos = enc(o, dtype, ch, pos)
    ops = np.asarray(rows, np.int32).reshape(-1, 4)
    return ops, dtype, ch, pos


def build_plan(pipeline) -> KernelPlan:
    """The kernel plan of a pipeline; raises :class:`Unsupported`."""
    read = pipeline.read
    if not isinstance(read, BatchResizeRead):
        raise Unsupported(f"read is {type(read).__name__}, not BatchResizeRead")
    if read.interp != InterpolationType.INTER_LINEAR:
        raise Unsupported(f"interpolation {read.interp}")
    if type(pipeline.write) not in _LAYOUTS:
        raise Unsupported(f"write {type(pipeline.write).__name__}")
    stack_mode = read.frame is None
    src = read.stack if stack_mode else read.frame
    expect_rank = (2 if read.packed_channels else 3) + stack_mode
    if src.ndim != expect_rank:
        raise Unsupported(f"source of rank {src.ndim}, expected {expect_rank}")
    src_dtype = SRC_DTYPES.get(_leaf_dtype_name(src))
    if src_dtype is None:
        raise Unsupported(f"source dtype {_leaf_dtype_name(src)}")
    nch = read.source_dims()[2]
    if not 1 <= nch <= _MAX_CHANNELS:
        raise Unsupported(f"{nch} channels")
    n = read.num_planes
    if not 1 <= n <= _MAX_PLANES or tuple(read.rects.shape) != (n, 4):
        raise Unsupported(f"rects of shape {tuple(read.rects.shape)}")
    if stack_mode and src.shape[0] != n:
        raise Unsupported("stack and rects disagree on the plane count")
    # the background comes first in the parameter block
    ops, out_dtype, out_ch, n_fparams = encode_chain(pipeline.compute, nch, first_param=nch)
    return KernelPlan(
        n_planes=n, nch=nch, out_ch=out_ch, dsize=read.dsize, aspect_ratio=read.aspect_ratio,
        stack_mode=stack_mode, src_dtype=src_dtype, out_dtype=out_dtype,
        layout=_LAYOUTS[type(pipeline.write)], ops=ops, n_fparams=n_fparams,
    )


def supports(pipeline) -> bool:
    """Whether the kernel runs this pipeline (decided before any launch)."""
    try:
        build_plan(pipeline)
    except Unsupported:
        return False
    return True


@dataclasses.dataclass(frozen=True)
class Launch:
    """One call's arguments, every tensor on one device."""

    plan: KernelPlan
    pipeline: object       # the executor's Pipeline the arguments come from
    src: torch.Tensor      # frame (H, W, C) or stack (N, H, W, C), contiguous
    rects: torch.Tensor    # (N, 4) int32
    used: torch.Tensor     # (1,) int32
    fparams: torch.Tensor  # (n_fparams,) float32: background, then chain scalars
    ops: torch.Tensor      # (n_ops * 4,) int32


def prepare(pipeline, plan: KernelPlan, device: torch.device) -> Launch:
    """Gather one call's arguments on ``device``. Host leaves are packed into
    one int32 buffer and copied in one non-blocking transfer; device leaves
    stay where they are. Nothing here waits for the device."""
    read = pipeline.read
    src = as_device_tensor(read.source(), device).contiguous()
    ops, default_used = plan.consts(device)
    host: List[np.ndarray] = []
    slots: Dict[str, Tuple[int, int]] = {}

    def stage(name, arr):
        start = sum(a.size for a in host)
        host.append(arr)
        slots[name] = (start, arr.size)

    if isinstance(read.rects, torch.Tensor):
        rects = read.rects.to(torch.int32).contiguous()
    else:
        stage("rects", np.asarray(read.rects, np.int32).reshape(-1))
    if read.used_planes is None:
        used = default_used
    elif isinstance(read.used_planes, torch.Tensor):
        used = read.used_planes.to(torch.int32).reshape(1)
    else:
        stage("used", np.asarray(read.used_planes, np.int32).reshape(1))
    _, chain_leaves = flatten(tuple(pipeline.compute))
    fleaves = [read.background] + chain_leaves
    if any(isinstance(v, torch.Tensor) for v in fleaves):
        fparams = torch.cat([
            as_device_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v, np.float32),
                             device).to(torch.float32).reshape(-1)
            for v in fleaves
        ])
    else:
        packed = np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in fleaves])
        stage("fparams", packed.view(np.int32))
    if host:
        buf = as_device_tensor(np.concatenate(host), device)

        def take(name):
            start, size = slots[name]
            return buf[start:start + size]

        if "rects" in slots:
            rects = take("rects").view(-1, 4)
        if "used" in slots:
            used = take("used")
        if "fparams" in slots:
            fparams = take("fparams").view(torch.float32)
    return Launch(plan=plan, pipeline=pipeline, src=src, rects=rects, used=used,
                  fparams=fparams, ops=ops)


def store_cast(plan_dtype: torch.dtype, out_dtype: torch.dtype) -> Optional[int]:
    """How a kernel whose chain ends in ``plan_dtype`` stores into a buffer
    of ``out_dtype`` as ``utils.dtypes.astype`` casts it: 0 as it is (the
    same dtype, or an integer into float32, which is exact), 1 clamped to
    the buffer's range and then truncated (float32 into an integer: the
    ``clamp_store`` of every kernel but the divergent one, which has its
    own), None where no store does it (an integer into another integer
    wraps)."""
    if plan_dtype == out_dtype or out_dtype == torch.float32:
        return 0
    if plan_dtype == torch.float32 and not out_dtype.is_floating_point:
        return 1
    return None


def can_store(plan, dtype: torch.dtype) -> bool:
    """Whether ``out=`` of this kernel's wrapper may hold ``dtype``: one of
    ``TYPE_CODES`` that the store reaches (:func:`store_cast` is not None)."""
    return (plan.layout != "split_write" and dtype in TYPE_CODES
            and store_cast(plan.out_dtype, dtype) is not None)


class OutShapeError(ValueError):
    """``out=`` does not have the shape the pipeline produces."""


def check_out(out, shape, device) -> None:
    """``out=`` of a kernel wrapper: a tensor view of the write's shape on
    the launch's device, of any strides."""
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"out must be a tensor, got {type(out).__name__}")
    if out.device != device:
        raise ValueError(f"out is on {out.device}, the source on {device}")
    if tuple(out.shape) != tuple(shape):
        raise OutShapeError(f"the pipeline produces {tuple(shape)}, out holds {tuple(out.shape)}")


def _alloc_out(plan, device, out=None):
    """``(buffer, (sn, sc, sy, sx), result)`` of the plan's write layout:
    a new contiguous buffer, or the caller's view ``out`` with its own
    element strides."""
    n, c = plan.n_planes, plan.out_ch
    w, h = plan.dsize
    f = pack_factor(h, w)
    # the buffer's shape and which of its axes are (plane, channel, row, col)
    if plan.layout in ("split", "split_packed"):
        shape, axes = (n, c, h, w), (0, 1, 2, 3)
    elif plan.layout in ("tsplit", "split_write"):
        shape, axes = (c, n, h, w), (1, 0, 2, 3)
    else:  # packed (N, H, W, C)
        shape, axes = (n, h, w, c), (0, 3, 1, 2)
    if out is None:
        buf = torch.empty(shape, dtype=plan.out_dtype, device=device)
    elif plan.layout == "split_write":
        raise ValueError("SplitWrite returns a tuple; out= takes one tensor")
    else:
        check_out(out, (n, c, h // f, f * w) if plan.layout == "split_packed" else shape, device)
        buf = out.view(shape)
    strides = tuple(buf.stride(a) for a in axes)
    if out is not None:
        result = out
    elif plan.layout == "split_packed":
        result = buf.view(n, c, h // f, f * w)
    elif plan.layout == "split_write":
        result = tuple(buf.unbind(0))
    else:
        result = buf
    return buf, strides, result


def batch_resize_reference(a: Launch):
    """The plain PyTorch version of the kernel on the same source, rects and
    ``used_planes``: the eager resize, each chain op's own ``apply`` and the
    write op."""
    plan, p = a.plan, a.pipeline
    val = sample_batch(a.src, a.rects, plan.dsize, plan.aspect_ratio, p.read.background, a.used,
                       stack_mode=plan.stack_mode)
    for o in p.compute:
        val = o.apply(val)
    return p.write.write(val)


def _check(a: Launch) -> None:
    plan = a.plan
    dev = a.src.device
    for name, t, dtype in (("rects", a.rects, torch.int32), ("used", a.used, torch.int32),
                           ("fparams", a.fparams, torch.float32), ("ops", a.ops, torch.int32),
                           ("src", a.src, plan.src_dtype)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the source on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    n = plan.n_planes
    if tuple(a.rects.shape) != (n, 4) or a.used.numel() != 1:
        raise ValueError("rects must be (N, 4) and used_planes one value")
    if a.fparams.numel() != plan.n_fparams or a.ops.numel() != plan.ops.size:
        raise ValueError("parameter block does not match the plan")
    rank = 4 if plan.stack_mode else 3
    if a.src.ndim != rank or a.src.shape[-1] != plan.nch or (plan.stack_mode and a.src.shape[0] != n):
        raise ValueError(f"source of shape {tuple(a.src.shape)} does not match the plan")


def reference_into(result, out, device):
    """A plain version's ``result`` stored into the view ``out``, cast as
    ``utils.dtypes.astype`` casts (the CPU side of a wrapper's ``out=``)."""
    if isinstance(result, tuple):
        raise ValueError("SplitWrite returns a tuple; out= takes one tensor")
    check_out(out, result.shape, device)
    out.copy_(dt.astype(result, out.dtype))
    return out


def check_out_dtype(name: str, plan, out) -> None:
    if out is not None and not can_store(plan, out.dtype):
        raise TypeError(f"out is {out.dtype}; {name} cannot store {plan.out_dtype} values of a "
                        f"{plan.layout} write into it")


def batch_resize(a: Launch, out: Optional[torch.Tensor] = None):
    """The kernel wrapper: launches on a CUDA tensor, runs the plain version
    on a CPU tensor, raises on anything else. It never falls back. With
    ``out`` (a view of the write's shape, any strides, the plan's dtype or
    float32, or an integer dtype for a float32 chain, clamped then
    truncated) the result is stored there and ``out`` is returned."""
    global LAUNCHES
    dev = a.src.device
    if dev.type == "cpu":
        result = batch_resize_reference(a)
        return result if out is None else reference_into(result, out, dev)
    if dev.type != "cuda":
        raise ValueError(f"batch_resize runs on CUDA or CPU tensors, not {dev}")
    _check(a)
    lib = _build.load()
    plan = a.plan
    check_out_dtype("batch_resize", plan, out)
    buf, (sn, sc, sy, sx), result = _alloc_out(plan, dev, out)
    w, h = plan.dsize
    src_h, src_w = a.src.shape[-3], a.src.shape[-2]
    plane_stride = src_h * src_w * plan.nch if plan.stack_mode else 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cvgs_batch_resize(
            a.src.data_ptr(), int(plan.src_dtype == torch.uint8), plane_stride,
            src_h, src_w, plan.nch,
            a.rects.data_ptr(), a.used.data_ptr(), a.fparams.data_ptr(), a.ops.data_ptr(),
            plan.ops.shape[0], plan.n_planes, w, h, _MODES[plan.aspect_ratio],
            buf.data_ptr(), TYPE_CODES[buf.dtype], plan.out_ch,
            store_cast(plan.out_dtype, buf.dtype), sn, sc, sy, sx, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"batch_resize launch failed: CUDA error {err} ({lib.cvgs_error_string(err).decode()})"
        )
    LAUNCHES += 1
    return result


def run(pipeline, plan: KernelPlan, device: torch.device, out=None):
    """One call of the kernel path: gather the arguments, launch."""
    return batch_resize(prepare(pipeline, plan, device), out)


#: the wrapper, under the name every kernel module gives it
launch = batch_resize


def work(a: Launch) -> Tuple[int, int, int]:
    """``(output bytes, source bytes touched, float32 operations)`` of one
    launch (``utils.bounds``): 12 operations per value for the three lerps,
    one per chain row."""
    out_bytes, values = bounds.output(a.plan)
    return (out_bytes, bounds.crop_touched_bytes(a.pipeline.read),
            values * (12 + a.plan.ops.shape[0]))
