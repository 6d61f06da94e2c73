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
stay in f32 registers, every op on an integer value is followed by a
saturation back to its dtype and every op on a float16 value (its scalar
rounded first) by a rounding to float16, as ``ops/arithmetic.py`` computes
them, and a colour conversion
may change the channel count. :func:`encode_chain` is shared by every
kernel of the port, which all interpret the table with ``csrc/chain.cuh``.
The kernels read every source dtype of ``SRC_DTYPES`` and store into every
dtype of ``TYPE_CODES``.
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
from ..utils.dtypes import as_device_tensor, kernel_source
from . import _build

#: launches of the CUDA kernel in this process
LAUNCHES = 0

# op codes; keep in step with csrc/chain.cuh
(OP_MUL, OP_ADD, OP_SUB, OP_DIV, OP_SAT_U8, OP_CAST_U8, OP_REORDER, OP_ALPHA, OP_GRAY_U8,
 OP_GRAY_F32, OP_SAT_I8, OP_SAT_U16, OP_SAT_I16, OP_CAST_I8, OP_CAST_U16,
 OP_CAST_I16, OP_CAST_F16, OP_GRAY_F16, OP_MUL_F16, OP_ADD_F16, OP_SUB_F16,
 OP_DIV_F16, OP_TRUNC_U8, OP_TRUNC_I8, OP_TRUNC_U16, OP_TRUNC_I16, OP_TRUNC_I32, OP_SAT_I32,
 OP_I32_F32, OP_WRAP_U8, OP_WRAP_I8, OP_WRAP_U16, OP_WRAP_I16, OP_GRAY_I32,
 OP_ALPHA_I32) = OP_CODES = tuple(range(1, 36))
_ARITH = {Mul: OP_MUL, Add: OP_ADD, Sub: OP_SUB, Div: OP_DIV}
# an op on a float16 value: the kernel rounds its scalar to float16 first, as
# the op's ``apply`` casts it to the value's dtype
_ARITH_F16 = {Mul: OP_MUL_F16, Add: OP_ADD_F16, Sub: OP_SUB_F16, Div: OP_DIV_F16}
# per dtype a chain may hold but float32, the row that brings a float32 value
# into it after an op or a SaturateCast (round half to even, saturate;
# float16's rounding), and the row of a Cast of a float32 or float16 value
# into it (truncate, saturate; float16's rounding). int32 is held as its
# bits, the others as their values.
_SAT = {torch.uint8: OP_SAT_U8, torch.int8: OP_SAT_I8, torch.uint16: OP_SAT_U16,
        torch.int16: OP_SAT_I16, torch.int32: OP_SAT_I32, torch.float16: OP_CAST_F16}
_TRUNC = {torch.uint8: OP_TRUNC_U8, torch.int8: OP_TRUNC_I8, torch.uint16: OP_TRUNC_U16,
          torch.int16: OP_TRUNC_I16, torch.int32: OP_TRUNC_I32, torch.float16: OP_CAST_F16}
# a Cast of an integer value into a narrower integer keeps the low bits: of a
# value held as a float32, and of int32's bits
_CAST = {torch.uint8: OP_CAST_U8, torch.int8: OP_CAST_I8, torch.uint16: OP_CAST_U16,
         torch.int16: OP_CAST_I16}
_WRAP = {torch.uint8: OP_WRAP_U8, torch.int8: OP_WRAP_I8, torch.uint16: OP_WRAP_U16,
         torch.int16: OP_WRAP_I16}
#: the dtypes a chain may hold, as a source, a cast target and an output:
#: each exact in a 32-bit register, int32 as its bits and the others as
#: float32 values, and one f32 op of two float16 values rounded to float16 is
#: the float16 op. int64 and float64 are not among them: the reference holds
#: them as int32 and float32 (``utils.dtypes.canonical_dtype``), and so does
#: the port from where they enter.
CHAIN_DTYPES = (torch.uint8, torch.int8, torch.uint16, torch.int16, torch.int32, torch.float16,
                torch.float32)
#: the dtypes of a chain's scalars, both exact in the f32 parameter block
_SCALAR_DTYPES = ("float32", "float16")
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
#: the element types of a source or an output buffer; keep in step with
#: csrc/chain.cuh (PW_U8 .. PW_I32)
TYPE_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3, torch.float32: 4,
              torch.float16: 5, torch.int32: 6}
#: the element types of a source: those, and int64 and float64 (PW_I64,
#: PW_F64), which a kernel reads at load as int32 (the low 32 bits) and
#: float32 (rounded to nearest), their canonical dtypes, and never stores
SRC_CODES = {**TYPE_CODES, torch.int64: 7, torch.float64: 8}
#: the source dtypes K1, K2, the warp kernel and the pointwise kernel read, by
#: name
SRC_DTYPES = {str(t).removeprefix("torch."): t for t in SRC_CODES}


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
    """A tensor leaf's dtype, a host leaf's canonical one (it is converted on
    its way to the device: ``utils.dtypes.as_device_tensor``)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return dt.canonical_dtype(np.asarray(leaf).dtype).name


def _n_leaves(o) -> int:
    return len(flatten(o)[1])


def _reorder_row(indices) -> List[int]:
    """Output channel ``k`` takes channel ``indices[k]``; the channel count
    becomes ``len(indices)``."""
    packed = sum(i << (4 * k) for k, i in enumerate(indices))
    return [OP_REORDER, 0, 0, packed | (len(indices) << 16)]


def cast_rows(src: torch.dtype, dst: torch.dtype, saturate: bool) -> List[List[int]]:
    """The rows of a ``SaturateCast`` (``saturate``) or a ``Cast`` of a value
    of ``src`` into ``dst``, both of ``CHAIN_DTYPES``, as
    ``utils.dtypes.saturate_cast`` and ``cast`` compute it: a float rounds
    half to even or truncates, then saturates; an integer saturates or keeps
    its low bits; into a float is exact through float32, then float16's
    rounding."""
    if src == dst:
        return []
    rows: List[int] = []
    if src == torch.int32:
        if dst.is_floating_point or saturate:
            # every int32 past 2^24 lies outside the narrower ranges either way
            rows = [OP_I32_F32]
            if dst != torch.float32:
                rows.append(_SAT[dst])
        else:
            rows = [_WRAP[dst]]
    elif dst != torch.float32:
        if saturate or dst in (torch.float16, torch.int32):
            rows = [(_SAT if saturate else _TRUNC)[dst]]
        else:
            rows = [(_TRUNC if src.is_floating_point else _CAST)[dst]]
    return [[code, 0, 0, 0] for code in rows]


def encode_chain(chain, nch: int, first_param: int = 0, dtype: torch.dtype = torch.float32):
    """``(ops, out_dtype, out_ch, n_params)`` for a chain applied to values
    of ``dtype`` (one of ``CHAIN_DTYPES``) with ``nch`` channels; the kernel
    holds them in 32-bit registers whatever the dtype (int32 as its bits).
    A cast to a dtype outside ``CHAIN_DTYPES`` and a scalar that is neither
    float32 nor float16 are refused. Parameter offsets count from
    ``first_param`` in the order :func:`~..graph.flatten` visits the leaves;
    ``n_params`` is the offset past the last one."""
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
            if _leaf_dtype_name(v) not in _SCALAR_DTYPES:
                raise Unsupported(f"{type(o).__name__} scalar is {_leaf_dtype_name(v)}, not "
                                  "float32 or float16")
            # an int32 value: to float32, the op, then its saturate back
            if dtype == torch.int32:
                rows.append([OP_I32_F32, 0, 0, 0])
            table = _ARITH_F16 if dtype == torch.float16 else _ARITH
            rows.append([table[type(o)], pos, 0 if size == 1 else 1, 0])
            if dtype != torch.float32:
                rows.append([_SAT[dtype], 0, 0, 0])
            return dtype, ch, pos + size
        if isinstance(o, (SaturateCast, Cast)):
            if o.dst not in CHAIN_DTYPES:
                raise Unsupported(f"cast to {o.dst}")
            rows.extend(cast_rows(dtype, o.dst, isinstance(o, SaturateCast)))
            return o.dst, ch, pos
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
                code = {torch.float32: OP_GRAY_F32, torch.float16: OP_GRAY_F16,
                        torch.int32: OP_GRAY_I32}.get(dtype, OP_GRAY_U8)
                rows.append([code, 0, 0, r | (g << 4) | (b << 8)])
                return dtype, 1, pos
            rows.append(_reorder_row(info[2]))
            if info[1] > len(info[2]):
                rows.append([OP_ALPHA_I32 if dtype == torch.int32 else OP_ALPHA, 0, 0,
                             int(alpha_fill(dtype))])
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
    src = kernel_source(read.source(), device).contiguous()
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


def store_cast(plan_dtype: torch.dtype, out_dtype: torch.dtype) -> int:
    """The row a kernel whose chain ends in ``plan_dtype`` runs after its
    chain to store into a buffer of ``out_dtype`` (both of ``TYPE_CODES``)
    as ``utils.dtypes.astype`` casts, or 0 for none. The store itself then
    moves the register: all 32 bits into a float32 or an int32 buffer (an
    int32 buffer shares float32's 4-byte store), a float16 rounded to nearest
    even, an integer truncated to its low bits.

    - 0: the same dtype; a float16 or a narrower integer into float32 (exact)
      or float16 (the store rounds); an integer into a narrower or a wider
      one of 8 or 16 bits (the store keeps the low bits: a wrap, or the value
      itself);
    - ``OP_TRUNC_*``: a float into an integer: truncate, then saturate, NaN
      to 0; also a narrower integer into int32 (exact);
    - ``OP_I32_F32``: int32 into a float buffer;
    - ``OP_WRAP_*``: int32 into a narrower integer: its low bits."""
    if plan_dtype == out_dtype:
        return 0
    if plan_dtype == torch.int32:
        return OP_I32_F32 if out_dtype.is_floating_point else _WRAP[out_dtype]
    if out_dtype == torch.int32 or (plan_dtype.is_floating_point and
                                    not out_dtype.is_floating_point):
        return _TRUNC[out_dtype]
    return 0


def can_store(plan, dtype: torch.dtype) -> bool:
    """Whether ``out=`` of this kernel's wrapper may hold ``dtype``: one of
    ``TYPE_CODES``, in any layout but ``SplitWrite``'s tuple."""
    return plan.layout != "split_write" and dtype in TYPE_CODES


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
    """The plain PyTorch version of the kernel on the same source (in its
    canonical dtype), rects and ``used_planes``: the eager resize, each chain
    op's own ``apply`` and the write op."""
    plan, p = a.plan, a.pipeline
    val = sample_batch(dt.canonicalize(a.src), a.rects, plan.dsize, plan.aspect_ratio,
                       p.read.background, a.used, stack_mode=plan.stack_mode)
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
    ``out`` (a view of the write's shape, any strides, any dtype of
    ``TYPE_CODES``, cast as :func:`store_cast` says) the result is stored
    there and ``out`` is returned."""
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
            a.src.data_ptr(), SRC_CODES[plan.src_dtype], plane_stride,
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
    _build.after_launch("batch_resize", dev)
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
