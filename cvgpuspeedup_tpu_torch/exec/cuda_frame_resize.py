"""The full-frame resize kernel: plan, plain version, wrapper.

Counterpart of ``cvgpuspeedup_tpu/exec/pallas_frame.py``. One launch of
``csrc/frame_resize.cu`` computes a whole pipeline of the form

    ResizeRead(ImageRead | NV12 read fused with a float YUV->RGB) -> chain -> write

:func:`build_plan` turns the pipeline's structure into a :class:`FramePlan`
once: the per-axis tap and weight tables of the geometry (the NV12 chroma
taps too), with the edge rule the reference applies to it
(``ops.resize.keeps_edge_weight``), and the chain's op table
(``cuda_batch_resize.encode_chain``). :func:`prepare` gathers one call's
arguments, the chain scalars in one pinned, non-blocking host copy.
:func:`frame_resize` is the wrapper: on a CUDA tensor it launches the kernel,
on a CPU tensor it runs :func:`frame_resize_reference`, the plain PyTorch
version: the eager ``ResizeRead.lower`` (which builds its own tap tables),
each chain op's own ``apply`` and the write op.

None of the TPU kernel's gates come over (source rows a multiple of 8,
lanes a multiple of 128, integer outputs only in an exact regime, a minimum
frame size): they exist for Mosaic's tiling and matmul association. Any
frame size the eager path takes, the kernel takes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..graph import flatten, map_leaves
from ..ops.memory import ImageRead, SplitWrite, TensorSplit, Write2D
from ..ops.nv12 import LIMITED_C, LIMITED_Y, conversion_coefficients
from ..ops.resize import ResizeRead, axis_taps, half_taps, keeps_edge_weight
from ..types import ColorRange, InterpolationType, PixelFormat, Size
from ..utils.dtypes import as_device_tensor
from ..utils import bounds
from . import _build
from .cuda_batch_resize import can_store  # noqa: F401  (the executor asks each kernel module)
from .cuda_batch_resize import (_MAX_CHANNELS, SRC_DTYPES, TYPE_CODES, Unsupported,
                                _leaf_dtype_name, check_out, check_out_dtype, encode_chain,
                                reference_into, store_cast)

#: launches of the CUDA kernel in this process
LAUNCHES = 0

_LAYOUTS = {Write2D: "packed", TensorSplit: "split", SplitWrite: "split_write"}


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Everything about one pipeline structure that the kernel needs."""

    yuv: bool              # an NV12/NV21 buffer, else a packed image
    nv21: bool
    src_h: int
    src_w: int
    nch: int               # source channels (1 for the luma of a YUV buffer)
    src_dtype: torch.dtype
    dsize: Size
    keep_edge: bool
    taps: np.ndarray       # int32 [x0 | x1 | y0 | y1] (+ [cx0 | cx1 | cy0 | cy1] for YUV)
    weights: np.ndarray    # float32 [wx | wy]
    conv: Tuple            # (limited, alpha, ys, cs, rv, gu, gv, bu) of the YUV->RGB
    out_ch: int
    out_dtype: torch.dtype
    layout: str
    ops: np.ndarray        # (n_ops, 4) int32
    n_fparams: int
    #: per-device copies of the op table, the taps and the weights
    device_consts: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def consts(self, device: torch.device):
        c = self.device_consts.get(device)
        if c is None:
            c = tuple(torch.from_numpy(a.reshape(-1).copy()).to(device)
                      for a in (self.ops, self.taps, self.weights))
            self.device_consts[device] = c
        return c


def _source(read: ResizeRead):
    """``(array, yuv_read_or_None, conversion_or_None)`` of a read the kernel
    takes; raises :class:`Unsupported`."""
    src = read.source
    if isinstance(src, ImageRead):
        if src.is_batch:
            raise Unsupported("a batched ImageRead is not one frame")
        return src.data, None, None
    commuted = read._commuted_source()
    if commuted is None:
        raise Unsupported(f"source {type(src).__name__} is neither an image nor a fused NV12 read")
    readop, conv = commuted
    return readop.buffer, readop, conv


def build_plan(pipeline) -> FramePlan:
    """The kernel plan of a pipeline; raises :class:`Unsupported`."""
    read = pipeline.read
    if not isinstance(read, ResizeRead):
        raise Unsupported(f"read is {type(read).__name__}, not ResizeRead")
    if read.interp != InterpolationType.INTER_LINEAR:
        raise Unsupported(f"interpolation {read.interp}")
    if type(pipeline.write) not in _LAYOUTS:
        raise Unsupported(f"write {type(pipeline.write).__name__}")
    data, readop, conv = _source(read)
    src_dtype = SRC_DTYPES.get(_leaf_dtype_name(data))
    shape = tuple(data.shape)
    if readop is None:
        pc = read.source.packed_channels
        if pc and len(shape) == 2:
            src_h, src_w, nch = shape[0], shape[1] // pc, pc
        elif not pc and len(shape) in (2, 3):
            src_h, src_w, nch = shape[0], shape[1], (shape[2] if len(shape) == 3 else 1)
        else:
            raise Unsupported(f"image of shape {shape}")
        if src_dtype is None:
            raise Unsupported(f"source dtype {data.dtype}")
        if not 1 <= nch <= _MAX_CHANNELS:
            raise Unsupported(f"{nch} channels")
        chain_in = nch
        conv_args = (0, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    else:
        if len(shape) == 3 and shape[2] == 1:
            shape = shape[:2]
        if len(shape) != 2 or src_dtype != torch.uint8:
            raise Unsupported(f"NV12 buffer of shape {tuple(data.shape)} and dtype {data.dtype}")
        total_rows, src_w = shape
        src_h = (total_rows * 2) // 3
        if src_h % 2 or src_w % 2 or src_h * 3 != total_rows * 2:
            raise Unsupported(f"NV12 buffer of shape {shape}")
        if conv.out_dtype != torch.float32:
            raise Unsupported(f"YUV->RGB to {conv.out_dtype}")
        nch = 1
        chain_in = 4 if conv.alpha else 3
        conv_args = (int(conv.color_range == ColorRange.LIMITED), int(conv.alpha),
                     LIMITED_Y, LIMITED_C, *conversion_coefficients(conv.standard))
    if src_h < 1 or src_w < 1:
        raise Unsupported("empty source")
    ops, out_dtype, out_ch, n_fparams = encode_chain(pipeline.compute, chain_in)
    dst_w, dst_h = read.dsize
    keep = keeps_edge_weight(src_h, src_w, read.dsize)
    tx, ty = axis_taps(src_w, dst_w, keep), axis_taps(src_h, dst_h, keep)
    tables = [tx[0], tx[1], ty[0], ty[1]]
    if readop is not None:
        tables += [*half_taps(tx[0], tx[1]), *half_taps(ty[0], ty[1])]
    return FramePlan(
        yuv=readop is not None,
        nv21=readop is not None and readop.pixel_format == PixelFormat.NV21,
        src_h=src_h, src_w=src_w, nch=nch, src_dtype=src_dtype, dsize=read.dsize,
        keep_edge=keep, taps=np.concatenate(tables).astype(np.int32),
        weights=np.concatenate([tx[2], ty[2]]).astype(np.float32), conv=conv_args,
        out_ch=out_ch, out_dtype=out_dtype, layout=_LAYOUTS[type(pipeline.write)], ops=ops,
        n_fparams=n_fparams,
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

    plan: FramePlan
    pipeline: object       # the executor's Pipeline the arguments come from
    src: torch.Tensor      # the image or NV12 buffer, contiguous
    fparams: torch.Tensor  # (n_fparams,) float32: the chain scalars
    ops: torch.Tensor      # (n_ops * 4,) int32
    taps: torch.Tensor     # int32, see FramePlan.taps
    weights: torch.Tensor  # float32, see FramePlan.weights


def prepare(pipeline, plan: FramePlan, device: torch.device) -> Launch:
    """Gather one call's arguments on ``device``. Host chain scalars are
    packed into one buffer and copied in one non-blocking transfer; device
    leaves stay where they are. Nothing here waits for the device."""
    data, _, _ = _source(pipeline.read)
    src = as_device_tensor(data, device).contiguous()
    ops, taps, weights = plan.consts(device)
    _, leaves = flatten(tuple(pipeline.compute))
    if not leaves:
        fparams = torch.empty(0, dtype=torch.float32, device=device)
    elif any(isinstance(v, torch.Tensor) for v in leaves):
        fparams = torch.cat([
            as_device_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v, np.float32),
                             device).to(torch.float32).reshape(-1)
            for v in leaves
        ])
    else:
        packed = np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in leaves])
        fparams = as_device_tensor(packed, device)
    return Launch(plan=plan, pipeline=pipeline, src=src, fparams=fparams, ops=ops, taps=taps,
                  weights=weights)


def frame_resize_reference(a: Launch):
    """The plain PyTorch version of the kernel on the same source: the eager
    ``ResizeRead.lower``, each chain op's own ``apply`` and the write op."""
    p = a.pipeline
    read = map_leaves(p.read, lambda _: a.src)  # the source is the read's one leaf
    val = read.lower()
    for o in p.compute:
        val = o.apply(val)
    return p.write.write(val)


def _alloc_out(plan, device, out=None):
    """``(buffer, (sc, sy, sx), result)`` of the plan's write layout: a new
    contiguous buffer, or the caller's view ``out`` with its own element
    strides."""
    c = plan.out_ch
    w, h = plan.dsize
    # the buffer's shape and which of its axes are (channel, row, col)
    shape, axes = ((h, w, c), (2, 0, 1)) if plan.layout == "packed" else ((c, h, w), (0, 1, 2))
    if out is None:
        buf = torch.empty(shape, dtype=plan.out_dtype, device=device)
    elif plan.layout == "split_write":
        raise ValueError("SplitWrite returns a tuple; out= takes one tensor")
    else:
        check_out(out, shape, device)
        buf = out
    strides = tuple(buf.stride(a) for a in axes)
    return buf, strides, (tuple(buf.unbind(0)) if plan.layout == "split_write" else buf)


def _check(a: Launch) -> None:
    plan = a.plan
    dev = a.src.device
    for name, t, dtype in (("fparams", a.fparams, torch.float32), ("ops", a.ops, torch.int32),
                           ("taps", a.taps, torch.int32), ("weights", a.weights, torch.float32),
                           ("src", a.src, plan.src_dtype)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the source on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if (a.fparams.numel() != plan.n_fparams or a.ops.numel() != plan.ops.size
            or a.taps.numel() != plan.taps.size or a.weights.numel() != plan.weights.size):
        raise ValueError("parameter block or tables do not match the plan")
    rows = plan.src_h * 3 // 2 if plan.yuv else plan.src_h
    if a.src.numel() != rows * plan.src_w * plan.nch or a.src.shape[0] != rows:
        raise ValueError(f"source of shape {tuple(a.src.shape)} does not match the plan")


def frame_resize(a: Launch, out: Optional[torch.Tensor] = None):
    """The kernel wrapper: launches on a CUDA tensor, runs the plain version
    on a CPU tensor, raises on anything else. It never falls back. With
    ``out`` (a view of the write's shape, any strides, the plan's dtype or
    float32, or an integer dtype for a float32 chain, clamped then
    truncated; a ring slot) the result is stored there and ``out`` is
    returned."""
    global LAUNCHES
    dev = a.src.device
    if dev.type == "cpu":
        result = frame_resize_reference(a)
        return result if out is None else reference_into(result, out, dev)
    if dev.type != "cuda":
        raise ValueError(f"frame_resize runs on CUDA or CPU tensors, not {dev}")
    _check(a)
    lib = _build.load()
    plan = a.plan
    check_out_dtype("frame_resize", plan, out)
    buf, (sc, sy, sx), result = _alloc_out(plan, dev, out)
    w, h = plan.dsize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cvgs_frame_resize(
            a.src.data_ptr(), int(plan.src_dtype == torch.uint8), plan.src_h, plan.src_w,
            plan.nch, int(plan.yuv), int(plan.nv21), a.taps.data_ptr(), a.weights.data_ptr(),
            int(plan.keep_edge), *plan.conv,
            a.fparams.data_ptr(), a.ops.data_ptr(), plan.ops.shape[0], w, h,
            buf.data_ptr(), TYPE_CODES[buf.dtype], plan.out_ch,
            store_cast(plan.out_dtype, buf.dtype), sc, sy, sx, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"frame_resize launch failed: CUDA error {err} ({lib.cvgs_error_string(err).decode()})"
        )
    LAUNCHES += 1
    return result


def run(pipeline, plan: FramePlan, device: torch.device, out=None):
    """One call of the kernel path: gather the arguments, launch."""
    return frame_resize(prepare(pipeline, plan, device), out)


#: the wrapper, under the name every kernel module gives it
launch = frame_resize


def work(a: Launch) -> Tuple[int, int, int]:
    """``(output bytes, source bytes touched, float32 operations)`` of one
    launch (``utils.bounds``): 12 operations per value for the lerps, 3 more
    for a YUV conversion, one per chain row."""
    plan = a.plan
    out_bytes, values = bounds.output(plan)
    return (out_bytes, bounds.touched_bytes(plan),
            values * (12 + (3 if plan.yuv else 0) + plan.ops.shape[0]))
