"""The pointwise kernel: plan, plain version, wrapper.

Counterpart of the one jitted XLA program that
``cvgpuspeedup_tpu/exec/executor.py::_compiled`` builds for a pipeline no
Pallas kernel takes. One launch of ``csrc/pointwise.cu`` computes a whole
pipeline of the form

    head -> pointwise chain -> write

whose head reads one source pixel per output pixel: a *base*

  ===========  ==========================================================
  image        ``ImageRead``, single (H, W, C) or batched (N, H, W, C),
               also with ``packed_channels``
  circ         ``CircularBatchRead`` from its runtime ``first``; a rank's
               view of a ring (``parallel/mesh.py``) has fewer output
               planes than the ring holds (``num_planes``)
  yuv          ``ReadYUV``: an NV12 or NV21 buffer read as (H, W, 3) YUV
  ===========  ==========================================================

under up to ``MAX_STAGES`` re-indexing *stages*, ``CropRead`` (runtime
origin) and ``BorderRead`` (the five modes), nested in any order. A
``ConvertYUVToRGB`` at the head of the chain runs with the full-frame
kernel's device code; the rest of the chain is ``encode_chain``'s table
(uint8, int8, uint16, int16, int32, float16 and float32 as source, cast
target and output; int32 held as its bits, the others as float32 values).
An int32 source is read as float32's 4-byte words, so a copy, crop, border
or ring of int32 is exact at every value; an int64 tensor source is read as
its low 32 bits into the same register and a float64 one rounded to
float32, their canonical dtypes, so the chain starts from those; a CONSTANT
border's value is
staged as float32 and cast to the source's dtype by the kernel as
``utils.dtypes.cast`` casts it. A
``FusedRead`` at the top of the read is taken as its read and the head of
the chain, which is what it lowers to; below a stage it is refused, and the
composed-read kernel (``cuda_composed``) takes it.

:func:`build_plan` turns the structure into a :class:`PointwisePlan` once:
the head's words, the op table and the layout of the block of runtime values
(``first``, crop origins, border values, chain scalars). It also fixes what
the kernel stages the table with (``csrc/pointwise_chain.cuh``): the channel
count each row takes and the chain's width, its widest point; a chain one
channel wide runs in the kernel's one-lane instances. Both ride after the
words the kernel read before them (the op table's rows and sentinel, the
head's 44 words), so an older library reads the same table. New frames,
``first`` s, origins, border values and scalars build nothing. Refused
(:class:`Unsupported`): a source of no dtype of ``SRC_DTYPES`` (uint32,
bool), chain scalars that are neither float32 nor float16, more than 4
channels, more than ``MAX_STAGES`` stages, any resampling
read.

:func:`pointwise` is the wrapper: on a CUDA tensor it launches the kernel,
on a CPU tensor it runs :func:`pointwise_reference`, the plain PyTorch
version (the eager read, each op's own ``apply``, the write), which reads
neither the head nor the block nor the op table. ``out=`` makes it store
into a caller's view of the write's layout, of any strides (a ring slot).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph import FusedRead, flatten, map_leaves
from ..ops.border import BorderRead
from ..ops.color import alpha_fill
from ..ops.crop import CropRead
from ..ops.memory import CircularBatchRead, ImageRead, SplitWrite, TensorSplit, Write2D
from ..ops.nv12 import LIMITED_C, LIMITED_Y, ConvertYUVToRGB, ReadYUV, conversion_coefficients
from ..types import BorderMode, ColorRange, PixelFormat, Size
from ..utils import dtypes as dt
from ..utils.dtypes import as_device_tensor, kernel_source
from ..utils import bounds
from . import _build
from . import cuda_batch_resize as kbr
from . import cuda_frame_resize as kfr
from .cuda_batch_resize import (_MAX_CHANNELS, _MAX_PLANES, CHAIN_DTYPES, OP_ALPHA,
                                OP_ALPHA_I32, OP_GRAY_F16, OP_GRAY_F32, OP_GRAY_I32, OP_GRAY_U8,
                                OP_REORDER, SRC_CODES, SRC_DTYPES, TYPE_CODES, Unsupported,
                                _leaf_dtype_name, encode_chain, store_cast)
from .cuda_divergent import _Block, _stack_geometry
from .cuda_warp import _size

__all__ = ["Unsupported", "build_plan", "prepare", "pointwise_reference", "pointwise", "run",
           "LAUNCHES", "SRC_DTYPES", "MAX_STAGES"]

#: launches of the CUDA kernel in this process
LAUNCHES = 0

# keep every code in step with csrc/pointwise.cuh
BASES = ("image", "circ", "yuv")
STAGE_CROP, STAGE_BORDER = 0, 1
BORDER_MODES = {BorderMode.CONSTANT: 0, BorderMode.REPLICATE: 1, BorderMode.REFLECT: 2,
                BorderMode.REFLECT_101: 3, BorderMode.WRAP: 4}
MAX_STAGES = 4
#: the head's words: 12, the stages', then the chain's width
HEAD_INTS = 12 + 8 * MAX_STAGES + 1
_SINGLE_LAYOUTS = {Write2D: "packed", TensorSplit: "split", SplitWrite: "split_write"}


@dataclasses.dataclass(frozen=True)
class PointwisePlan:
    """Everything about one pipeline structure that the kernel needs;
    ``n_planes``, ``out_ch``, ``dsize``, ``out_dtype`` and ``layout`` size
    the output as the other kernels' ``_alloc_out`` do."""

    base: str
    batch: bool            # the value has a leading plane axis
    n_planes: int
    src_dtype: torch.dtype
    src_numel: int         # elements of the base's array
    dsize: Size            # the output planes' (W, H)
    out_ch: int
    out_dtype: torch.dtype
    layout: str
    head: Tuple[int, ...]  # HEAD_INTS words, csrc/pointwise.cuh::PwHead
    conv: Tuple[float, ...]  # (ys, cs, rv, gu, gv, bu) of a leading YUV -> RGB
    ops: np.ndarray        # (n_ops, 4) int32
    row_ch: np.ndarray     # (n_ops,) int32: the channels of the value each row takes
    fp_off: int            # word offset of the chain scalars in the block
    n_block: int           # words of the block
    #: per-device copies of the op table; the head as a ctypes array
    device_consts: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def width(self) -> int:
        """Channels at the chain's widest point, the head's included."""
        return self.head[-1]

    def consts(self, device: torch.device) -> torch.Tensor:
        """The op table as the kernel reads it: the rows, a sentinel (so it is
        never empty), then each row's channel count."""
        c = self.device_consts.get(device)
        if c is None:
            words = np.concatenate([self.ops.reshape(-1), np.zeros(1, np.int32), self.row_ch])
            c = self.device_consts[device] = torch.from_numpy(words.astype(np.int32)).to(device)
        return c

    def head_words(self):
        c = self.device_consts.get("head")
        if c is None:
            c = self.device_consts["head"] = (ctypes.c_int * HEAD_INTS)(*self.head)
        return c


def _unwrap(pipeline):
    """``(read, chain)``: a ``FusedRead`` at the top of the read is its read
    and the head of the chain."""
    read, chain = pipeline.read, tuple(pipeline.compute)
    while isinstance(read, FusedRead):
        read, chain = read.read, tuple(read.chain) + chain
    return read, chain


def _stages(read):
    """``(stages, base)``: the crops and borders of a read, outermost first,
    and the read under them."""
    stages = []
    while isinstance(read, (CropRead, BorderRead)):
        stages.append(read)
        read = read.source
    return stages, read


def row_channels(ops: np.ndarray, ch: int) -> Tuple[np.ndarray, int]:
    """``(row_ch, width)`` of an op table run on ``ch`` channels: the
    channel count of the value each row takes, as the rows change it (a
    reorder to its count, an alpha one more, a gray conversion 1), and the
    largest count the chain reaches, ``ch`` included."""
    row_ch, width = [], ch
    for code, _, _, aux in ops.tolist():
        row_ch.append(ch)
        if code == OP_REORDER:
            ch = aux >> 16
        elif code in (OP_ALPHA, OP_ALPHA_I32):
            ch += 1
        elif code in (OP_GRAY_U8, OP_GRAY_F32, OP_GRAY_F16, OP_GRAY_I32):
            ch = 1
        width = max(width, ch)
    return np.asarray(row_ch, np.int32), width


def head_conversion(chain, dtype: torch.dtype, ch: int):
    """``(conv, conv_first, limited, rows, dtype, ch, rest)`` of a chain on
    values of ``dtype`` with ``ch`` channels: a YUV -> RGB at its head runs in
    the kernel's head (``conv``: ``(ys, cs, rv, gu, gv, bu)``), its saturate
    and its alpha are the table's first ``rows``; ``dtype`` and ``ch`` are
    what the rest of the chain takes."""
    if not (chain and isinstance(chain[0], ConvertYUVToRGB)):
        return (0.0,) * 6, 0, 0, np.zeros((0, 4), np.int32), dtype, ch, chain
    cv = chain[0]
    if ch != 3:
        raise Unsupported(f"YUV -> RGB on {ch} channels")
    if cv.out_dtype not in CHAIN_DTYPES:
        raise Unsupported(f"YUV -> RGB to {cv.out_dtype}")
    conv = (LIMITED_Y, LIMITED_C, *conversion_coefficients(cv.standard))
    head_rows = []
    if cv.out_dtype != torch.float32:
        head_rows.append([kbr._SAT[cv.out_dtype], 0, 0, 0])
    if cv.alpha:
        head_rows.append([OP_ALPHA_I32 if cv.out_dtype == torch.int32 else OP_ALPHA, 0, 0,
                          int(alpha_fill(cv.out_dtype))])
    return (conv, 1, int(cv.color_range == ColorRange.LIMITED),
            np.asarray(head_rows, np.int32).reshape(-1, 4), cv.out_dtype, 4 if cv.alpha else 3,
            chain[1:])


def build_plan(pipeline) -> PointwisePlan:
    """The kernel plan of a pipeline; raises :class:`Unsupported`."""
    read, chain = _unwrap(pipeline)
    stages, base = _stages(read)
    if len(stages) > MAX_STAGES:
        raise Unsupported(f"{len(stages)} crops and borders, the kernel nests {MAX_STAGES}")
    nv21 = ascendent = False
    if isinstance(base, (ImageRead, CircularBatchRead)):
        data = base.data
        batch = isinstance(base, CircularBatchRead) or base.is_batch
        kind = "circ" if isinstance(base, CircularBatchRead) else "image"
        if kind == "circ" and not base.packed_channels and len(tuple(data.shape)) != 4:
            raise Unsupported(f"ring of shape {tuple(data.shape)}")
        # one frame is a stack of one plane
        n_src, h, w, c = _stack_geometry(tuple(data.shape) if batch else (1, *data.shape),
                                         base.packed_channels)
        # a rank's view of a ring reads fewer planes than the ring holds
        n_out = base.num_planes if kind == "circ" else n_src
        ascendent = kind == "image" or base.ascendent
    elif isinstance(base, ReadYUV):
        data, kind, batch, n_src, n_out, c = base.buffer, "yuv", False, 1, 1, 3
        shape = tuple(data.shape)
        if len(shape) == 3 and shape[2] == 1:
            shape = shape[:2]
        if len(shape) != 2 or _leaf_dtype_name(data) != "uint8":
            raise Unsupported(f"NV12 buffer of shape {tuple(data.shape)} and dtype "
                              f"{_leaf_dtype_name(data)}")
        rows, w = shape
        h = rows * 2 // 3
        if h < 2 or h % 2 or w % 2 or h * 3 != rows * 2:
            raise Unsupported(f"NV12 buffer of shape {shape}")
        nv21 = base.pixel_format == PixelFormat.NV21
    else:
        raise Unsupported(f"read {type(base).__name__} takes more than one source pixel per "
                          "output pixel, or is a FusedRead under a crop or border")
    src_dtype = SRC_DTYPES.get(_leaf_dtype_name(data))
    if src_dtype is None:
        raise Unsupported(f"source dtype {_leaf_dtype_name(data)}")
    if not 1 <= c <= _MAX_CHANNELS:
        raise Unsupported(f"{c} channels")
    if not 1 <= n_src <= _MAX_PLANES or not 1 <= n_out <= _MAX_PLANES or h < 1 or w < 1:
        raise Unsupported(f"{n_out} planes from a source of {n_src} planes of {w}x{h}")

    # the block of runtime values: `first`, then each stage's, outermost
    # first, then the chain scalars; the stages' source sizes from the base up
    pos = 0
    first_off = -1
    if kind == "circ":
        first_off, pos = pos, pos + 1
    sizes = [(h, w)]
    for st in reversed(stages):
        sh, sw = sizes[-1]
        if isinstance(st, CropRead):
            if not (1 <= st.height <= sh and 1 <= st.width <= sw):
                raise Unsupported(f"crop of {st.width}x{st.height} from {sw}x{sh}")
            sizes.append((st.height, st.width))
        else:
            if min(st.top, st.bottom, st.left, st.right) < 0:
                raise Unsupported("a negative border")
            sizes.append((sh + st.top + st.bottom, sw + st.left + st.right))
    words: List[int] = []
    for k, st in enumerate(stages):
        sh, sw = sizes[len(stages) - 1 - k]
        if isinstance(st, CropRead):
            if _size(st.x) != 1 or _size(st.y) != 1:
                raise Unsupported("a crop origin of more than one value")
            words += [STAGE_CROP, sh, sw, 0, pos, pos + 1, st.width, st.height]
            pos += 2
        else:
            if _size(st.value) not in (1, c):
                raise Unsupported(f"border value of {_size(st.value)} entries on {c} channels")
            words += [STAGE_BORDER, sh, sw, BORDER_MODES[st.mode], st.top, st.left, pos, 0]
            pos += c
    words += [0] * (8 * (MAX_STAGES - len(stages)))
    out_h, out_w = sizes[-1]

    conv, conv_first, limited, rows0, dtype, ch, chain = head_conversion(
        chain, dt.canonical_dtype(src_dtype), c)
    fp_off = pos  # the rows' offsets count from here: the kernel adds it
    ops, out_dtype, out_ch, n_fparams = encode_chain(chain, ch, dtype=dtype)
    ops = np.concatenate([rows0, ops]).astype(np.int32)
    row_ch, width = row_channels(ops, c)

    layouts = kbr._LAYOUTS if batch else _SINGLE_LAYOUTS
    layout = layouts.get(type(pipeline.write))
    if layout is None:
        raise Unsupported(f"write {type(pipeline.write).__name__} of a "
                          f"{'batched' if batch else 'single'} value")
    head = (BASES.index(kind), h, w, c, SRC_CODES[src_dtype], n_src, first_off, int(ascendent),
            int(nv21), len(stages), conv_first, limited, *words, width)
    return PointwisePlan(
        base=kind, batch=batch, n_planes=n_out if batch else 1, src_dtype=src_dtype,
        src_numel=int(np.prod(tuple(data.shape))), dsize=Size(out_w, out_h), out_ch=out_ch,
        out_dtype=out_dtype, layout=layout, head=tuple(int(v) for v in head), conv=conv, ops=ops,
        row_ch=row_ch, fp_off=fp_off, n_block=max(fp_off + n_fparams, 1),
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

    plan: PointwisePlan
    pipeline: object       # the executor's Pipeline the arguments come from
    src: torch.Tensor      # the base's array, contiguous
    block: torch.Tensor    # int32: first, crop origins, border values, chain scalars
    ops: torch.Tensor      # int32: the op rows


def _base_leaf(pipeline):
    base = _stages(_unwrap(pipeline)[0])[1]
    return base.buffer if isinstance(base, ReadYUV) else base.data


def prepare(pipeline, plan: PointwisePlan, device: torch.device) -> Launch:
    """Gather one call's arguments on ``device``: the source, and the block
    of runtime values in one pinned non-blocking copy of its host part
    (device leaves stay where they are). Nothing here waits for the
    device."""
    read, chain = _unwrap(pipeline)
    stages, base = _stages(read)
    src = kernel_source(_base_leaf(pipeline), device).contiguous()
    nch = plan.head[3]
    blk = _Block()
    if plan.base == "circ":
        blk.put(base.first, np.int32, width=1)
    for st in stages:
        if isinstance(st, CropRead):
            blk.put(st.x, np.int32, width=1)
            blk.put(st.y, np.int32, width=1)
        elif isinstance(st.value, torch.Tensor):
            blk.put(st.value.reshape(-1).to(torch.float32).expand(nch), np.float32)
        else:
            blk.put(np.broadcast_to(np.asarray(st.value, np.float32).reshape(-1), (nch,)),
                    np.float32)
    if chain and isinstance(chain[0], ConvertYUVToRGB):
        chain = chain[1:]
    for v in flatten(tuple(chain))[1]:
        blk.put(v, np.float32)
    if blk.size == 0:
        blk.put(0, np.int32, width=1)
    return Launch(plan=plan, pipeline=pipeline, src=src, block=blk.to(device),
                  ops=plan.consts(device))


def pointwise_reference(a: Launch):
    """The plain PyTorch version of the kernel on the launch's source (in its
    canonical dtype): the eager read, each chain op's own ``apply`` and the
    write op."""
    dev = a.src.device
    data, src = _base_leaf(a.pipeline), dt.canonicalize(a.src)
    p = map_leaves(a.pipeline, lambda v: src if v is data else as_device_tensor(v, dev))
    return p.lower()


can_store = kbr.can_store


def _alloc_out(plan: PointwisePlan, device, out=None):
    """``(buffer, (sn, sc, sy, sx), result)`` of the plan's write layout,
    allocated, or over the view ``out``."""
    if plan.batch:
        return kbr._alloc_out(plan, device, out)
    buf, strides, result = kfr._alloc_out(plan, device, out)
    return buf, (0, *strides), result


def _check(a: Launch) -> None:
    plan = a.plan
    dev = a.src.device
    for name, t, dtype in (("block", a.block, torch.int32), ("ops", a.ops, torch.int32),
                           ("src", a.src, plan.src_dtype)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the source on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if a.block.numel() < plan.n_block or a.ops.numel() != plan.ops.size + 1 + plan.ops.shape[0]:
        raise ValueError("parameter block or op table does not match the plan")
    if a.src.numel() != plan.src_numel:
        raise ValueError(f"source of shape {tuple(a.src.shape)} does not match the plan")


def pointwise(a: Launch, out: Optional[torch.Tensor] = None):
    """The kernel wrapper: launches on a CUDA tensor, runs the plain version
    on a CPU tensor, raises on anything else. It never falls back. With
    ``out`` (a view of the write's shape, any strides) the result is stored
    there, cast as ``utils.dtypes.astype`` casts, and ``out`` is returned."""
    global LAUNCHES
    dev = a.src.device
    if dev.type == "cpu":
        result = pointwise_reference(a)
        return result if out is None else kbr.reference_into(result, out, dev)
    if dev.type != "cuda":
        raise ValueError(f"pointwise runs on CUDA or CPU tensors, not {dev}")
    _check(a)
    lib = _build.load()
    plan = a.plan
    if out is not None and not can_store(plan, out.dtype):
        raise TypeError(f"out is {out.dtype}; the kernel cannot store {plan.out_dtype} "
                        f"values of a {plan.layout} write into it")
    buf, (sn, sc, sy, sx), result = _alloc_out(plan, dev, out)
    w, h = plan.dsize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cvgs_pointwise(
            a.src.data_ptr(), plan.head_words(), *plan.conv, a.block.data_ptr(),
            a.ops.data_ptr(), plan.ops.shape[0], plan.fp_off, plan.n_planes, w, h,
            buf.data_ptr(), TYPE_CODES[buf.dtype], plan.out_ch,
            store_cast(plan.out_dtype, buf.dtype), sn, sc, sy, sx, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"pointwise launch failed: CUDA error {err} ({lib.cvgs_error_string(err).decode()})"
        )
    LAUNCHES += 1
    _build.after_launch("pointwise", dev)
    return result


def run(pipeline, plan: PointwisePlan, device: torch.device, out=None):
    """One call of the kernel path: gather the arguments, launch."""
    return pointwise(prepare(pipeline, plan, device), out)


#: the wrapper, under the name every kernel module gives it
launch = pointwise


def work(a: Launch) -> Tuple[int, int, int]:
    """``(output bytes, source bytes touched, float32 operations)`` of one
    launch (``utils.bounds``): the whole base read once, or under a crop the
    crop's pixels (the output's, at the source's channels and element size);
    one operation per value and chain row, an NV12 conversion 7 more."""
    plan = a.plan
    out_bytes, values = bounds.output(plan)
    src = a.src.numel() * a.src.element_size()
    if any(isinstance(st, CropRead) for st in _stages(_unwrap(a.pipeline)[0])[0]):
        w, h = plan.dsize
        src = min(src, plan.n_planes * h * w * plan.head[3] * a.src.element_size())
    return out_bytes, src, values * (plan.ops.shape[0] + (7 if plan.base == "yuv" else 0))
