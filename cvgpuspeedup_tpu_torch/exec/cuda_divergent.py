"""The divergent kernel: plan, eager merge, plain version, wrapper.

Counterpart of ``cvgpuspeedup_tpu/exec/pallas_divergent.py``. One launch of
``csrc/divergent.cu`` runs a divergent batch (``launch_divergent_batch``):
plane ``z`` runs sequence ``plane_ids[z]``. The planes of one sequence form
a group, in order of first appearance; each group is one of six kinds:

  ===========  ==========================================  =====================
  kind         read                                        coordinates from
  ===========  ==========================================  =====================
  image        batched ``ImageRead`` (N, H, W, C), or a       plane z, or its own
               ``BatchRead`` of N images                   image
  circ         ``CircularBatchRead``, or a rank's view of   runtime ``first``, modulo
               one (``parallel/mesh.py``)                  the ring's planes
  crop_resize  ``BatchResizeRead`` of one frame            K1's rules, runtime rects
  resize       ``BatchResizeRead`` of a stack              K1's rules on (0, 0, w, h)
  nv12         ``BatchRead`` of fused NV12 -> float RGB    K2's tap tables
               reads, optionally ``ResizeRead``
  warp         ``BatchRead`` of ``WarpRead`` s             9 coefficients per plane
  ===========  ==========================================  =====================

each with its own flat chain (``cuda_batch_resize.encode_chain``), and the
merged batch goes out in the first sequence's write layout. A ragged
``BatchRead`` group (``used_planes``: images, NV12 reads or warps) holds its
``default``, cast to the read's dtype, on its planes from ``used_planes``
on, and runs it through its chain, as ``ops/memory.py::BatchRead`` does.
:func:`build_plan` classifies the groups once per structure and plane ids
and keeps the static tables on the plan: the op rows of every chain and each
NV12 group's tap and weight tables and conversion coefficients. Nothing of a
runtime value is in the plan: new ``first`` s, rects, matrices or frames
build nothing. :func:`prepare` gathers one call's parameter block, moved in
one pinned non-blocking copy: the plane -> group table, a source address per
plane (one distinct source moves once), and per group its ``first``, rects,
``used_planes`` and background, warp coefficients and borders, and chain
scalars, then one descriptor per group that points at them.

:func:`merge` is the eager version: each group lowers only its own planes
(``lower_planes``), runs its chain, and is scattered into one batch of the
dtype of plane 0's group (``utils.dtypes.astype``: clamp, then truncate),
then the first sequence's write. :func:`divergent_reference`, the plain
PyTorch version, runs it on the launch's device; it reads neither the block
nor the tables, so holding the kernel against it checks them.

Groups may differ in output dtype: the batch takes plane 0's group's, and
a float32 group of a uint8 batch stores through the merge's own cast
(clamp, then truncate; ``CLAMP_STORE`` in the group's flags).

Refused (:class:`Unsupported`, before anything launches): a group of no
kind above, groups that differ in output (H, W, C), more than 4 channels.
The reference's TPU kernel refuses a ragged ``BatchRead`` group
(``pallas_divergent.py:166``); this kernel takes it. None of the TPU kernel's schedule
comes over (scalar-prefetch ring, 2-slot DMA, interleaved lane coefficients,
baked one-hot NV12 and warp matrices, VMEM and lane gates).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph import FusedRead, flatten, map_leaves
from ..ops.memory import BatchRead, CircularBatchRead, ImageRead
from ..ops.nv12 import LIMITED_C, LIMITED_Y, ConvertYUVToRGB, ReadYUV, conversion_coefficients
from ..ops.resize import BatchResizeRead, ResizeRead, axis_taps, half_taps, keeps_edge_weight
from ..ops.warp import WarpRead
from ..types import ColorRange, InterpolationType, PixelFormat, Size, WarpType
from ..utils import dtypes as dt
from ..utils import bounds
from ..utils.dtypes import as_device_tensor
from . import _build
from . import cuda_batch_resize as kbr
from . import cuda_warp as kw
from .cuda_batch_resize import _MAX_CHANNELS, _MAX_PLANES, SRC_DTYPES, Unsupported
from .cuda_warp import _MAX_SIDE, _N_COEFFS, _size

__all__ = ["Unsupported", "build_plan", "prepare", "merge", "divergent_reference", "divergent",
           "run", "LAUNCHES"]

#: launches of the CUDA kernel in this process
LAUNCHES = 0

# group kinds; keep in step with csrc/divergent.cu
KINDS = ("image", "circ", "crop_resize", "resize", "nv12", "warp")
DESC_INTS = 16      # ints per group descriptor; csrc/divergent.cu reads the same fields
CLAMP_STORE = 1 << 8  # in a group's flags: float32 values stored into a uint8 batch


@dataclasses.dataclass(frozen=True)
class Group:
    """One sequence's planes and what the kernel needs of its structure."""

    sid: int               # 1-based sequence id
    kind: str
    planes: Tuple[int, ...]
    src_h: int
    src_w: int
    nch: int               # source channels (1 for the luma of an NV12 buffer)
    src_dtype: torch.dtype
    n_src: int             # planes of an image, ring or stack source
    ascendent: bool        # circ
    mode: int              # crop_resize, resize: the aspect-ratio code
    flags: int             # nv12: keep_edge | nv21 << 1 | limited << 2 | alpha << 3; warp: perspective;
                           # any kind: CLAMP_STORE
    op_off: int            # first op row in the plan's consts
    n_ops: int
    tab_off: int           # nv12: taps, then weights, then 6 conversion floats, in the consts
    held: Optional[torch.dtype] = None  # a ragged BatchRead group: the dtype of its default


@dataclasses.dataclass(frozen=True)
class DivergentPlan:
    """Everything about one divergent structure and routing that the kernel
    needs; ``n_planes``, ``out_ch``, ``dsize``, ``out_dtype`` and ``layout``
    size the output as ``cuda_batch_resize._alloc_out`` does."""

    plane_ids: Tuple[int, ...]
    groups: Tuple[Group, ...]
    table: np.ndarray      # (N,) int32: each plane's group index
    n_planes: int
    dsize: Size            # the output planes' (W, H)
    out_ch: int
    out_dtype: torch.dtype
    layout: str
    consts: np.ndarray     # int32: op rows of every chain, then the NV12 tables
    #: per-device copies of the consts
    device_consts: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def device_tables(self, device: torch.device) -> torch.Tensor:
        c = self.device_consts.get(device)
        if c is None:
            c = torch.from_numpy(self.consts.copy()).to(device)
            self.device_consts[device] = c
        return c


def groups_of(plane_ids) -> Dict[int, List[int]]:
    """Sequence id -> its planes, in order of first appearance."""
    groups: Dict[int, List[int]] = {}
    for z, sid in enumerate(plane_ids):
        groups.setdefault(sid, []).append(z)
    return groups


def _dtype_of(leaf) -> torch.dtype:
    dtype = SRC_DTYPES.get(kbr._leaf_dtype_name(leaf))
    if dtype is None:
        raise Unsupported(f"source dtype {kbr._leaf_dtype_name(leaf)}")
    return dtype


def _stack_geometry(data, packed: int) -> Tuple[int, int, int, int]:
    """``(n, h, w, c)`` of a (N, H, W, C), (N, H, W) or packed (N, H, W*C)
    source, given as an array or as its shape."""
    shape = tuple(getattr(data, "shape", data))
    if packed and len(shape) == 3:
        return shape[0], shape[1], shape[2] // packed, packed
    if not packed and len(shape) in (3, 4):
        return shape[0], shape[1], shape[2], (shape[3] if len(shape) == 4 else 1)
    raise Unsupported(f"plane stack of shape {shape}")


def _image_geometry(read: ImageRead) -> Tuple[int, int, int]:
    """``(h, w, c)`` of an unbatched image read: (H, W, C), (H, W) or
    packed (H, W*C)."""
    shape = tuple(read.data.shape)
    if read.packed_channels and len(shape) == 2:
        return shape[0], shape[1] // read.packed_channels, read.packed_channels
    if not read.packed_channels and len(shape) in (2, 3):
        return shape[0], shape[1], (shape[2] if len(shape) == 3 else 1)
    raise Unsupported(f"image of shape {shape}")


def _nv12_parts(op):
    """``(read_yuv, conversion, dsize or None)`` of one NV12 plane read."""
    dsize = None
    if isinstance(op, ResizeRead):
        if op.interp != InterpolationType.INTER_LINEAR:
            raise Unsupported(f"interpolation {op.interp}")
        dsize, op = op.dsize, op.source
    if not (isinstance(op, FusedRead) and isinstance(op.read, ReadYUV) and len(op.chain) == 1
            and isinstance(op.chain[0], ConvertYUVToRGB)):
        raise Unsupported("a BatchRead of neither WarpReads nor fused NV12 -> RGB reads")
    conv = op.chain[0]
    if conv.out_dtype != torch.float32:
        raise Unsupported(f"YUV->RGB to {conv.out_dtype}")
    return op.read, conv, dsize


def _classify(seq, n: int):
    """``(kind, geometry dict, chain input channels, chain start dtype,
    (h_out, w_out), per-group extras)`` of one sequence; raises
    :class:`Unsupported`."""
    read = seq.read
    if isinstance(read, (ImageRead, CircularBatchRead)):
        if isinstance(read, ImageRead) and not read.is_batch:
            raise Unsupported("an unbatched ImageRead")
        n_src, h, w, c = _stack_geometry(read.data, read.packed_channels)
        kind = "circ" if isinstance(read, CircularBatchRead) else "image"
        if kind == "image" and n_src != n:
            raise Unsupported(f"an image stack of {n_src} planes for {n}")
        if n_src < 1:
            raise Unsupported("an empty ring")
        dtype = _dtype_of(read.data)
        geo = dict(src_h=h, src_w=w, nch=c, src_dtype=dtype, n_src=n_src,
                   ascendent=kind == "image" or read.ascendent)
        return kind, geo, c, dtype, (h, w), {}
    if isinstance(read, BatchResizeRead):
        if read.interp != InterpolationType.INTER_LINEAR:
            raise Unsupported(f"interpolation {read.interp}")
        stack = read.frame is None
        src = read.stack if stack else read.frame
        if src.ndim != (2 if read.packed_channels else 3) + stack:
            raise Unsupported(f"resize source of rank {src.ndim}")
        h, w, c = read.source_dims()
        if read.num_planes != n or tuple(read.rects.shape) != (n, 4):
            raise Unsupported(f"rects of shape {tuple(read.rects.shape)} for {n} planes")
        if stack and src.shape[0] != n:
            raise Unsupported("stack and rects disagree on the plane count")
        if read.used_planes is not None and _size(read.used_planes) != 1:
            raise Unsupported("used_planes must be one value")
        geo = dict(src_h=h, src_w=w, nch=c, src_dtype=_dtype_of(src),
                   n_src=n if stack else 1, mode=kbr._MODES[read.aspect_ratio])
        dst_w, dst_h = read.dsize
        return ("resize" if stack else "crop_resize"), geo, c, torch.float32, (dst_h, dst_w), {}
    if not isinstance(read, BatchRead):
        raise Unsupported(f"read {type(read).__name__}")
    if len(read.ops) != n:
        raise Unsupported(f"a BatchRead of {len(read.ops)} reads for {n} planes")
    if read.used_planes is not None and (_size(read.used_planes) != 1
                                         or not 1 <= _size(read.default) <= _MAX_CHANNELS):
        raise Unsupported("used_planes must be one value and the default a scalar or per channel")
    if all(isinstance(o, ImageRead) and not o.is_batch for o in read.ops):
        geos = {(_image_geometry(o), kbr._leaf_dtype_name(o.data)) for o in read.ops}
        if len(geos) != 1:
            raise Unsupported("images differ in shape or dtype")
        h, w, c = _image_geometry(read.ops[0])
        dtype = _dtype_of(read.ops[0].data)
        geo = dict(src_h=h, src_w=w, nch=c, src_dtype=dtype, n_src=1, ascendent=True)
        return "image", geo, c, dtype, (h, w), {}
    if all(isinstance(o, WarpRead) for o in read.ops):
        w0 = read.ops[0]
        h, w, c, _ = kw._geometry(w0.source)
        dtype = _dtype_of(w0.source.data)
        if not (1 <= h < _MAX_SIDE and 1 <= w < _MAX_SIDE):
            raise Unsupported(f"warp source of {h}x{w}")
        persp = w0.warp_type == WarpType.PERSPECTIVE
        for o in read.ops:
            if o.warp_type != w0.warp_type or o.dsize != w0.dsize:
                raise Unsupported("planes differ in warp type or size")
            if kw._geometry(o.source) != kw._geometry(w0.source):
                raise Unsupported("planes differ in source geometry or dtype")
            if _size(o.coeffs) != (9 if persp else 6) or _size(o.default) != c:
                raise Unsupported("coefficients or border of the wrong size")
        geo = dict(src_h=h, src_w=w, nch=c, src_dtype=dtype, flags=int(persp))
        return "warp", geo, c, torch.float32, (w0.dsize.height, w0.dsize.width), {}
    parts = [_nv12_parts(o) for o in read.ops]
    yuv0, conv0, dsize0 = parts[0]
    shape0 = tuple(yuv0.buffer.shape)
    for yuv, conv, dsize in parts:
        if (conv != conv0 or dsize != dsize0 or yuv.pixel_format != yuv0.pixel_format
                or tuple(yuv.buffer.shape) != shape0):
            raise Unsupported("NV12 planes differ in format, conversion, size or buffer shape")
    if _dtype_of(yuv0.buffer) != torch.uint8:
        raise Unsupported("NV12 buffer not uint8")
    shape = shape0[:2] if len(shape0) == 3 and shape0[2] == 1 else shape0
    if len(shape) != 2:
        raise Unsupported(f"NV12 buffer of shape {shape0}")
    rows, src_w = shape
    src_h = rows * 2 // 3
    if src_h < 2 or src_h % 2 or src_w % 2 or src_h * 3 != rows * 2:
        raise Unsupported(f"NV12 buffer of shape {shape0}")
    dst_w, dst_h = dsize0 if dsize0 is not None else (src_w, src_h)
    if dsize0 is None:  # the nearest chroma upsample: every weight 0, the first tap kept
        keep = True
        tx = (np.arange(dst_w), np.arange(dst_w), np.zeros(dst_w, np.float32))
        ty = (np.arange(dst_h), np.arange(dst_h), np.zeros(dst_h, np.float32))
    else:
        keep = keeps_edge_weight(src_h, src_w, dsize0)
        tx, ty = axis_taps(src_w, dst_w, keep), axis_taps(src_h, dst_h, keep)
    taps = np.concatenate([tx[0], tx[1], ty[0], ty[1], *half_taps(tx[0], tx[1]),
                           *half_taps(ty[0], ty[1])]).astype(np.int32)
    weights = np.concatenate([tx[2], ty[2]]).astype(np.float32)
    conv = np.asarray([LIMITED_Y, LIMITED_C, *conversion_coefficients(conv0.standard)],
                      np.float32)
    limited = conv0.color_range == ColorRange.LIMITED
    flags = (int(keep) | int(yuv0.pixel_format == PixelFormat.NV21) << 1 | int(limited) << 2
             | int(conv0.alpha) << 3)
    geo = dict(src_h=src_h, src_w=src_w, nch=1, src_dtype=torch.uint8, flags=flags)
    tables = np.concatenate([taps, weights.view(np.int32), conv.view(np.int32)])
    return "nv12", geo, 4 if conv0.alpha else 3, torch.float32, (dst_h, dst_w), {"tables": tables}


def build_plan(seqs, plane_ids) -> DivergentPlan:
    """The kernel plan of a divergent batch; raises :class:`Unsupported`."""
    n = len(plane_ids)
    if not 1 <= n <= _MAX_PLANES:
        raise Unsupported(f"{n} planes")
    layout = kbr._LAYOUTS.get(type(seqs[0].write))
    if layout is None:
        raise Unsupported(f"write {type(seqs[0].write).__name__}")
    groups, rows, tables = [], [], []
    shape = out_dtype = None
    n_rows = 0
    extra_off = 0  # words of NV12 tables, placed after every op row
    for g, (sid, planes) in enumerate(groups_of(plane_ids).items()):
        seq = seqs[sid - 1]
        kind, geo, chain_in, start, (h_out, w_out), extra = _classify(seq, n)
        if not 1 <= geo["nch"] <= _MAX_CHANNELS:
            raise Unsupported(f"{geo['nch']} channels")
        ops, odt, och, _ = kbr.encode_chain(seq.compute, chain_in, dtype=start)
        if h_out < 1 or w_out < 1:
            raise Unsupported(f"output planes of {w_out}x{h_out}")
        if shape is None:
            shape, out_dtype = (h_out, w_out, och), odt
        elif (h_out, w_out, och) != shape:
            raise Unsupported(f"group {g} gives ({h_out}, {w_out}, {och}), group 0 {shape}")
        # the merge casts a group into the batch's dtype (utils.dtypes.astype):
        # float32 into uint8 clamps, then truncates; uint8 into float32 is exact
        clamp = CLAMP_STORE if (odt, out_dtype) == (torch.float32, torch.uint8) else 0
        ragged = isinstance(seq.read, BatchRead) and seq.read.used_planes is not None
        held = start if ragged else None
        tab_off = -1
        if "tables" in extra:
            tab_off = extra_off
            tables.append(extra["tables"])
            extra_off += extra["tables"].size
        groups.append(Group(
            sid=sid, kind=kind, planes=tuple(planes), src_h=geo["src_h"], src_w=geo["src_w"],
            nch=geo["nch"], src_dtype=geo["src_dtype"], n_src=geo.get("n_src", 1),
            ascendent=geo.get("ascendent", True), mode=geo.get("mode", 0),
            flags=geo.get("flags", 0) | clamp, op_off=n_rows, n_ops=ops.shape[0], tab_off=tab_off,
            held=held))
        rows.append(ops)
        n_rows += ops.shape[0]
    # the NV12 tables follow the op rows: their offsets move past them
    groups = [dataclasses.replace(gr, tab_off=gr.tab_off + 4 * n_rows) if gr.tab_off >= 0 else gr
              for gr in groups]
    index = {gr.sid: k for k, gr in enumerate(groups)}
    consts = np.concatenate([np.concatenate(rows).reshape(-1).astype(np.int32), *tables,
                             np.zeros(1, np.int32)])  # never empty
    return DivergentPlan(
        plane_ids=tuple(plane_ids), groups=tuple(groups),
        table=np.asarray([index[sid] for sid in plane_ids], np.int32), n_planes=n,
        dsize=Size(shape[1], shape[0]), out_ch=shape[2], out_dtype=out_dtype, layout=layout,
        consts=consts,
    )


class _Block:
    """A parameter block of int32 words gathered from host values and device
    tensors; host values reach the device in one pinned, non-blocking copy."""

    def __init__(self):
        self.parts: List = []
        self.size = 0

    def put(self, v, dtype=np.float32, width: Optional[int] = None) -> int:
        """Append ``v`` as ``dtype`` (int32 or float32), flattened and
        zero-padded to ``width`` words; returns its word offset."""
        if isinstance(v, torch.Tensor):
            t = v.reshape(-1).to(dt.to_torch_dtype(dtype))
            if width is not None:
                t = torch.cat([t, t.new_zeros(width - t.numel())])
            part = t.view(torch.int32)
            n = part.numel()
        else:
            a = np.asarray(v, dtype).reshape(-1)
            if width is not None:
                a = np.concatenate([a, np.zeros(width - a.size, dtype)])
            part = a.view(np.int32)
            n = part.size
        off = self.size
        self.parts.append(part)
        self.size += n
        return off

    def to(self, device: torch.device) -> torch.Tensor:
        host = [p for p in self.parts if isinstance(p, np.ndarray)]
        if not host:  # every value is on the device already
            return torch.cat(self.parts)
        buf = as_device_tensor(np.concatenate(host), device)
        if len(host) == len(self.parts):
            return buf
        pieces, pos = [], 0
        for p in self.parts:
            if isinstance(p, np.ndarray):
                pieces.append(buf[pos:pos + p.size])
                pos += p.size
            else:
                pieces.append(p)
        return torch.cat(pieces)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One call's arguments, every tensor on one device."""

    plan: DivergentPlan
    seqs: Tuple                   # the sequences the arguments come from
    srcs: Tuple[torch.Tensor, ...]  # the distinct sources, contiguous
    block: torch.Tensor           # int32 parameter block
    ptr_off: int                  # word offset of the (N,) int64 source addresses
    desc_off: int                 # word offset of the descriptors
    consts: torch.Tensor          # int32: the plan's op rows and NV12 tables


def _group_sources(seq, group: Group) -> Dict[int, object]:
    """Plane -> the source array it reads."""
    read = seq.read
    if group.kind in ("image", "circ"):
        if isinstance(read, BatchRead):
            return {z: read.ops[z].data for z in group.planes}
        return {z: read.data for z in group.planes}
    if group.kind in ("crop_resize", "resize"):
        src = read.frame if group.kind == "crop_resize" else read.stack
        return {z: src for z in group.planes}
    if group.kind == "warp":
        return {z: read.ops[z].source.data for z in group.planes}
    return {z: _nv12_parts(read.ops[z])[0].buffer for z in group.planes}


def prepare(seqs, plan: DivergentPlan, device: torch.device) -> Launch:
    """Gather one call's arguments on ``device``: the parameter block, in one
    pinned non-blocking copy of its host part, and the distinct sources,
    each moved once. Nothing here waits for the device."""
    n = plan.n_planes
    srcs: List[torch.Tensor] = []
    index: Dict[int, int] = {}
    plane_src = [0] * n
    for group in plan.groups:
        for z, data in _group_sources(seqs[group.sid - 1], group).items():
            k = index.get(id(data))
            if k is None:
                k = index[id(data)] = len(srcs)
                srcs.append(as_device_tensor(data, device).contiguous())
            plane_src[z] = k
    blk = _Block()
    blk.put(plan.table, np.int32, width=n + (n & 1))  # even: the addresses are 8-byte words
    ptr_off = blk.put(np.asarray([srcs[k].data_ptr() for k in plane_src], np.uint64), np.uint64)
    desc = np.full((len(plan.groups), DESC_INTS), -1, np.int32)
    for g, group in enumerate(plan.groups):
        seq = seqs[group.sid - 1]
        read = seq.read
        d = desc[g]
        d[:12] = (KINDS.index(group.kind), group.src_h, group.src_w, group.nch,
                  int(group.src_dtype == torch.uint8), group.n_src, -1, int(group.ascendent),
                  group.mode, -1, group.op_off, group.n_ops)
        d[14] = group.flags
        if group.kind == "circ":
            d[6] = blk.put(read.first, np.int32, width=1)
        elif group.kind in ("crop_resize", "resize"):
            d[9] = blk.put(n if read.used_planes is None else read.used_planes, np.int32,
                           width=1)
            d[13] = blk.put(read.rects, np.int32)
            d[15] = blk.put(read.background, np.float32, width=_MAX_CHANNELS)
        elif group.kind == "warp":  # indexed by plane; other groups' planes hold zeros
            mine = set(group.planes)
            d[13] = blk.size
            for z in range(n):
                blk.put(read.ops[z].coeffs if z in mine else 0.0, np.float32, width=_N_COEFFS)
            d[15] = blk.size
            for z in range(n):
                blk.put(read.ops[z].default if z in mine else 0.0, np.float32,
                        width=_MAX_CHANNELS)
        elif group.kind == "nv12":
            d[13] = group.tab_off
            d[15] = group.tab_off + 4 * (plan.dsize.width + plan.dsize.height)
        if group.held is not None:  # a ragged BatchRead group
            d[9] = blk.put(read.used_planes, np.int32, width=1)
            d[6] = blk.put(_held_default(read.default, group.held), np.float32,
                           width=_MAX_CHANNELS)
        d[12] = blk.size
        for v in flatten(tuple(seq.compute))[1]:
            blk.put(v, np.float32)
    blk.put(np.zeros(-blk.size % 4, np.int32), np.int32)  # the kernel reads 16-byte words
    desc_off = blk.put(desc, np.int32)
    return Launch(plan=plan, seqs=tuple(seqs), srcs=tuple(srcs), block=blk.to(device),
                  ptr_off=ptr_off, desc_off=desc_off, consts=plan.device_tables(device))


def _held_default(default, dtype: torch.dtype):
    """A ragged ``BatchRead``'s default as its planes hold it: cast to the
    read's ``dtype`` (``BatchRead._mask``), as float32 values for every
    channel (a scalar broadcast), on the default's own device."""
    if isinstance(default, torch.Tensor):
        return kw._padded_tensor(default.to(dtype), _MAX_CHANNELS, default.device)
    return kw._padded(torch.as_tensor(np.asarray(default), dtype=dtype).numpy(), _MAX_CHANNELS)


def merge(seqs, plane_ids):
    """The eager version of a divergent batch (``executor.py:364-381`` of
    the reference): each sequence lowers only its own planes and runs its
    chain; the results are scattered into one batch of the dtype of plane
    0's sequence, then the first sequence's write."""
    n = len(plane_ids)
    merged = None
    for sid, planes in groups_of(plane_ids).items():
        s = seqs[sid - 1]
        x = s.read.lower_planes(tuple(planes))
        for o in s.compute:
            x = o.apply(x)
        if merged is None:
            merged = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        elif tuple(x.shape[1:]) != tuple(merged.shape[1:]):
            raise ValueError(f"sequence {sid} gives planes of {tuple(x.shape[1:])}, "
                             f"plane 0's sequence {tuple(merged.shape[1:])}")
        merged[torch.as_tensor(planes, device=x.device)] = dt.astype(x, merged.dtype)
    return seqs[0].write.write(merged)


def divergent_reference(a: Launch):
    """The plain PyTorch version of the kernel on the launch's device:
    :func:`merge` of the sequences with every leaf there."""
    dev = a.block.device
    return merge(map_leaves(a.seqs, lambda v: as_device_tensor(v, dev)), a.plan.plane_ids)


def _check(a: Launch) -> None:
    plan = a.plan
    dev = a.block.device
    for name, t in (("block", a.block), ("consts", a.consts)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} is not a contiguous int32 tensor on {dev}")
    if a.consts.numel() != plan.consts.size or a.ptr_off % 2:
        raise ValueError("tables or source addresses do not match the plan")
    if not 0 < a.desc_off <= a.block.numel() - DESC_INTS * len(plan.groups):
        raise ValueError("descriptors lie outside the parameter block")
    dtypes = {gr.src_dtype for gr in plan.groups}
    for s in a.srcs:
        if s.device != dev or s.dtype not in dtypes or not s.is_contiguous():
            raise ValueError(f"source {s.dtype} on {s.device} does not match the plan")


def divergent(a: Launch):
    """The kernel wrapper: launches on a CUDA tensor, runs the plain version
    on a CPU tensor, raises on anything else. It never falls back."""
    global LAUNCHES
    dev = a.block.device
    if dev.type == "cpu":
        return divergent_reference(a)
    if dev.type != "cuda":
        raise ValueError(f"divergent runs on CUDA or CPU tensors, not {dev}")
    _check(a)
    lib = _build.load()
    plan = a.plan
    buf, (sn, sc, sy, sx), result = kbr._alloc_out(plan, dev)
    w, h = plan.dsize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cvgs_divergent(
            a.block.data_ptr(), a.consts.data_ptr(), a.ptr_off, a.desc_off, len(plan.groups),
            plan.n_planes, w, h, buf.data_ptr(), int(plan.out_dtype == torch.uint8), plan.out_ch,
            sn, sc, sy, sx, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"divergent launch failed: CUDA error {err} ({lib.cvgs_error_string(err).decode()})"
        )
    LAUNCHES += 1
    return result


def run(seqs, plan: DivergentPlan, device: torch.device):
    """One call of the kernel path: gather the arguments, launch."""
    return divergent(prepare(seqs, plan, device))


#: the wrapper, under the name every kernel module gives it (no ``out``)
launch = divergent


def _touched_bytes(a: Launch) -> int:
    """Source bytes the batch touches: each sequence's read on its own
    planes, by the rule of the kernel it shares a sampler with."""
    from .. import build_pipeline, write
    from . import cuda_frame_resize as kfr

    ids, total = a.plan.plane_ids, 0
    for sid, seq in enumerate(a.seqs, 1):
        planes = [z for z, i in enumerate(ids) if i == sid]
        read = seq.read
        if isinstance(read, (ImageRead, CircularBatchRead)):  # a plane is read whole
            total += len(planes) * read.data[0].numel() * read.data.element_size()
        elif isinstance(read, BatchResizeRead):
            total += bounds.crop_touched_bytes(read, planes)
        else:  # a BatchRead of images, warps or NV12 resizes, one source per plane
            used = len(ids) if read.used_planes is None else int(torch.as_tensor(read.used_planes))
            for z in planes:
                if z >= used:  # a ragged group's plane holds its default: nothing is read
                    continue
                op = read.ops[z]
                one = build_pipeline(op, write())
                if isinstance(op, ImageRead):
                    total += op.data.numel() * op.data.element_size()
                elif isinstance(op, WarpRead):
                    total += bounds.warp_touched_bytes(
                        kw.prepare(one, kw.build_plan(one), a.block.device))
                else:
                    total += bounds.touched_bytes(kfr.build_plan(one))
    return total


def work(a: Launch) -> Tuple[int, int, int]:
    """``(output bytes, source bytes touched, float32 operations)`` of one
    launch (``utils.bounds``): 14 operations per value."""
    out_bytes, values = bounds.output(a.plan)
    return out_bytes, _touched_bytes(a), values * 14
