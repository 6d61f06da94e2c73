"""The warp kernel: plan, plain version, wrapper.

Counterpart of the reference's three warp kernels, ``exec/pallas_warp.py``
(separable affine), ``exec/pallas_warp_general.py`` (affine with cross
terms) and ``exec/pallas_warp_universal.py`` (any affine, perspective, and
the batched form). One launch of ``csrc/warp.cu`` computes a pipeline of
the form

    WarpRead(ImageRead)                          -> chain -> write
    BatchRead(WarpRead(ImageRead), ...)          -> chain -> write

A single warp is a batch of one plane. :func:`build_plan` checks the
structure once and encodes the chain (``cuda_batch_resize.encode_chain``).
:func:`prepare` gathers one call's arguments: a table of per-plane source
pointers (one source passed N times is one buffer, moved to the device
once), each plane's float32 inverse-map coefficients and border, the
batch default and the chain scalars, all in one pinned buffer with one
non-blocking copy. The kernel recomputes every coordinate from the
coefficients; :func:`warp_reference`, the plain PyTorch version, reads
the factory's coordinate term vectors instead (the eager ``lower``), each
chain op's own ``apply`` and the write op, so holding the two together
checks the recomputation and the packing.

The TPU kernels' gates (separable or consumer-unique maps, derivative
buckets, ``src_h % 8``, lanes a multiple of 128, uint8 sources, a positive
perspective denominator) exist because Mosaic has no dynamic gather; none
comes over: a source of any dtype of ``SRC_DTYPES`` is read into float32, as
the eager warp reads it. The kernel refuses a warp of anything but one image, a batch
whose planes differ in warp type, size, source geometry or dtype, and
more than 4 channels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph import flatten, map_leaves
from ..ops.memory import BatchRead, ImageRead, SplitWrite, TensorSplit, Write2D
from ..ops.warp import WarpRead
from ..types import Size, WarpType
from ..utils.dtypes import as_device_tensor, kernel_source
from ..utils import bounds
from . import _build
from . import cuda_batch_resize as kbr
from . import cuda_frame_resize as kfr
from .cuda_batch_resize import _MAX_CHANNELS, _MAX_PLANES, SRC_DTYPES, Unsupported

#: launches of the CUDA kernel in this process
LAUNCHES = 0

can_store = kbr.can_store

_SINGLE_LAYOUTS = {Write2D: "packed", TensorSplit: "split", SplitWrite: "split_write"}
_N_COEFFS = 9       # per plane in the parameter block; an affine map uses 6
_MAX_SIDE = 1 << 24  # source sides exact in float32


@dataclasses.dataclass(frozen=True)
class WarpPlan:
    """Everything about one pipeline structure that the kernel needs."""

    batch: bool            # a BatchRead (output has a plane axis)
    n_planes: int
    perspective: bool
    src_h: int
    src_w: int
    nch: int
    src_dtype: torch.dtype
    dsize: Size
    masked: bool           # the batch has a used_planes count
    out_ch: int
    out_dtype: torch.dtype
    layout: str
    ops: np.ndarray        # (n_ops, 4) int32
    n_fparams: int         # chain scalars
    #: per-device copies of the op table
    device_consts: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def consts(self, device: torch.device) -> torch.Tensor:
        c = self.device_consts.get(device)
        if c is None:
            c = torch.from_numpy(self.ops.reshape(-1).copy()).to(device)
            self.device_consts[device] = c
        return c


def _planes(read) -> Tuple[Tuple[WarpRead, ...], bool]:
    """``(warps, batch)`` of a read the kernel takes; raises
    :class:`Unsupported`."""
    if isinstance(read, WarpRead):
        return (read,), False
    if isinstance(read, BatchRead):
        if not read.ops or not all(isinstance(o, WarpRead) for o in read.ops):
            raise Unsupported("a BatchRead of anything but WarpReads")
        return tuple(read.ops), True
    raise Unsupported(f"read is {type(read).__name__}, not WarpRead or BatchRead")


def _geometry(src) -> Tuple[int, int, int, str]:
    """``(src_h, src_w, nch, dtype name)`` of one image source."""
    if not isinstance(src, ImageRead) or src.is_batch:
        raise Unsupported(f"warp source {type(src).__name__} is not one image")
    shape = tuple(src.data.shape)
    pc = src.packed_channels
    if pc and len(shape) == 2:
        h, w, c = shape[0], shape[1] // pc, pc
    elif not pc and len(shape) in (2, 3):
        h, w, c = shape[0], shape[1], (shape[2] if len(shape) == 3 else 1)
    else:
        raise Unsupported(f"image of shape {shape}")
    return h, w, c, kbr._leaf_dtype_name(src.data)


def _size(leaf) -> int:
    return int(np.prod(tuple(leaf.shape))) if hasattr(leaf, "shape") else 1


def build_plan(pipeline) -> WarpPlan:
    """The kernel plan of a pipeline; raises :class:`Unsupported`."""
    warps, batch = _planes(pipeline.read)
    layouts = kbr._LAYOUTS if batch else _SINGLE_LAYOUTS
    if type(pipeline.write) not in layouts:
        raise Unsupported(f"write {type(pipeline.write).__name__}")
    w0 = warps[0]
    geom = _geometry(w0.source)
    src_h, src_w, nch, dtype_name = geom
    src_dtype = SRC_DTYPES.get(dtype_name)
    if src_dtype is None:
        raise Unsupported(f"source dtype {dtype_name}")
    if not 1 <= nch <= _MAX_CHANNELS:
        raise Unsupported(f"{nch} channels")
    if not (1 <= src_h < _MAX_SIDE and 1 <= src_w < _MAX_SIDE):
        raise Unsupported(f"source of {src_h}x{src_w}")
    if not 1 <= len(warps) <= _MAX_PLANES:
        raise Unsupported(f"{len(warps)} planes")
    perspective = w0.warp_type == WarpType.PERSPECTIVE
    for w in warps:
        if w.warp_type != w0.warp_type or w.dsize != w0.dsize:
            raise Unsupported("planes differ in warp type or size")
        if _geometry(w.source) != geom:
            raise Unsupported("planes differ in source geometry or dtype")
        if _size(w.coeffs) != (9 if perspective else 6):
            raise Unsupported(f"{_size(w.coeffs)} coefficients for a {w.warp_type.name} map")
        if _size(w.default) != nch:
            raise Unsupported(f"border of {_size(w.default)} values on {nch} channels")
    read = pipeline.read
    masked = batch and read.used_planes is not None
    if masked and (_size(read.used_planes) != 1 or _size(read.default) not in (1, nch)):
        raise Unsupported("used_planes must be one value and default one per channel or one")
    ops, out_dtype, out_ch, n_fparams = kbr.encode_chain(pipeline.compute, nch)
    dst_w, dst_h = w0.dsize
    if dst_w < 1 or dst_h < 1:
        raise Unsupported(f"dsize {w0.dsize}")
    return WarpPlan(
        batch=batch, n_planes=len(warps), perspective=perspective, src_h=src_h, src_w=src_w,
        nch=nch, src_dtype=src_dtype, dsize=w0.dsize, masked=masked, out_ch=out_ch,
        out_dtype=out_dtype, layout=layouts[type(pipeline.write)], ops=ops, n_fparams=n_fparams,
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

    plan: WarpPlan
    pipeline: object              # the executor's Pipeline the arguments come from
    srcs: Tuple[torch.Tensor, ...]  # the distinct sources, contiguous
    plane_src: Tuple[int, ...]    # index into srcs of each plane's source
    ptrs: torch.Tensor            # (N,) int64: each plane's source address
    used: torch.Tensor            # (1,) int32
    coeffs: torch.Tensor          # (N * 9,) float32
    border: torch.Tensor          # (N * 4,) float32
    default: torch.Tensor         # (4,) float32
    fparams: torch.Tensor         # (n_fparams,) float32: the chain scalars
    ops: torch.Tensor             # (n_ops * 4,) int32


def _padded(v, n: int):
    """A host float32 vector of ``n`` entries: ``v`` broadcast when it has
    one entry, else zero-padded."""
    a = np.asarray(v, np.float32).reshape(-1)
    if a.size == 1:
        return np.full(n, a[0], np.float32)
    return np.concatenate([a, np.zeros(n - a.size, np.float32)])


def _padded_tensor(v, n: int, device) -> torch.Tensor:
    t = as_device_tensor(v, device).to(torch.float32).reshape(-1)
    if t.numel() == 1:
        return t.expand(n)
    return torch.cat([t, torch.zeros(n - t.numel(), dtype=torch.float32, device=device)])


def prepare(pipeline, plan: WarpPlan, device: torch.device) -> Launch:
    """Gather one call's arguments on ``device``: host leaves travel in one
    int32 buffer with one pinned, non-blocking copy; device leaves stay where
    they are. Its host work grows with the plane count, never with the
    output size, and nothing here waits for the device."""
    warps, _ = _planes(pipeline.read)
    read = pipeline.read
    srcs: List[torch.Tensor] = []
    index: Dict[int, int] = {}
    plane_src = []
    for w in warps:
        data = w.source.data
        k = index.get(id(data))
        if k is None:
            k = index[id(data)] = len(srcs)
            srcs.append(kernel_source(data, device).contiguous())
        plane_src.append(k)
    ptrs = np.asarray([srcs[k].data_ptr() for k in plane_src], np.uint64)

    n = plan.n_planes
    dflt = read.default if plan.masked else 0.0
    fleaves = ([w.coeffs for w in warps] + [w.default for w in warps] + [dflt]
               + flatten(tuple(pipeline.compute))[1])
    host = [ptrs.view(np.int32)]
    used = None
    if not plan.masked:
        host.append(np.asarray([n], np.int32))
    elif isinstance(read.used_planes, torch.Tensor):
        used = read.used_planes.to(torch.int32).reshape(1)
    else:
        host.append(np.asarray(read.used_planes, np.int32).reshape(1))
    on_device = any(isinstance(v, torch.Tensor) for v in fleaves)
    if not on_device:
        host.append(np.concatenate(
            [_padded(w.coeffs, _N_COEFFS) for w in warps]
            + [_padded(w.default, _MAX_CHANNELS) for w in warps]
            + [_padded(dflt, _MAX_CHANNELS)]
            + [np.asarray(v, np.float32).reshape(-1) for v in fleaves[2 * n + 1:]]
        ).view(np.int32))
    buf = as_device_tensor(np.concatenate(host), device)
    ptr_t = buf[:2 * n].view(torch.int64)
    pos = 2 * n
    if used is None:
        used = buf[pos:pos + 1]
        pos += 1
    if on_device:
        floats = torch.cat(
            [_padded_tensor(w.coeffs, _N_COEFFS, device) for w in warps]
            + [_padded_tensor(w.default, _MAX_CHANNELS, device) for w in warps]
            + [_padded_tensor(dflt, _MAX_CHANNELS, device)]
            + [as_device_tensor(v, device).to(torch.float32).reshape(-1)
               for v in fleaves[2 * n + 1:]])
    else:
        floats = buf[pos:].view(torch.float32)
    c0, c1, c2 = n * _N_COEFFS, n * (_N_COEFFS + _MAX_CHANNELS), n * (_N_COEFFS + _MAX_CHANNELS) + 4
    return Launch(plan=plan, pipeline=pipeline, srcs=tuple(srcs), plane_src=tuple(plane_src),
                  ptrs=ptr_t, used=used, coeffs=floats[:c0], border=floats[c0:c1],
                  default=floats[c1:c2], fparams=floats[c2:], ops=plan.consts(device))


def warp_reference(a: Launch):
    """The plain PyTorch version of the kernel on the launch's sources and
    ``used_planes``: the eager ``WarpRead.lower`` (coordinate term vectors,
    tap replacement, lerps) or ``BatchRead.lower``, each chain op's own
    ``apply`` and the write op."""
    p = a.pipeline
    dev = a.srcs[0].device

    def on_launch(w: WarpRead, k: int) -> WarpRead:
        w = dataclasses.replace(w, source=dataclasses.replace(w.source, data=a.srcs[k]))
        return map_leaves(w, lambda v: as_device_tensor(v, dev))

    warps, batch = _planes(p.read)
    if batch:
        read = BatchRead(
            ops=tuple(on_launch(w, k) for w, k in zip(warps, a.plane_src)),
            used_planes=a.used if a.plan.masked else None,
            default=as_device_tensor(p.read.default, dev) if a.plan.masked else None,
        )
    else:
        read = on_launch(warps[0], 0)
    val = read.lower()
    for o in p.compute:
        val = o.apply(val)
    return p.write.write(val)


def _alloc_out(plan, device, out=None):
    """``(buffer, (sn, sc, sy, sx), result)`` of the plan's write layout,
    allocated, or over the caller's view ``out``."""
    if plan.batch:
        return kbr._alloc_out(plan, device, out)
    buf, strides, result = kfr._alloc_out(plan, device, out)
    return buf, (0, *strides), result


def _check(a: Launch) -> None:
    plan = a.plan
    dev = a.srcs[0].device
    n = plan.n_planes
    for name, t, dtype, size in (
            ("ptrs", a.ptrs, torch.int64, n), ("used", a.used, torch.int32, 1),
            ("coeffs", a.coeffs, torch.float32, n * _N_COEFFS),
            ("border", a.border, torch.float32, n * _MAX_CHANNELS),
            ("default", a.default, torch.float32, _MAX_CHANNELS),
            ("fparams", a.fparams, torch.float32, plan.n_fparams),
            ("ops", a.ops, torch.int32, plan.ops.size)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the source on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous() or t.numel() != size:
            raise ValueError(f"{name} is not {size} contiguous values")
    if len(a.plane_src) != n:
        raise ValueError("plane table does not match the plan")
    for s in a.srcs:
        if s.device != dev or s.dtype != plan.src_dtype or not s.is_contiguous():
            raise ValueError(f"source {s.dtype} on {s.device} does not match the plan")
        if s.numel() != plan.src_h * plan.src_w * plan.nch or s.shape[0] != plan.src_h:
            raise ValueError(f"source of shape {tuple(s.shape)} does not match the plan")


def warp(a: Launch, out: Optional[torch.Tensor] = None):
    """The kernel wrapper: launches on a CUDA tensor, runs the plain version
    on a CPU tensor, raises on anything else. It never falls back. With
    ``out`` (a view of the write's shape, any strides, any dtype of
    ``TYPE_CODES``, cast as ``cuda_batch_resize.store_cast`` says; a ring
    slot) the result is stored there and ``out`` is returned."""
    global LAUNCHES
    dev = a.srcs[0].device
    if dev.type == "cpu":
        result = warp_reference(a)
        return result if out is None else kbr.reference_into(result, out, dev)
    if dev.type != "cuda":
        raise ValueError(f"warp runs on CUDA or CPU tensors, not {dev}")
    _check(a)
    lib = _build.load()
    plan = a.plan
    kbr.check_out_dtype("warp", plan, out)
    buf, (sn, sc, sy, sx), result = _alloc_out(plan, dev, out)
    w, h = plan.dsize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cvgs_warp(
            a.ptrs.data_ptr(), kbr.SRC_CODES[plan.src_dtype], plan.src_h, plan.src_w,
            plan.nch, int(plan.perspective), a.coeffs.data_ptr(), a.border.data_ptr(),
            a.default.data_ptr(), a.used.data_ptr(), a.fparams.data_ptr(), a.ops.data_ptr(),
            plan.ops.shape[0], plan.n_planes, w, h,
            buf.data_ptr(), kbr.TYPE_CODES[buf.dtype], plan.out_ch,
            kbr.store_cast(plan.out_dtype, buf.dtype), sn, sc, sy, sx, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"warp launch failed: CUDA error {err} ({lib.cvgs_error_string(err).decode()})"
        )
    LAUNCHES += 1
    _build.after_launch("warp", dev)
    return result


def run(pipeline, plan: WarpPlan, device: torch.device, out=None):
    """One call of the kernel path: gather the arguments, launch."""
    return warp(prepare(pipeline, plan, device), out)


#: the wrapper, under the name every kernel module gives it
launch = warp


def work(a: Launch) -> Tuple[int, int, int]:
    """``(output bytes, source bytes touched, float32 operations)`` of one
    launch (``utils.bounds``): 14 operations per value for the two
    coordinates and the lerps, one per chain row."""
    out_bytes, values = bounds.output(a.plan)
    return out_bytes, bounds.warp_touched_bytes(a), values * (14 + a.plan.ops.shape[0])
