"""The composed-read kernel: plan, plain version, wrapper.

Counterpart of the one jitted XLA program that
``cvgpuspeedup_tpu/exec/executor.py::_compiled`` builds for a read tree no
Pallas kernel takes (``pallas_frame.py::_source_array``,
``pallas_backend.py::supports`` and ``pallas_warp_universal.py`` refuse
composed reads, so XLA fuses them). One launch of ``csrc/composed.cu``
computes a pipeline whose read is, from the output inwards,

    read   := plane | BatchRead(plane, ..., [used_planes, default])
    plane  := outer* core
            | outer* [Resample2] above* [FusedRead2] below* Resample(inner)
                                                     (Resample2 or FusedRead2)
    outer  := CropRead | BorderRead                  (<= MAX_STAGES)
    core   := Resample(inner) | inner
    inner  := upper* [FusedRead] lower* base         (<= MAX_STAGES crops
              and borders in all; so above* and below*)
    Resample, Resample2 := ResizeRead | WarpRead
    base   := ImageRead of one frame | ReadYUV

then the pointwise chain and any write. A ``BatchRead`` (the reference's
``batch_read``, ``crop_batch``, ``warp_batch`` of crops) takes N planes
whose trees have one shape (``_one_shape``: equal op types, border modes,
interpolation, warp type, chain structure, the base's kind, dtype and
channels, and one output size); they differ in their leaves (the source
array, crop origins, border values, warp coefficients, chain scalars) and
may differ in their geometry: the base's height and width, each crop's and
border's sizes, a resample's ``dsize`` (cameras of mixed resolution, ROIs of
their own sizes, letterboxes of their own aspect; for nested planes also the
middle image's size and the second resample's taps). A batch of one geometry
runs one head on every plane; a mixed one (``MIXED``) has each plane's head
and tap tables in the consts (``_mixed``), which its own kernel instances
read per block (a nested plane's with its own ``stage2``: staged and per-tap
planes in one launch). Its planes ``z >= used_planes`` hold
``default`` cast to the read value's dtype. A one-frame read with no
resampling node is the kernel's only with a ``FusedRead`` below a stage;
every other such tree is the pointwise kernel's (a ``BatchRead``'s planes
may be bare bases). A plane with a second level above the core (a second
resampling node, ``resize(warp)``, ``warp(resize)``, ``resize(resize)``,
``resize(crop(resize))``, or a fused read above the core,
``make_border(fuse(resize(..), op))``) is a *nested* plan (``core2``): its
own kernel instances (``csrc/composed_nested.cuh``): where a tile's
pixels share the second level's taps (the ``stage2`` word, from the
structure: a warp, or a resize whose :func:`tap_share` is at most
``STAGE_SHARE``) a block stages its footprint of them, each value of the
inner core there evaluated once; else, and in a block whose footprint
passes the budget, the core is evaluated at each tap
(:func:`nested_tiles` mirrors which blocks stage).

A divergent batch (``executor.launch_divergent_batch``: sequence
``plane_ids[z]`` on plane ``z``) that the divergent kernel
(``cuda_divergent``) refuses is one launch here where every group, a
sequence on its planes, is a ``BatchRead`` that :func:`build_plan` takes
over those planes, one level or nested (letterboxes, ROI resizes, camera
resizes, warps of crops, ``crop_batch``, top views resized, rotated
downscales), of any source dtype: groups may differ in everything but the
output (C, H, W) (:func:`build_divergent_plan`, the ``DIVERGENT`` batch
word). The executor tries the divergent kernel, then this plan
(``cuda:composed:divergent``), then the eager merge. Each plane's head is
its group's for that plane with absolute block offsets; groups of one kind
of source and one store row run that kind's mixed instances, any other
batch of images the general ones (``csrc/composed_divergent.cu``, and
``csrc/composed_nested_divergent.cu`` for nested heads). Where any group is
nested every head is a nested one, each nested plane with its own
``stage2``: a plane without a second resample beside one with it (a
letterbox beside a top view) carries an identity resize as its second
level, which copies its value (:func:`_lift`); with no second resample in
the batch a one-level plane carries an empty ``FusedRead2`` instead. A
group of a kind only the divergent kernel reads (a ring, a batched image
stack, ``resize_batch``) beside composed groups, and an NV12 group of the
divergent kernel's kind beside image groups, run in one launch of the
split kernel (``cuda_divergent_split``, the third route): the divergent
kernel's body on that group's planes, this kernel's general bodies on the
others', whose plan is :func:`build_divergent_plan` of those groups alone
(``sids``). It stays eager (:func:`build_divergent_plan` names each): an
NV12 group the divergent kernel refuses beside an image group; NV12
groups whose chains end in different dtypes (the NV12 instances store with
one row); a resampling group beside a one-pixel group; groups of different
output (C, H, W); groups converting YUV with different coefficients; and a
group that :func:`build_plan` refuses (a third resampling node).

What stays eager, and why (``_plane``
names each):

- a third resampling node (``resize(warp(resize))``): the kernel nests two;
- a second ``FusedRead`` in one section (between two resampling nodes,
  under the core, or above a core with no resampling node): one fused chain
  runs per tap of each level;
- a batched image under a resample or in a ``BatchRead`` plane: a plane
  reads one frame;
- a ``BatchRead`` whose planes differ in more than geometry (op types,
  modes, chains, the base's dtype, kind or channels, the output size: the
  divergent kernel's ground), or of a ``BatchRead``, a ring or another
  read: a plane's structure is shared;
- more than ``MAX_STAGES`` crops and borders above the core, between two
  resampling nodes, or below the core;
- the float ``FusedRead`` of NV12 that the full-frame kernel resizes
  commuted (also as the inner core of a nested tree); uint32 and bool
  sources.

Semantics, each as the eager lowering computes it:

- the resample reads the *inner virtual image*: a resize's taps
  (``ops/resize.py::axis_taps``, host tables) over its size, with the edge
  rule ``keeps_edge_weight`` picks for that size; a warp's coordinates
  recomputed from the block's float32 coefficients (``csrc/warp.cuh``), a
  tap outside that image reads the border value;
- each tap's position walks the stages between the core and the
  ``FusedRead`` (*upper*), then those below it (*lower*), as
  ``csrc/pointwise.cuh::walk_stages`` walks them; the base's value (or a lower
  CONSTANT border's value cast to the source's dtype) goes through the
  ``FusedRead`` 's chain per tap; an upper CONSTANT border gives its value
  cast to the chain's dtype without the chain; a resample then reads the
  value as float32;
- a nested plane's second level reads the inner core's float32 output as a
  tap reads the base: each tap of ``Resample2`` (its tap tables and edge
  rule from its own source's size) walks the *above* stages, then the
  *below* ones; the core's value there (or a below CONSTANT border's value
  cast to float32) goes through ``FusedRead2``'s chain; an above CONSTANT
  border gives its value cast to that chain's dtype without the chain; a
  warp's tap outside its source reads the warp's border value;
- the outer stages walk each output pixel's position into the core's output
  (a nested plane's: the second level's); an outer CONSTANT border's value
  is cast to the read value's dtype;
- a ``BatchRead`` stacks its planes; a plane past ``used_planes`` reads
  nothing and holds the default; the pipeline's chain then runs on every
  plane;
- a divergent batch's group computes its own planes alone, each as the
  group's pipeline, and its values are cast into the batch's dtype (plane
  0's group's) as ``utils.dtypes.astype`` casts, by its store row
  (``cuda_batch_resize.store_cast``); a ragged group's planes from its
  ``used_planes`` on (counted over the batch's planes) hold its default;
  the first sequence's write.

:func:`build_plan` turns the structure into a :class:`ComposedPlan` once
(per mix of sizes, as the reference compiles one program per static
shapes): the head's words (three ``PwHead`` stage lists and the core's
fields, all of one plane; a nested plan's two more stage lists and the
second level's fields after them; a mixed batch's every plane's head,
:meth:`ComposedPlan.for_plane`), the op tables and the resizes' tap
tables, and the block's layout. Runtime values ride one int32 block per call and key no plan: a
batch's source addresses, then each plane's values (crop origins, border
values, warp coefficients and border, the fused chain's scalars) at a
stride of ``plane_stride`` words (the head holds plane 0's offsets), then
the pipeline chain's scalars, ``used_planes`` and the default.

:func:`composed` is the wrapper: on a CUDA tensor it launches the kernel,
on a CPU tensor it runs :func:`composed_reference`, the plain PyTorch
version. That one computes the same function from the plan's words and the
block: the stage walks, the tap tables, the coordinates from the
coefficients, each chain op's own ``apply`` and the write, with the
``utils.dtypes`` flush ops; so holding it against the eager lowering checks
the plan, and holding the kernel against it checks the CUDA code.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph import ComputeOp, FusedRead, ReadOp, _leaf_signature, flatten, map_leaves
from ..ops.border import BorderRead
from ..ops.crop import CropRead
from ..ops.memory import BatchRead, ImageRead
from ..ops.nv12 import ReadYUV
from ..ops.resize import ResizeRead, axis_taps, keeps_edge_weight
from ..ops.warp import WarpRead
from ..types import BorderMode, InterpolationType, PixelFormat, Size, WarpType
from ..utils import bounds
from ..utils import dtypes as dt
from ..utils.dtypes import as_device_tensor
from . import _build
from . import cuda_batch_resize as kbr
from . import cuda_pointwise as kp
from .cuda_batch_resize import (_MAX_CHANNELS, _MAX_PLANES, SRC_CODES, SRC_DTYPES, TYPE_CODES,
                                Unsupported, _leaf_dtype_name, encode_chain, store_cast)
from .cuda_divergent import _Block, _image_geometry, groups_of, moved_source
from .cuda_pointwise import BORDER_MODES, MAX_STAGES, STAGE_BORDER, STAGE_CROP, _stages, _unwrap
from .cuda_warp import _MAX_SIDE, _SINGLE_LAYOUTS, _size

__all__ = ["Unsupported", "build_plan", "build_divergent_plan", "divergent_instance", "supports",
           "prepare", "composed_reference", "composed", "run", "work", "tap_need", "LAUNCHES"]

#: launches of the CUDA kernel in this process
LAUNCHES = 0

# keep every code in step with csrc/composed.cuh
CORES = ("none", "resize", "warp")
#: the head's words: three PwHead stage lists (csrc/pointwise.cuh), then the core's
HEAD_INTS = 3 * kp.HEAD_INTS + 23
#: the ``batch`` word of a BatchRead whose planes differ in geometry: each
#: plane's head lies in the consts, HEAD_INTS words a plane from 0 (1: a
#: BatchRead of one geometry, 0: one frame)
MIXED = 2
#: the ``batch`` word of a divergent batch's plane heads
#: (:func:`build_divergent_plan`): each plane's head, its group's for that
#: plane with absolute block offsets (``plane_stride`` 0), lies in the
#: consts, HEAD_INTS words a plane from 0 (NESTED_INTS where any group is
#: nested), then each plane's store row
DIVERGENT = 3
_CORE_WORDS = ("core", "core_h", "core_w", "in_h", "in_w", "keep_edge", "persp", "coef_off",
               "border_off", "taps_off", "tap_type", "core_type", "tap_ch", "batch", "in_n_ops",
               "in_ops_off", "in_fp_off", "out_n_ops", "out_ops_off", "out_fp_off", "plane_stride",
               "used_off", "default_off")
assert len(_CORE_WORDS) == HEAD_INTS - 3 * kp.HEAD_INTS
#: a nested plan's second level, after its head's two more stage lists
#: (above, below): csrc/composed_nested.cuh::CmNested
_MID_WORDS = ("core2", "core2_h", "core2_w", "mid_h", "mid_w", "keep_edge2", "persp2",
              "coef2_off", "border2_off", "taps2_off", "mid_type", "mid_ch", "mid_n_ops",
              "mid_ops_off", "mid_fp_off", "stage2")
NESTED_INTS = HEAD_INTS + 2 * kp.HEAD_INTS + len(_MID_WORDS)
#: csrc/composed_nested.cuh's staging of a second resample: a block's tile
#: of outputs (x, y), the widest span of one axis's taps it flags, the most
#: positions it lists on an axis, the floats of its grid (kTile2W,
#: kTile2H, kSpan2, kList2, kGrid2)
TILE2, SPAN2, LIST2, GRID2 = (16, 16), 256, 64, 4096
#: a block's form (:func:`nested_tiles`)
TILE_FORMS = ("staged", "per_tap", "held")
#: a resize second level stages (``stage2``) where its tiles' distinct taps
#: are at most this share of the taps their pixels take one by one
#: (:func:`tap_share`): an upscale (2.5x: 0.05); a 3:1 downscale (1.0) and
#: a 2.4:1 one (N4, 1.0) share none and took 1.3-1.5x longer staged than
#: per tap on an H100 (PERF.md, PR 19)
STAGE_SHARE = 0.25
_N_COEFFS = 9  # block words of a warp's coefficients; an affine map uses 6
_CONSTANT, _REFLECT, _REFLECT_101, _WRAP = (BORDER_MODES[m] for m in (
    BorderMode.CONSTANT, BorderMode.REFLECT, BorderMode.REFLECT_101, BorderMode.WRAP))


@dataclasses.dataclass
class _Plane:
    """One plane's read taken apart: the stages outermost first in each list."""

    outer: List              # stages above the core (a nested plane's: above core2)
    core: object             # the ResizeRead or WarpRead; None for one pixel
    upper: List              # stages between the core and the FusedRead
    fused: object            # the FusedRead, or None
    lower: List              # stages between the FusedRead (else the core) and the base
    base: object             # the ImageRead or ReadYUV
    core2: object = None     # a nested plane's Resample2, or None
    above: List = dataclasses.field(default_factory=list)  # between core2 and fused2
    fused2: object = None    # a nested plane's FusedRead2, or None
    below: List = dataclasses.field(default_factory=list)  # between fused2 (else core2), core

    @property
    def nested(self) -> bool:
        """A second level above the core: a Resample2 or a FusedRead2."""
        return self.core2 is not None or self.fused2 is not None


@dataclasses.dataclass
class _Tree:
    """A pipeline's read taken apart."""

    chain: Tuple             # the pipeline's chain, FusedReads at the top included
    planes: Tuple            # one _Plane of a frame, or a BatchRead's N of one structure
    batch: bool              # a BatchRead
    used: object             # its used_planes, or None
    default: object          # its default, or None


def _names(read) -> str:
    """A read tree's op classes, outermost first: ``ResizeRead(CropRead(ImageRead))``."""
    inner = getattr(read, "source", None) or getattr(read, "read", None)
    return type(read).__name__ + (f"({_names(inner)})" if isinstance(inner, ReadOp) else "")


def _section(read):
    """``(upper, fused, lower, node)``: the crops and borders of a read, the
    ``FusedRead`` under them (or None) and those under it, and the read
    under them all; with no ``FusedRead`` every stage is ``lower``."""
    upper, node = _stages(read)
    if not isinstance(node, FusedRead):
        return [], None, upper, node
    lower, base = _stages(node.read)
    return upper, node, lower, base


def _plane(read, batch: bool) -> _Plane:
    """One plane's read taken apart; raises :class:`Unsupported` saying why
    the kernel cannot read it."""
    resample = (ResizeRead, WarpRead)
    outer, node = _stages(read)
    core2 = fused2 = None
    above: List = []
    below: List = []
    if isinstance(node, resample):
        core = node
        upper, fused, lower, base = _section(node.source)
        if isinstance(base, resample):  # a second resampling node
            core2, above, fused2, below, core = core, upper, fused, lower, base
            upper, fused, lower, base = _section(core.source)
    elif isinstance(node, FusedRead) and isinstance(_stages(node.read)[1], resample):
        # a FusedRead above the core
        fused2 = node
        below, core = _stages(node.read)
        upper, fused, lower, base = _section(core.source)
    else:
        core = None
        upper, fused, lower, base = _section(node)
    if isinstance(base, FusedRead):
        raise Unsupported("a second FusedRead in one section: one fused chain runs per tap of "
                          "each level")
    if isinstance(base, resample):
        raise Unsupported(f"a third resampling node, a {type(base).__name__} under the "
                          f"{type(core).__name__} under the {type(core2).__name__}: the kernel "
                          "nests two")
    if isinstance(base, BatchRead):
        raise Unsupported("a BatchRead inside a read: a plane reads one frame")
    if not isinstance(base, (ImageRead, ReadYUV)):
        raise Unsupported(f"read {type(base).__name__} under the core")
    if not batch and core is None and fused is None:
        raise Unsupported("no resampling node, no FusedRead under a stage and no BatchRead: "
                          "the pointwise kernel's")
    if isinstance(base, ImageRead) and base.is_batch:
        raise Unsupported("a batched ImageRead is not one frame")
    return _Plane(outer, core, upper, fused, lower, base, core2, above, fused2, below)


#: the static sizes each plane of a ``BatchRead`` may hold as its own (its
#: geometry); a base's height and width are the others
_GEOMETRY = {CropRead: ("width", "height"), BorderRead: ("top", "bottom", "left", "right"),
             ResizeRead: ("dsize",), WarpRead: ("dsize",)}
#: the field of each base whose leaf is the frame
_FRAMES = {ImageRead: "data", ReadYUV: "buffer"}
#: the runtime values that follow from an op's geometry and others of its
#: values, compared through those: a warp's terms of each column and row of
#: its ``dsize``, from its coefficients (which the kernel reads)
_SIZED = {WarpRead: ("col_x", "row_x", "col_y", "row_y", "col_w", "row_w")}
#: what a static field that differs between planes is called
_FIELD_NAMES = {"mode": "border mode", "interp": "interpolation", "warp_type": "warp type",
                "pixel_format": "NV12 format"}


def _difference(a, b) -> Optional[str]:
    """What differs between two planes' read trees beyond their geometry
    (``_GEOMETRY`` and the frames' heights and widths), or None: op types,
    modes, the fused chains' structure, the frames' dtype and channels, a
    runtime value's shape or dtype (``_SIZED``'s follow from the others)."""
    if type(a) is not type(b):
        what = "chain structure" if isinstance(a, ComputeOp) else "op types"
        return f"{what} ({type(a).__name__} and {type(b).__name__})"
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        fields = dataclasses.fields(a)
        for f in fields:  # an op's own static fields first, then its children
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if (f.metadata.get("static") and f.name not in _GEOMETRY.get(type(a), ())
                    and va != vb):
                what = ("chain structure" if isinstance(a, ComputeOp)
                        else _FIELD_NAMES.get(f.name, f"{type(a).__name__}.{f.name}"))
                return f"{what} ({va} and {vb})"
        for f in fields:
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if f.metadata.get("static") or f.name in _SIZED.get(type(a), ()):
                continue
            if _FRAMES.get(type(a)) == f.name:
                (_, sa, da), (_, sb, db) = _leaf_signature(va), _leaf_signature(vb)
                if da != db:
                    return f"source dtype ({da} and {db})"
                if len(sa) != len(sb) or sa[2:] != sb[2:]:
                    return f"channels (frames of shape {sa} and {sb})"
            else:
                d = _difference(va, vb)
                if d is not None:
                    return d
        return None
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            return f"chain structure ({len(a)} and {len(b)} ops)"
        return next((d for d in map(_difference, a, b) if d is not None), None)
    if a is None or b is None:
        return None if a is b else "op types (an op and none)"
    sa, sb = _leaf_signature(a), _leaf_signature(b)
    return None if sa == sb else f"a runtime value's shape or dtype ({sa[1:]} and {sb[1:]})"


def _one_shape(read: BatchRead) -> bool:
    """Raises :class:`Unsupported` unless the planes of ``read`` share one
    shape: their ``graph.flatten`` keys equal but for each plane's geometry
    (``_difference``); whether they share their geometry too (equal keys).
    The plan cache keys on the whole read, so a pipeline whose plan exists
    has passed this test."""
    if not read.ops:
        raise Unsupported("a BatchRead of no planes")
    key = flatten(read.ops[0])[0]
    one_geometry = True
    for z, o in enumerate(read.ops[1:], 1):
        if flatten(o)[0] == key:
            continue
        one_geometry = False
        what = _difference(read.ops[0], o)
        if what is not None:
            raise Unsupported(
                f"planes 0 and {z} of a BatchRead differ in {what} ({_names(read.ops[0])} and "
                f"{_names(o)}): the kernel runs one structure on every plane")
    return one_geometry


def _tree(pipeline) -> _Tree:
    """The pipeline's read taken apart; raises :class:`Unsupported`."""
    read, chain = _unwrap(pipeline)
    if not isinstance(read, BatchRead):
        return _Tree(chain, (_plane(read, False),), False, None, None)
    planes = tuple(_plane(o, True) for o in read.ops)
    return _Tree(chain, planes, True, read.used_planes, read.default)


def _base_geometry(base) -> Tuple[int, int, int, object]:
    """``(h, w, c, data)`` of a base."""
    if isinstance(base, ImageRead):
        h, w, c = _image_geometry(base)
        return h, w, c, base.data
    shape = tuple(base.buffer.shape)
    if len(shape) == 3 and shape[2] == 1:
        shape = shape[:2]
    if len(shape) != 2 or _leaf_dtype_name(base.buffer) != "uint8":
        raise Unsupported(f"NV12 buffer of shape {tuple(base.buffer.shape)} and dtype "
                          f"{_leaf_dtype_name(base.buffer)}")
    rows, w = shape
    h = rows * 2 // 3
    if h < 2 or h % 2 or w % 2 or h * 3 != rows * 2:
        raise Unsupported(f"NV12 buffer of shape {shape}")
    return h, w, 3, base.buffer


def _sizes(stages, h: int, w: int) -> List[Tuple[int, int]]:
    """Each stage's source size, outermost first, and the size above them
    all last; from the size (h, w) under them."""
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
    return sizes[-2::-1] + [sizes[-1]]


def _stage_words(stages, sizes, pos: int, ch: int) -> Tuple[List[int], int]:
    """The 8 words of each stage (``csrc/pointwise.cuh::PwStage``) with its
    block values from word ``pos`` on, zero-padded to ``MAX_STAGES``; and the
    position past them. A border value takes ``ch`` words."""
    words: List[int] = []
    for st, (sh, sw) in zip(stages, sizes):
        if isinstance(st, CropRead):
            if _size(st.x) != 1 or _size(st.y) != 1:
                raise Unsupported("a crop origin of more than one value")
            words += [STAGE_CROP, sh, sw, 0, pos, pos + 1, st.width, st.height]
            pos += 2
        else:
            if _size(st.value) not in (1, ch):
                raise Unsupported(f"border value of {_size(st.value)} entries on {ch} channels")
            words += [STAGE_BORDER, sh, sw, BORDER_MODES[st.mode], st.top, st.left, pos, 0]
            pos += ch
    return words + [0] * (8 * (MAX_STAGES - len(stages))), pos


def _stage_list(n_stages: int, words, base=0, h=0, w=0, c=0, src=0, nv21=0, conv=0, limited=0,
                width=0) -> Tuple[int, ...]:
    """One ``PwHead`` of words: a stage list, and for the lower list the base."""
    return (base, h, w, c, src, 1, -1, 0, nv21, n_stages, conv, limited, *words, width)


@dataclasses.dataclass(frozen=True)
class ComposedPlan:
    """Everything about one pipeline structure that the kernel needs;
    ``n_planes``, ``out_ch``, ``dsize``, ``out_dtype`` and ``layout`` size
    the output as the other kernels' ``_alloc_out`` do."""

    core: str
    batch: bool
    n_planes: int
    base: str                # "image" or "yuv"
    src_dtype: torch.dtype
    src_numel: int           # elements of the base's array
    dsize: Size              # the output planes' (W, H)
    out_ch: int
    out_dtype: torch.dtype
    tap_dtype: torch.dtype   # a tap's dtype after the FusedRead's chain
    layout: str
    head: Tuple[int, ...]    # HEAD_INTS words, csrc/composed.cuh::CmHead
    conv: Tuple[float, ...]  # (ys, cs, rv, gu, gv, bu) of the FusedRead's leading YUV -> RGB
    tables: np.ndarray       # int32: the FusedRead's op table, the pipeline's, the tap tables
    n_block: int             # words of the block
    #: a nested plan's second level: "resize", "warp" or "none" (a FusedRead2
    #: alone); "" for a plan of one level; a divergent batch's whose heads are
    #: nested, its first plane's second resample, else its lift's
    core2: str = ""
    mid_dtype: torch.dtype = torch.float32  # a second-level tap's dtype after FusedRead2's chain
    #: a mixed-geometry batch's plan of each plane (its head, the shared
    #: tables); () where the planes share one geometry
    planes: Tuple["ComposedPlan", ...] = dataclasses.field(default=(), compare=False, repr=False)
    #: a divergent batch's groups, in order of first appearance; () for a
    #: pipeline
    groups: Tuple["DivergentGroup", ...] = dataclasses.field(default=(), compare=False,
                                                             repr=False)
    #: per-device copies of the tables; the head as a ctypes array
    device_consts: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def for_plane(self, z: int) -> "ComposedPlan":
        """Plane ``z``'s plan: its own head (base, stage, core and tap table
        words) where the planes differ in geometry or in structure (a
        divergent batch), else the plan itself."""
        return self.planes[z] if self.planes else self

    @property
    def stores(self) -> Tuple[int, ...]:
        """A divergent batch's store row of each plane: its group's."""
        rows = [0] * self.n_planes
        for g in self.groups:
            for z in g.planes:
                rows[z] = g.store
        return tuple(rows)

    def word(self, name: str) -> int:
        """A word of the head by its name in ``_CORE_WORDS`` or, for a
        nested plan, ``_MID_WORDS``."""
        return self.head[_word_index(name)]

    def stage_list(self, k: int):
        """The stages of list ``k`` (0 lower, 1 upper, 2 outer; a nested
        plan's 3 above and 4 below) as 8-tuples."""
        at = k * kp.HEAD_INTS if k < 3 else HEAD_INTS + (k - 3) * kp.HEAD_INTS
        w = self.head[at:at + kp.HEAD_INTS]
        return [tuple(w[12 + 8 * s:20 + 8 * s]) for s in range(w[9])]

    def level(self, k: int) -> "_Level":
        """The resampling node of level ``k``: 0 the core, 1 a nested plan's
        second level."""
        names = (("core_h", "core_w", "in_h", "in_w", "keep_edge", "persp", "coef_off",
                  "border_off", "taps_off", "tap_ch") if k == 0 else
                 ("core2_h", "core2_w", "mid_h", "mid_w", "keep_edge2", "persp2", "coef2_off",
                  "border2_off", "taps2_off", "mid_ch"))
        return _Level(self.core if k == 0 else self.core2, *(self.word(n) for n in names))

    @property
    def value_dtype(self) -> torch.dtype:
        """The read value's dtype, to which an outer CONSTANT border's value
        and a held plane's default are cast: a resample's float32, else the
        dtype of the fused chain under the outer stages."""
        if (self.core2 or self.core) != "none":
            return torch.float32
        return self.mid_dtype if self.core2 else self.tap_dtype

    def consts(self, device: torch.device) -> torch.Tensor:
        c = self.device_consts.get(device)
        if c is None:
            c = self.device_consts[device] = torch.from_numpy(self.tables).to(device)
        return c

    def head_words(self):
        """The head as the C entry takes it: a mixed-geometry batch's heads
        of all planes, plane 0's first (a divergent batch's, then each
        plane's store row)."""
        c = self.device_consts.get("head")
        if c is None:
            words = [w for q in self.planes for w in q.head] if self.planes else list(self.head)
            if self.groups:
                words += self.stores
            c = self.device_consts["head"] = (ctypes.c_int * len(words))(*words)
        return c


@dataclasses.dataclass(frozen=True)
class _Level:
    """One resampling node's words: its kind ("resize", "warp", "none"),
    output and source sizes, edge rule, map kind, block offsets of a warp's
    coefficients and border, consts offset of a resize's tap tables, and the
    channels of its taps."""

    core: str
    core_h: int
    core_w: int
    in_h: int
    in_w: int
    keep: int
    persp: int
    coef_off: int
    border_off: int
    taps_off: int
    ch: int


def _table(ops: np.ndarray, ch: int) -> np.ndarray:
    """An op table as the kernel stages it: the rows, a sentinel, each
    row's channel count (``cuda_pointwise.PointwisePlan.consts``)."""
    row_ch, _ = kp.row_channels(ops, ch)
    return np.concatenate([ops.reshape(-1), np.zeros(1, np.int32), row_ch]).astype(np.int32)


def _resample(node, src_h: int, src_w: int, ch: int):
    """``(kind, out_h, out_w, keep_edge, persp, taps)`` of a resampling node
    over a source of ``src_h`` x ``src_w`` whose taps hold ``ch`` channels
    (a resize's edge rule and tap tables from that size); ``node`` None is
    one pixel of the source."""
    taps = np.zeros(0, np.int32)
    if isinstance(node, ResizeRead):
        if node.interp != InterpolationType.INTER_LINEAR:
            raise Unsupported(f"interpolation {node.interp}")
        if node._commuted_source() is not None:
            raise Unsupported("the float FusedRead of NV12 is resized commuted: the full-frame "
                              "kernel's")
        out_w, out_h = node.dsize
        keep = int(keeps_edge_weight(src_h, src_w, node.dsize))
        tx, ty = axis_taps(src_w, out_w, bool(keep)), axis_taps(src_h, out_h, bool(keep))
        taps = np.concatenate([tx[0], tx[1], ty[0], ty[1]]).astype(np.int32)
        taps = np.concatenate([taps, np.concatenate([tx[2], ty[2]]).astype(np.float32)
                               .view(np.int32)])
        return "resize", out_h, out_w, keep, 0, taps
    if isinstance(node, WarpRead):
        out_w, out_h = node.dsize
        persp = int(node.warp_type == WarpType.PERSPECTIVE)
        if _size(node.coeffs) != (9 if persp else 6):
            raise Unsupported(f"a warp of {_size(node.coeffs)} coefficients")
        if _size(node.default) not in (1, ch):
            raise Unsupported(f"warp border of {_size(node.default)} entries on {ch} channels")
        return "warp", out_h, out_w, 0, persp, taps
    return "none", src_h, src_w, 0, 0, taps


def build_plan(pipeline) -> ComposedPlan:
    """The kernel plan of a pipeline; raises :class:`Unsupported`. The
    planes of a ``BatchRead`` share one shape (``_one_shape``); where they
    differ in geometry, each plane's own plan (``_plane_plan``) gives its
    head, and the plan holds them all (``_mixed``)."""
    read, _ = _unwrap(pipeline)
    one_geometry = _one_shape(read) if isinstance(read, BatchRead) else True
    t = _tree(pipeline)
    plan = _plane_plan(t, t.planes[0], pipeline)
    if one_geometry:
        return plan
    return _mixed([plan, *(_plane_plan(t, p, pipeline) for p in t.planes[1:])])


def _plane_plan(t: _Tree, p: _Plane, pipeline) -> ComposedPlan:
    """The plan of the pipeline of tree ``t`` with every plane of plane
    ``p``'s geometry (its base's, stages' and resamples' sizes)."""
    h, w, c, data = _base_geometry(p.base)
    src_dtype = SRC_DTYPES.get(_leaf_dtype_name(data))
    if src_dtype is None:
        raise Unsupported(f"source dtype {_leaf_dtype_name(data)}")
    if not 1 <= c <= _MAX_CHANNELS:
        raise Unsupported(f"{c} channels")
    if max(h, w) >= _MAX_SIDE:
        raise Unsupported(f"a source of {w}x{h}")
    if (len(p.outer) > MAX_STAGES or len(p.upper) + len(p.lower) > MAX_STAGES
            or len(p.above) + len(p.below) > MAX_STAGES):
        raise Unsupported(f"{len(p.outer)} outer, {len(p.above) + len(p.below)} middle and "
                          f"{len(p.upper) + len(p.lower)} inner crops and borders, the kernel "
                          f"nests {MAX_STAGES} of each")
    n_planes = len(t.planes)
    if not 1 <= n_planes <= _MAX_PLANES:
        raise Unsupported(f"{n_planes} planes")

    # the inner value: the base, the lower stages, the FusedRead's chain
    lower_sizes = _sizes(p.lower, h, w)
    fused_chain = tuple(p.fused.chain) if p.fused is not None else ()
    conv, conv_first, limited, rows0, tap_dtype, tap_ch, fused_chain = kp.head_conversion(
        fused_chain, dt.canonical_dtype(src_dtype), c)
    in_ops, tap_dtype, tap_ch, n_in = encode_chain(fused_chain, tap_ch, dtype=tap_dtype)
    in_ops = np.concatenate([rows0, in_ops]).astype(np.int32)
    upper_sizes = _sizes(p.upper, *lower_sizes[-1])
    in_h, in_w = upper_sizes[-1]
    if max(in_h, in_w) >= _MAX_SIDE:
        raise Unsupported(f"an inner image of {in_w}x{in_h}")

    # the core
    core, core_h, core_w, keep, persp, taps = _resample(p.core, in_h, in_w, tap_ch)
    if min(core_h, core_w) < 1:
        raise Unsupported(f"an output of {core_w}x{core_h}")
    core_dtype = tap_dtype if core == "none" else torch.float32

    # a nested plane's second level over the core's float32 output: the
    # below stages, FusedRead2's chain, the above stages, Resample2
    core2, mid_dtype, mid_ch, n_mid = "", torch.float32, tap_ch, 0
    mid_ops, taps2 = np.zeros((0, 4), np.int32), np.zeros(0, np.int32)
    top_h, top_w, top_dtype = core_h, core_w, core_dtype
    if p.nested:
        below_sizes = _sizes(p.below, core_h, core_w)
        mid_ops, mid_dtype, mid_ch, n_mid = encode_chain(
            tuple(p.fused2.chain) if p.fused2 is not None else (), tap_ch, dtype=torch.float32)
        above_sizes = _sizes(p.above, *below_sizes[-1])
        mid_h, mid_w = above_sizes[-1]
        if max(mid_h, mid_w) >= _MAX_SIDE:
            raise Unsupported(f"a middle image of {mid_w}x{mid_h}")
        core2, top_h, top_w, keep2, persp2, taps2 = _resample(p.core2, mid_h, mid_w, mid_ch)
        # a warp's blocks stage their footprint (where it fits), a resize's
        # where its tiles share taps
        stage2 = int(core2 == "warp" or core2 == "resize" and tap_share(
            taps2, top_h, top_w, bool(keep2)) <= STAGE_SHARE)
        if min(top_h, top_w) < 1:
            raise Unsupported(f"an output of {top_w}x{top_h}")
        top_dtype = mid_dtype if core2 == "none" else torch.float32
    top_ch = mid_ch
    outer_sizes = _sizes(p.outer, top_h, top_w)
    out_h, out_w = outer_sizes[-1]

    # the block: a batch's source addresses (8-byte words, so first), then
    # each plane's values, plane_stride words apart: the outer stages', a
    # nested plane's Resample2 coefficients and border, above and below
    # stages' and FusedRead2's chain scalars, the warp's coefficients and
    # border, the upper and the lower stages', the FusedRead's chain scalars
    # (the head holds plane 0's offsets); then the pipeline chain's scalars,
    # used_planes and the default, and 4 zero words
    plane_off = 2 * n_planes if t.batch else 0
    outer_words, pos = _stage_words(p.outer, outer_sizes, plane_off, top_ch)
    if p.nested:
        coef2_off = border2_off = 0
        if core2 == "warp":
            coef2_off, border2_off = pos, pos + _N_COEFFS
            pos = border2_off + mid_ch
        above_words, pos = _stage_words(p.above, above_sizes, pos, mid_ch)
        below_words, pos = _stage_words(p.below, below_sizes, pos, tap_ch)
        mid_fp_off, pos = pos, pos + n_mid
    coef_off = border_off = 0
    if core == "warp":
        coef_off, border_off = pos, pos + _N_COEFFS
        pos = border_off + tap_ch
    upper_words, pos = _stage_words(p.upper, upper_sizes, pos, tap_ch)
    lower_words, pos = _stage_words(p.lower, lower_sizes, pos, c)
    in_fp_off, pos = pos, pos + n_in
    plane_stride = pos - plane_off
    pos = plane_off + n_planes * plane_stride
    out_ops, out_dtype, out_ch, n_out = encode_chain(t.chain, top_ch, dtype=top_dtype)
    out_fp_off, pos = pos, pos + n_out
    used_off = default_off = -1
    if t.used is not None:
        if _size(t.used) != 1:
            raise Unsupported(f"used_planes of {_size(t.used)} values")
        if _size(t.default) not in (1, top_ch):
            raise Unsupported(f"a default of {_size(t.default)} entries on {top_ch} channels")
        used_off, default_off = pos, pos + 1
        pos = default_off + top_ch

    layouts = kbr._LAYOUTS if t.batch else _SINGLE_LAYOUTS
    layout = layouts.get(type(pipeline.write))
    if layout is None:
        raise Unsupported(f"write {type(pipeline.write).__name__} of a "
                          f"{'batched' if t.batch else 'single'} value")
    in_table, out_table = _table(in_ops, c), _table(out_ops, top_ch)
    mid_table = _table(mid_ops, tap_ch) if p.nested else np.zeros(0, np.int32)
    tables = np.concatenate([in_table, out_table, taps, mid_table, taps2]).astype(np.int32)
    kind = "yuv" if isinstance(p.base, ReadYUV) else "image"
    nv21 = int(kind == "yuv" and p.base.pixel_format == PixelFormat.NV21)
    core_words = dict(
        core=CORES.index(core), core_h=core_h, core_w=core_w, in_h=in_h, in_w=in_w,
        keep_edge=keep, persp=persp, coef_off=coef_off, border_off=border_off,
        taps_off=in_table.size + out_table.size, tap_type=TYPE_CODES[tap_dtype],
        core_type=TYPE_CODES[top_dtype], tap_ch=tap_ch, batch=int(t.batch),
        in_n_ops=in_ops.shape[0], in_ops_off=0, in_fp_off=in_fp_off, out_n_ops=out_ops.shape[0],
        out_ops_off=in_table.size, out_fp_off=out_fp_off, plane_stride=plane_stride,
        used_off=used_off, default_off=default_off)
    head = (_stage_list(len(p.lower), lower_words, kp.BASES.index(kind), h, w, c,
                        SRC_CODES[src_dtype], nv21, conv_first, limited, tap_ch)
            + _stage_list(len(p.upper), upper_words) + _stage_list(len(p.outer), outer_words)
            + tuple(core_words[k] for k in _CORE_WORDS))
    if p.nested:
        mid_ops_off = in_table.size + out_table.size + taps.size
        mid_words = dict(
            core2=CORES.index(core2), core2_h=top_h, core2_w=top_w, mid_h=mid_h, mid_w=mid_w,
            keep_edge2=keep2, persp2=persp2, coef2_off=coef2_off, border2_off=border2_off,
            taps2_off=mid_ops_off + mid_table.size, mid_type=TYPE_CODES[mid_dtype],
            mid_ch=mid_ch, mid_n_ops=mid_ops.shape[0], mid_ops_off=mid_ops_off,
            mid_fp_off=mid_fp_off, stage2=stage2)
        head += (_stage_list(len(p.above), above_words) + _stage_list(len(p.below), below_words)
                 + tuple(mid_words[k] for k in _MID_WORDS))
    return ComposedPlan(
        core=core, batch=t.batch, n_planes=n_planes, base=kind, src_dtype=src_dtype,
        src_numel=int(np.prod(tuple(data.shape))), dsize=Size(out_w, out_h), out_ch=out_ch,
        out_dtype=out_dtype, tap_dtype=tap_dtype, layout=layout,
        head=tuple(int(v) for v in head), conv=conv, tables=tables, n_block=pos + 4,
        core2=core2, mid_dtype=mid_dtype)


def _word_index(name: str) -> int:
    """The index in a head of a word of ``_CORE_WORDS`` or ``_MID_WORDS``."""
    if name in _CORE_WORDS:
        return 3 * kp.HEAD_INTS + _CORE_WORDS.index(name)
    return HEAD_INTS + 2 * kp.HEAD_INTS + _MID_WORDS.index(name)


def _with_words(head: Tuple[int, ...], **words) -> Tuple[int, ...]:
    """``head`` with the ``_CORE_WORDS`` (and a nested head's
    ``_MID_WORDS``) named replaced."""
    out = list(head)
    for name, v in words.items():
        out[_word_index(name)] = int(v)
    return tuple(out)


def _mixed(plans: List[ComposedPlan]) -> ComposedPlan:
    """The plan of a ``BatchRead`` whose planes differ in geometry, from
    each plane's own plan: the tables hold every plane's head first
    (``HEAD_INTS`` words a plane, a nested plan's ``NESTED_INTS``; the
    kernel's block reads its plane's), then the op tables (a nested plan's
    FusedRead2 table last), alike on every plane, then each plane's tap
    tables (a nested plan's core's, then its second resample's); each head
    points at its own taps, and its ``batch`` word is ``MIXED``. A nested
    plane keeps its own ``stage2``. The plan is plane 0's, its planes' in
    :meth:`ComposedPlan.for_plane`; the shape test (``_one_shape``) leaves
    them one structure, which the C entry checks again plane by plane."""
    first = plans[0]
    for z, q in enumerate(plans[1:], 1):
        if q.dsize != first.dsize:
            raise Unsupported(
                f"planes 0 and {z} of a BatchRead differ in output size ({first.dsize.width}x"
                f"{first.dsize.height} and {q.dsize.width}x{q.dsize.height}): the planes must "
                "stack")
    nested = bool(first.core2)
    heads_size = len(plans) * (NESTED_INTS if nested else HEAD_INTS)
    ops_size = first.word("taps_off")  # the two op tables
    ops = [first.tables[:ops_size]]
    if nested:  # FusedRead2's table after them
        ops.append(first.tables[first.word("mid_ops_off"):first.word("taps2_off")])
    at = heads_size + sum(t.size for t in ops)
    heads, taps = [], []
    for q in plans:
        words = dict(batch=MIXED, in_ops_off=heads_size,
                     out_ops_off=heads_size + q.word("out_ops_off"), taps_off=at)
        if nested:
            tap = q.tables[q.word("taps_off"):q.word("mid_ops_off")]
            tap2 = q.tables[q.word("taps2_off"):]
            words.update(mid_ops_off=heads_size + ops_size, taps2_off=at + tap.size)
            tap = np.concatenate([tap, tap2])
        else:
            tap = q.tables[q.word("taps_off"):]
        heads.append(_with_words(q.head, **words))
        taps.append(tap)
        at += tap.size
    tables = np.concatenate([np.asarray(heads, np.int32).reshape(-1), *ops,
                             *taps]).astype(np.int32)
    planes = tuple(dataclasses.replace(q, head=hd, tables=tables, device_consts={})
                   for q, hd in zip(plans, heads))
    return dataclasses.replace(planes[0], planes=planes, device_consts={})


@dataclasses.dataclass(frozen=True)
class DivergentGroup:
    """One sequence of a divergent batch as the kernel reads it: its planes
    in order, the plan of its pipeline over those planes alone (its block's
    values from word ``2 * len(planes)`` on, as :func:`prepare` lays them
    out) and the row that stores its values into the batch's dtype
    (``cuda_batch_resize.store_cast``, 0 for none)."""

    sid: int
    planes: Tuple[int, ...]
    plan: ComposedPlan
    store: int


def _group_pipeline(seq, planes):
    """Sequence ``seq`` with its ``BatchRead`` cut to ``planes``, in order:
    what the merge lowers of it (``ops/memory.py::BatchRead.lower_planes``;
    ``used_planes`` still counts the batch's planes)."""
    read = seq.read
    return dataclasses.replace(seq, read=BatchRead(
        ops=tuple(read.ops[z] for z in planes), used_planes=read.used_planes,
        default=read.default))


def _rebase(q: ComposedPlan, shift: int, shared: int, **words) -> Tuple[int, ...]:
    """Plane head ``q.head`` with its block offsets moved: the plane's own
    values (stage values, a warp's coefficients and border, the fused
    chains' scalars; a nested head's above and below stages, second warp
    and FusedRead2's scalars too) by ``shift`` words, the pipeline chain's
    scalars, ``used_planes`` and the default by ``shared``; then ``words``
    set."""
    head = list(q.head)
    for k in range(5 if q.core2 else 3):  # the lower, upper, outer (above, below) lists
        at = k * kp.HEAD_INTS if k < 3 else HEAD_INTS + (k - 3) * kp.HEAD_INTS
        for s in range(head[at + 9]):
            st = at + 12 + 8 * s
            for i in ((4, 5) if head[st] == STAGE_CROP else (6,)):
                head[st + i] += shift
    moved = dict(in_fp_off=q.word("in_fp_off") + shift, out_fp_off=q.word("out_fp_off") + shared)
    if q.core == "warp":
        moved.update(coef_off=q.word("coef_off") + shift, border_off=q.word("border_off") + shift)
    if q.core2:
        moved.update(mid_fp_off=q.word("mid_fp_off") + shift)
    if q.core2 == "warp":
        moved.update(coef2_off=q.word("coef2_off") + shift,
                     border2_off=q.word("border2_off") + shift)
    if q.word("used_off") >= 0:
        moved.update(used_off=q.word("used_off") + shared,
                     default_off=q.word("default_off") + shared)
    return _with_words(tuple(head), **moved, **words)


#: a second level that copies its value: a one-level plane's, or one of a
#: FusedRead2 alone's, beside planes with a second resample (:func:`_lift`)
LIFTS = ("resize", "none")


def _identity_taps(h: int, w: int) -> np.ndarray:
    """The tap tables (``_resample``'s x0 | x1 | y0 | y1 | wx | wy) of a
    resize of an ``h`` x ``w`` image to its own size: each position's first
    tap itself, its second the same, every weight 0, so that under the edge
    rule that keeps the first tap alone the result is that tap's value,
    unchanged (NaN and subnormals too) and the second never loaded."""
    x, y = np.arange(w), np.arange(h)
    return np.concatenate([x, x, y, y, np.zeros(w + h)]).astype(np.int32)


def _lift(q: ComposedPlan, head: Tuple[int, ...], form: str, mid_ops_off: int,
          taps2_off: int) -> Tuple[int, ...]:
    """Plane head ``head`` (``q``'s, rebased) as a nested head of the launch
    ``form`` whose plane has no second resample of its own: with ``form``
    "resize" (a second resample elsewhere in the batch) an identity resize
    (tables ``_identity_taps`` at ``taps2_off``, the edge rule kept,
    ``stage2`` 0: the per-tap form, one core value a pixel) above a
    one-level plane's core or a FusedRead2 alone; with "none" a one-level
    plane's core under an empty FusedRead2 (its table at ``mid_ops_off``).
    The copy reads its value's words as float32 (``mid_type``: an int32
    chain's bits stay bits). ``q``'s own words, which the plain version
    reads, are unchanged."""
    if not q.core2:
        ch, empty = q.word("tap_ch"), _stage_words([], [], 0, 1)[0]
        head = head + _stage_list(0, empty) + _stage_list(0, empty) + tuple(dict(
            core2=CORES.index("none"), core2_h=q.word("core_h"), core2_w=q.word("core_w"),
            mid_h=q.word("core_h"), mid_w=q.word("core_w"), keep_edge2=0, persp2=0, coef2_off=0,
            border2_off=0, taps2_off=0, mid_type=TYPE_CODES[torch.float32], mid_ch=ch,
            mid_n_ops=0, mid_ops_off=mid_ops_off, mid_fp_off=0, stage2=0)[k] for k in _MID_WORDS)
    if form == "none":
        return head
    return _with_words(head, core2=CORES.index("resize"), keep_edge2=1, taps2_off=taps2_off,
                       mid_type=TYPE_CODES[torch.float32], stage2=0)


def build_divergent_plan(seqs, plane_ids, lift: Optional[str] = None, sids=None,
                         out_dtype: Optional[torch.dtype] = None) -> ComposedPlan:
    """The kernel plan of a divergent batch (``launch_divergent_batch``:
    plane ``z`` runs sequence ``plane_ids[z]``) whose every group, sequence
    ``sid`` on its planes, is a ``BatchRead`` that :func:`build_plan` takes
    over those planes, one level or nested: a batch of one geometry or
    mixed, ``crop_batch``, warps of crops, letterboxes, ROI resizes, top
    views resized, rotated downscales. Groups may differ in anything but
    the output (C, H, W): op types, stage kinds, border modes, warp type,
    the levels, the chains and their dtypes, the base's dtype and channels.
    Raises :class:`Unsupported`, naming why.

    The consts hold each plane's head (its group's plan for that plane,
    ``batch`` ``DIVERGENT``, every block offset absolute and
    ``plane_stride`` 0; ``NESTED_INTS`` words a plane where any group is
    nested, each nested plane with its own ``stage2``, the others lifted to
    a second level that copies their value, :func:`_lift`), then each
    plane's store row, then each group's two op tables (and its FusedRead2
    table, empty for a one-level group), then each plane's tap tables (its
    core's, then its second level's). The block holds the planes' source
    addresses, then each group's values in its own plan's layout, group by
    group. The batch takes plane 0's group's dtype and the first sequence's
    write layout; a ragged group holds its default past its
    ``used_planes`` (counted over the batch's planes). ``lift`` ("resize"
    or "none", ``LIFTS``) makes every head a nested one with that second
    level where the batch has no second resample (a one-level batch run
    through the nested instances, to price what a plane pays there).

    With ``sids`` (sequence ids) the plan of those groups alone, the
    composed part of a split batch (``cuda_divergent_split``): every other
    plane's head and store row are zeros (``for_plane`` gives None there)
    and its source address 0; ``out_dtype``, where given, is the batch's
    dtype, into which each group's store row casts."""
    n = len(plane_ids)
    if not 1 <= n <= _MAX_PLANES:
        raise Unsupported(f"{n} planes")
    layout = kbr._LAYOUTS.get(type(seqs[0].write))
    if layout is None:
        raise Unsupported(f"write {type(seqs[0].write).__name__} of a batch")
    groups = []
    for sid, planes in groups_of(plane_ids).items():
        if sids is not None and sid not in sids:
            continue
        seq = seqs[sid - 1]
        if not isinstance(seq.read, BatchRead):
            raise Unsupported(
                f"sequence {sid} reads a {type(seq.read).__name__}, not a BatchRead of read "
                "trees: a ring, a batched image stack and resize_batch are the divergent "
                "kernel's (beside composed groups, the split kernel's)")
        if len(seq.read.ops) != n:
            raise Unsupported(f"sequence {sid} reads {len(seq.read.ops)} planes for {n}")
        pipe = _group_pipeline(seq, planes)
        try:
            gplan = build_plan(pipe)
        except Unsupported as e:
            raise Unsupported(f"sequence {sid}: {e}") from e
        # each plane's own plan, its words from the group's block word
        # 2 * len(planes) on (a mixed group's plan has its heads in its tables)
        t = _tree(pipe)
        own = ([_plane_plan(t, p, pipe) for p in t.planes] if gplan.planes
               else [gplan] * len(planes))
        groups.append((sid, tuple(planes), own[0], own))
    first = groups[0][2]
    batch_dtype = first.out_dtype if out_dtype is None else out_dtype
    for sid, _, gplan, _ in groups[1:]:
        if (gplan.dsize, gplan.out_ch) != (first.dsize, first.out_ch):
            raise Unsupported(
                f"sequence {sid} gives planes of {gplan.out_ch} channel(s) of {gplan.dsize.width}x"
                f"{gplan.dsize.height}, sequence {groups[0][0]} of {first.out_ch} of "
                f"{first.dsize.width}x{first.dsize.height}: the planes must stack")
        if gplan.base != first.base:
            raise Unsupported(f"sequences {groups[0][0]} and {sid} read an {first.base} and an "
                              f"{gplan.base} base: NV12 planes run their own instance")
        if first.base == "yuv" and store_cast(gplan.out_dtype, first.out_dtype):
            raise Unsupported(f"sequences {groups[0][0]} and {sid}: NV12 groups whose chains end "
                              f"in {first.out_dtype} and {gplan.out_dtype} (the NV12 instances "
                              "store every plane with the launch's one store row)")
        if (gplan.core == "none") != (first.core == "none"):
            raise Unsupported(f"sequences {groups[0][0]} and {sid}: a resampling group beside a "
                              "one-pixel group (the kernel's instances take 4 taps a pixel or 1)")
    converting = {(q.conv, q.head[11]) for _, _, q, _ in groups if q.base == "yuv" or q.head[10]}
    if len(converting) > 1:
        raise Unsupported("groups convert YUV -> RGB with different coefficients or ranges: the "
                          "launch takes one conversion")
    if lift is not None and lift not in LIFTS:
        raise ValueError(f"lift {lift!r}: one of {LIFTS}")
    # the launch's second level: a second resample where any plane has one
    # (the others copy their value through an identity resize), else a
    # FusedRead2 alone; none where no group is nested and nothing is lifted
    seconds = [q.core2 for _, _, _, own in groups for q in own]
    if any(c in ("resize", "warp") for c in seconds) or lift == "resize":
        form = "resize"
    elif any(seconds) or lift == "none":
        form = "none"
    else:
        form = ""
    if form and first.core == "none":
        raise Unsupported("one-pixel groups lifted: the nested instances sample a resampling "
                          "core")
    width = NESTED_INTS if form else HEAD_INTS

    heads: List = [None] * n
    plans: List = [None] * n
    at = n * width + n  # the heads, then the store rows
    tables = [np.zeros(at, np.int32)]
    ops_at = []
    for _, _, gplan, _ in groups:  # each group's op tables (and FusedRead2's)
        ops_at.append(at)
        ops = [gplan.tables[:gplan.word("taps_off")]]
        if gplan.core2:
            ops.append(gplan.tables[gplan.word("mid_ops_off"):gplan.word("taps2_off")])
        elif form:
            ops.append(_table(np.zeros((0, 4), np.int32), gplan.word("tap_ch")))
        tables += ops
        at += sum(o.size for o in ops)
    pos = 2 * n  # the block: the planes' source addresses, then each group's values
    out = []
    for (sid, planes, gplan, own), ops_off in zip(groups, ops_at):
        out.append(DivergentGroup(sid=sid, planes=planes, plan=gplan,
                                  store=store_cast(gplan.out_dtype, batch_dtype)))
        shared = pos - 2 * len(planes)  # from the group's own block to the batch's
        mid_ops_off = ops_off + gplan.word("taps_off")
        for j, (z, q) in enumerate(zip(planes, own)):
            words = dict(batch=DIVERGENT, plane_stride=0, in_ops_off=ops_off,
                         out_ops_off=ops_off + q.word("out_ops_off"), taps_off=at)
            if q.core2:
                taps = q.tables[q.word("taps_off"):q.word("mid_ops_off")]
                taps2 = q.tables[q.word("taps2_off"):]
                words.update(mid_ops_off=mid_ops_off, taps2_off=at + taps.size)
            else:
                taps, taps2 = q.tables[q.word("taps_off"):], np.zeros(0, np.int32)
            head = _rebase(q, shared + j * q.word("plane_stride"), shared, **words)
            # a plane without the launch's second level carries one that copies
            if form and not q.core2 or form == "resize" and q.core2 == "none":
                if form == "resize":  # the identity over the core's output or FusedRead2's
                    size = (("mid_h", "mid_w") if q.core2 else ("core_h", "core_w"))
                    taps2 = _identity_taps(*map(q.word, size))
                head = _lift(q, head, form, mid_ops_off, at + taps.size)
            heads[z] = head
            plans[z] = q
            tables += [taps, taps2]
            at += taps.size + taps2.size
        pos += gplan.n_block - 4 - 2 * len(planes)
    consts = np.concatenate(tables).astype(np.int32)
    planes_ = tuple(None if q is None else
                    dataclasses.replace(q, head=hd, tables=consts, device_consts={})
                    for q, hd in zip(plans, heads))
    conv = next(iter(converting))[0] if converting else first.conv
    core2 = next((c for c in seconds if c in ("resize", "warp")), form)
    plan = dataclasses.replace(planes_[groups[0][1][0]], n_planes=n, layout=layout, conv=conv,
                               n_block=pos + 4, core2=core2, out_dtype=batch_dtype,
                               planes=planes_, groups=tuple(out), device_consts={})
    empty = (0,) * width  # a plane of the split batch's other part
    consts[:n * width + n] = np.concatenate([
        np.asarray([empty if hd is None else hd for hd in heads], np.int32).reshape(-1),
        plan.stores])
    return plan


def divergent_instance(plan: ComposedPlan) -> str:
    """The kernel instance a divergent plan launches, as the C entries
    (``csrc/composed.cu``, ``composed_nested.cu``) choose it and as a
    profiler names it without namespaces: planes of one kind of source
    (uint8, float32 and int32, NV12, the six others) with one store row run
    that kind's mixed instances, any other batch the general ones
    (``AnyImage``); of one level ``composed_kernel_mixed<Src, taps, 1>``;
    nested ``composed_kernel_nested_mixed<Src, false>`` for a FusedRead2
    alone, ``composed_kernel_nested_mixed_staged<Src>`` where a plane
    stages, else ``composed_kernel_nested_mixed<Src, true>``."""
    def kind(q):
        if q.base == "yuv":
            return "Nv12"
        name = str(q.src_dtype)[6:]
        return {"uint8": "unsigned char", "float32": "float", "int32": "float"}.get(name, "AnyType")

    kinds = {kind(plan.for_plane(z)) for z in range(plan.n_planes)}
    src = kinds.pop() if len(kinds) == 1 and len(set(plan.stores)) == 1 else "AnyImage"
    if not plan.core2:
        return f"composed_kernel_mixed<{src}, {1 if plan.core == 'none' else 4}, 1>"
    if plan.core2 == "none":
        return f"composed_kernel_nested_mixed<{src}, false>"
    if any(plan.for_plane(z).word("stage2") for z in range(plan.n_planes)):
        return f"composed_kernel_nested_mixed_staged<{src}>"
    return f"composed_kernel_nested_mixed<{src}, true>"


def tap_share(taps: np.ndarray, out_h: int, out_w: int, keep: bool) -> float:
    """A resize's distinct taps of each TILE2 tile of its output, summed,
    over the taps its pixels take one by one (a second tap of weight 0
    untaken under the edge rule ``keep``), the product of the two axes':
    the core values a staged block evaluates over those the per-tap form
    evaluates, where nothing above the resize moves its columns. ``taps``
    is ``_resample``'s table: x0 | x1 | y0 | y1 | wx | wy."""
    wts = taps[2 * (out_w + out_h):].view(np.float32)
    share = 1.0
    for n, tile, at, w in ((out_w, TILE2[0], 0, wts[:out_w]),
                           (out_h, TILE2[1], 2 * out_w, wts[out_w:])):
        first, second = taps[at:at + n], taps[at + n:at + 2 * n]
        takes = ~(keep & (w == 0.0))
        distinct = sum(np.unique(np.concatenate([first[i:i + tile], second[i:i + tile][
            takes[i:i + tile]]])).size for i in range(0, n, tile))
        share *= distinct / (n + int(takes.sum()))
    return share


def tap_need(wx, wy, keep: bool):
    """The taps v00, v01, v10, v11 of a resize that a result takes, as bits
    0-3, from its weights (tensors): the first always; under the edge rule
    (``keep``) a weight of 0 takes the first tap alone, so the second
    column's taps drop where ``wx`` is 0 and the second row's where ``wy``
    is (``csrc/frame_resize.cuh::bilerp_values``); the kernel loads no
    other."""
    ux = ~(keep & (wx == 0.0))
    uy = ~(keep & (wy == 0.0))
    return 1 | ux.int() * 2 | uy.int() * 4 | (ux & uy).int() * 8


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

    plan: ComposedPlan
    pipeline: object             # the executor's Pipeline the arguments come from
    srcs: Tuple[torch.Tensor, ...]  # the distinct base arrays, contiguous
    plane_src: Tuple[int, ...]   # per output plane, its array in srcs
    block: torch.Tensor          # int32: addresses, stage values, warp, chain scalars
    consts: torch.Tensor         # int32: the op tables and the tap tables


def _base_leaf(base):
    return base.buffer if isinstance(base, ReadYUV) else base.data


def _put_vector(blk: _Block, v, n: int) -> None:
    """``v`` (one value or ``n``) as ``n`` float32 words."""
    if isinstance(v, torch.Tensor):
        blk.put(v.reshape(-1).to(torch.float32).expand(n), np.float32)
    else:
        blk.put(np.broadcast_to(np.asarray(v, np.float32).reshape(-1), (n,)), np.float32)


def _put_stages(blk: _Block, stages, ch: int) -> None:
    """Each stage's values, in ``_stage_words``' order: a crop's origin, a
    border's value on ``ch`` channels."""
    for st in stages:
        if isinstance(st, CropRead):
            blk.put(st.x, np.int32, width=1)
            blk.put(st.y, np.int32, width=1)
        else:
            _put_vector(blk, st.value, ch)


def prepare(pipeline, plan: ComposedPlan, device: torch.device) -> Launch:
    """Gather one call's arguments on ``device``: the base arrays (each read
    in place, one entry however many planes read it), and the block of
    runtime values in ``build_plan``'s layout, in one pinned non-blocking
    copy of its host part (device leaves stay where they are). Nothing here
    waits for the device. A divergent plan takes the batch's sequences in
    place of a pipeline (:func:`_prepare_divergent`)."""
    if plan.groups:
        return _prepare_divergent(pipeline, plan, device)
    t = _tree(pipeline)
    srcs: List[torch.Tensor] = []
    index: Dict[int, int] = {}
    plane_src = [_source(p, srcs, index, device) for p in t.planes]
    blk = _Block()
    if plan.batch:
        blk.put(np.asarray([srcs[k].data_ptr() for k in plane_src], np.uint64).view(np.int32),
                np.int32)
    _put_values(blk, t, plan)
    blk.put(np.zeros(4, np.int32), np.int32)
    if blk.size != plan.n_block:
        raise ValueError(f"the block holds {blk.size} words, the plan {plan.n_block}")
    return Launch(plan=plan, pipeline=pipeline, srcs=tuple(srcs), plane_src=tuple(plane_src),
                  block=blk.to(device), consts=plan.consts(device))


def _source(p: _Plane, srcs: List, index: Dict, device, moved: Optional[Dict] = None) -> int:
    """The index in ``srcs`` of plane ``p``'s base array, appended on
    ``device`` where it is not there yet (one entry however many planes
    read it; ``cuda_divergent.moved_source``)."""
    leaf = _base_leaf(p.base)
    k = index.get(id(leaf))
    if k is None:
        k = index[id(leaf)] = len(srcs)
        srcs.append(moved_source(leaf, device, moved))
    return k


def _put_values(blk: _Block, t: _Tree, plan: ComposedPlan) -> None:
    """Tree ``t``'s runtime values in ``build_plan``'s layout: each plane's,
    then the pipeline chain's scalars, ``used_planes`` and the default."""
    tap_ch = plan.word("tap_ch")
    top_ch = plan.word("mid_ch") if plan.core2 else tap_ch
    for p in t.planes:
        _put_stages(blk, p.outer, top_ch)
        if plan.core2:
            if plan.core2 == "warp":
                blk.put(p.core2.coeffs, np.float32, width=_N_COEFFS)
                _put_vector(blk, p.core2.default, top_ch)
            _put_stages(blk, p.above, top_ch)
            _put_stages(blk, p.below, tap_ch)
            for v in flatten(tuple(p.fused2.chain) if p.fused2 is not None else ())[1]:
                blk.put(v, np.float32)
        if plan.core == "warp":
            blk.put(p.core.coeffs, np.float32, width=_N_COEFFS)
            _put_vector(blk, p.core.default, tap_ch)
        _put_stages(blk, p.upper, tap_ch)
        _put_stages(blk, p.lower, plan.head[3])
        for v in flatten(tuple(p.fused.chain) if p.fused is not None else ())[1]:
            blk.put(v, np.float32)
    for v in flatten(tuple(t.chain))[1]:
        blk.put(v, np.float32)
    if t.used is not None:
        blk.put(t.used, np.int32, width=1)
        _put_vector(blk, t.default, top_ch)


def _group_trees(seqs, plan: ComposedPlan) -> List[_Tree]:
    """Each group's tree: its sequence over its planes alone."""
    return [_tree(_group_pipeline(seqs[g.sid - 1], g.planes)) for g in plan.groups]


def _prepare_divergent(seqs, plan: ComposedPlan, device: torch.device) -> Launch:
    """A divergent batch's arguments (:func:`build_divergent_plan`): each
    plane's base array and address, then each group's values in its own
    plan's layout (a nested group's second level's among them), in one
    block; a plane carried through an identity resize or an empty
    FusedRead2 adds none."""
    srcs, plane_src, blk = divergent_block(seqs, plan, device)
    return Launch(plan=plan, pipeline=tuple(seqs), srcs=tuple(srcs),
                  plane_src=tuple(plane_src), block=blk.to(device), consts=plan.consts(device))


def divergent_block(seqs, plan: ComposedPlan, device: torch.device, moved: Optional[Dict] = None):
    """``(sources, each plane's source index, block)`` of
    :func:`_prepare_divergent`, the block's words still on the host
    (``cuda_divergent._Block``); a plane of a split batch's other part has
    source index -1 and address 0."""
    srcs: List[torch.Tensor] = []
    index: Dict[int, int] = {}
    plane_src = [-1] * plan.n_planes
    trees = _group_trees(seqs, plan)
    for g, t in zip(plan.groups, trees):
        for z, p in zip(g.planes, t.planes):
            plane_src[z] = _source(p, srcs, index, device, moved)
    blk = _Block()
    blk.put(np.asarray([srcs[k].data_ptr() if k >= 0 else 0 for k in plane_src], np.uint64)
            .view(np.int32), np.int32)
    for g, t in zip(plan.groups, trees):
        _put_values(blk, t, g.plan)
    blk.put(np.zeros(4, np.int32), np.int32)
    if blk.size != plan.n_block:
        raise ValueError(f"the block holds {blk.size} words, the plan {plan.n_block}")
    return srcs, plane_src, blk


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _where(mask, a, b):
    """``torch.where`` of any dtype (CUDA has none of uint16: its int16 bits)."""
    if a.dtype == torch.uint16:
        return torch.where(mask, a.view(torch.int16), b.view(torch.int16)).view(torch.uint16)
    return torch.where(mask, a, b)


def _fold(i, n: int, mode: int):
    """``csrc/pointwise.cuh::fold_index`` on a tensor of positions."""
    if mode == _WRAP:
        return torch.remainder(i, n)
    if mode == _REFLECT:  # dcba | abcd | dcba
        t = torch.remainder(i, 2 * n)
        return torch.where(t < n, t, 2 * n - 1 - t)
    if mode == _REFLECT_101:  # dcb | abcd | cba
        if n == 1:
            return torch.zeros_like(i)
        t = torch.remainder(i, 2 * n - 2)
        return torch.where(t < n, t, 2 * n - 2 - t)
    return i.clamp(0, n - 1)  # REPLICATE; CONSTANT inside its source


def _walk(stages, blk, y, x, fill):
    """``csrc/pointwise.cuh::walk_stages`` on tensors of positions: each
    stage maps (y, x) inwards; ``fill`` takes the block offset of the
    value of the first CONSTANT border a position lies outside of."""
    for kind, sh, sw, mode, a, b, c, d in stages:
        if kind == STAGE_CROP:
            starts = []
            for off, length, size in ((a, sw, c), (b, sh, d)):
                s = blk[off]
                starts.append(torch.where(s < 0, s + length, s).clamp(0, length - size))
            x, y = x + starts[0], y + starts[1]
        else:
            j, i = y - a, x - b
            if mode == _CONSTANT:
                out = (j < 0) | (j >= sh) | (i < 0) | (i >= sw)
                fill = torch.where((fill < 0) & out, c, fill)
            x, y = _fold(i, sw, mode), _fold(j, sh, mode)
    return y, x, fill


def _filled(v, fill, fblk, dtype):
    """``v`` with each position whose ``fill`` is set holding the block's
    value there, cast to ``dtype`` (``utils.dtypes.cast``)."""
    ch = torch.arange(v.shape[-1], device=v.device)
    vals = dt.cast(fblk[fill.clamp(min=0)[..., None] + ch], dtype)
    return _where((fill >= 0)[..., None], vals, v)


class _Reader:
    """The plain version's reads of one plane of a launch: a tap's value at
    positions of the core's source, through the upper stages, the lower
    ones, the base and the FusedRead's chain. ``blk`` and ``fblk`` are the
    block shifted by the plane's stride, so the head's offsets of plane 0's
    values read the plane's own. ``touched``, where given, collects each
    read's base positions that a result needs (for :func:`work`)."""

    def __init__(self, a: Launch, srcs, z: int, plane: _Plane, touched=None):
        plan = a.plan.for_plane(z)
        self.plan, self.touched = plan, touched
        shift = z * plan.word("plane_stride")
        self.blk = a.block.long()[shift:]
        self.fblk = a.block.view(torch.float32)[shift:]
        self.src_dtype = dt.canonical_dtype(plan.src_dtype)
        self.p = a.plane_src[z]
        self.src = srcs[self.p]
        dev = self.src.device
        self.fused_chain = () if plane.fused is None else map_leaves(
            tuple(plane.fused.chain), lambda v: as_device_tensor(v, dev))

    def base(self, y, x):
        """The base's values (..., C) at positions (y, x)."""
        if self.plan.base == "image":
            return dt.gather(self.src, lambda s: s[y, x])
        h, iu = self.plan.head[1], self.plan.head[8]
        row = h + torch.div(y, 2, rounding_mode="floor")
        col = 2 * torch.div(x, 2, rounding_mode="floor")
        buf = self.src[..., 0]
        return torch.stack([buf[y, x], buf[row, col + iu], buf[row, col + 1 - iu]], -1)

    def tap(self, y, x, need=None):
        """The inner value at positions (y, x) of the core's source, after
        the FusedRead's chain, in its dtype; ``need`` masks the positions
        whose value a result takes."""
        plan = self.plan
        fill_up = torch.full_like(y, -1)
        y, x, fill_up = _walk(plan.stage_list(1), self.blk, y, x, fill_up)
        fill_lo = torch.full_like(y, -1)
        y, x, fill_lo = _walk(plan.stage_list(0), self.blk, y, x, fill_lo)
        if self.touched is not None:
            read = (fill_lo < 0) & (fill_up < 0)
            if need is not None:
                read = read & need
            y_, x_, read = torch.broadcast_tensors(y, x, read)
            self.touched.append((self.p, y_[read], x_[read]))
        v = _filled(self.base(y, x), fill_lo, self.fblk, self.src_dtype)
        for o in self.fused_chain:
            v = o.apply(v)
        return _filled(v, fill_up, self.fblk, plan.tap_dtype)


def _lerp(a, b, w, keep: bool):
    """``ops/resize.py::sample_frame``'s lerp: with ``keep`` a weight of 0
    takes ``a`` itself."""
    v = dt.lerp(a, b, w)
    return torch.where(w == 0.0, a, v) if keep else v


class _MidReader:
    """The plain version's reads of a nested plane's second level: a tap's
    value at positions of ``Resample2``'s source, through the above stages,
    the below ones, the inner core's float32 output ``values`` (``(core_h,
    core_w, tap_ch)``) and ``FusedRead2``'s chain. ``touched``, where given,
    collects the core's positions that a result needs."""

    def __init__(self, r: _Reader, values, plane: _Plane, touched=None):
        self.plan, self.blk, self.fblk = r.plan, r.blk, r.fblk
        self.values, self.touched = values, touched
        dev = values.device
        self.chain = () if plane.fused2 is None else map_leaves(
            tuple(plane.fused2.chain), lambda v: as_device_tensor(v, dev))

    def tap(self, y, x, need=None):
        """The second level's value at positions (y, x) of Resample2's
        source, after FusedRead2's chain, in its dtype."""
        plan = self.plan
        fill_up = torch.full_like(y, -1)
        y, x, fill_up = _walk(plan.stage_list(3), self.blk, y, x, fill_up)
        fill_lo = torch.full_like(y, -1)
        y, x, fill_lo = _walk(plan.stage_list(4), self.blk, y, x, fill_lo)
        if self.touched is not None:
            read = (fill_lo < 0) & (fill_up < 0)
            if need is not None:
                read = read & need
            y_, x_, read = torch.broadcast_tensors(y, x, read)
            self.touched.append((y_[read], x_[read]))
        v = _filled(self.values[y, x], fill_lo, self.fblk, torch.float32)
        for o in self.chain:
            v = o.apply(v)
        return _filled(v, fill_up, self.fblk, plan.mid_dtype)


def _level_taps(plan: ComposedPlan, fblk, lv: _Level, yc, xc):
    """``(ys, xs, take, wx, wy)``: the taps v00, v01, v10, v11 (stacked
    first) of the resampling node ``lv`` at its output positions (yc, xc),
    which of them a result takes, and the weights (``[..., None]``): a
    resize's from its tap tables, a second tap of weight 0 untaken under
    the edge rule; a warp's from the block's coefficients, a tap outside
    its source untaken (it reads the border)."""
    if lv.core == "resize":
        cw, ch = lv.core_w, lv.core_h
        t = torch.from_numpy(plan.tables[lv.taps_off:]).to(yc.device)
        x0, x1 = t[:cw].long(), t[cw:2 * cw].long()
        y0, y1 = t[2 * cw:2 * cw + ch].long(), t[2 * cw + ch:2 * cw + 2 * ch].long()
        wts = t[2 * (cw + ch):2 * (cw + ch) + cw + ch].view(torch.float32)
        wx, wy = wts[:cw][xc][..., None], wts[cw:][yc][..., None]
        # with keep a weight of 0 takes the first tap alone: the second is
        # not needed (the others' lerp reads it whatever its weight)
        bits = tap_need(wx[..., 0], wy[..., 0], bool(lv.keep))
        # v00, v01, v10, v11: the upper row's taps, then the lower row's
        return (torch.stack([y0[yc], y0[yc], y1[yc], y1[yc]]),
                torch.stack([x0[xc], x1[xc], x0[xc], x1[xc]]),
                torch.stack([(bits >> k & 1).bool() for k in range(4)]), wx, wy)
    # the warp: the coordinates from the block's coefficients, as
    # csrc/warp.cuh::sample_warp recomputes them: the column's and the row's
    # terms as ops/warp.py::decompose_inverse_map computes them on the host
    # (float32 ops that keep a subnormal), their sum a flushed op
    cf = fblk[lv.coef_off:lv.coef_off + _N_COEFFS]
    fx, fy = xc.to(torch.float32), yc.to(torch.float32)

    def term(k):
        return dt.fadd(cf[k] * fx, cf[k + 1] * fy + cf[k + 2])

    sx, sy = term(0), term(3)
    if lv.persp:
        den = term(6)
        den = torch.where(den == 0.0, 1.0, den)
        sx, sy = dt.fdiv(sx, den), dt.fdiv(sy, den)
    x0f, y0f = dt.ffloor(sx), dt.ffloor(sy)
    wx, wy = dt.fsub(sx, x0f)[..., None], dt.fsub(sy, y0f)[..., None]
    ih, iw = lv.in_h, lv.in_w
    vx = ((x0f >= 0) & (x0f < iw), (x0f >= -1) & (x0f < iw - 1))
    vy = ((y0f >= 0) & (y0f < ih), (y0f >= -1) & (y0f < ih - 1))
    ix = (torch.where(vx[0], x0f, 0.0).long(), torch.where(vx[1], x0f + 1, 0.0).long())
    iy = (torch.where(vy[0], y0f, 0.0).long(), torch.where(vy[1], y0f + 1, 0.0).long())
    order = ((0, 0), (0, 1), (1, 0), (1, 1))  # (y tap, x tap) of v00, v01, v10, v11
    return (torch.stack([iy[j] for j, _ in order]), torch.stack([ix[i] for _, i in order]),
            torch.stack([vy[j] & vx[i] for j, i in order]), wx, wy)


def _sample(r, lv: _Level, yc, xc, need):
    """The value of the resampling node ``lv`` at its output positions (yc,
    xc), its taps read through ``r``; ``need`` masks the positions whose
    value the output takes."""
    if lv.core == "none":
        return r.tap(yc, xc, need)
    ys, xs, take, wx, wy = _level_taps(r.plan, r.fblk, lv, yc, xc)
    v = r.tap(ys, xs, take & need).to(torch.float32)
    if lv.core == "resize":
        keep = bool(lv.keep)
        return _lerp(_lerp(v[0], v[1], wx, keep), _lerp(v[2], v[3], wx, keep), wy, keep)
    border = r.fblk[lv.border_off:lv.border_off + lv.ch]
    v = torch.where(take[..., None], v, border)
    return dt.lerp(dt.lerp(v[0], v[1], wx), dt.lerp(v[2], v[3], wx), wy)


def _plane_value(a: Launch, srcs, z: int, p: _Plane, yc, xc, need, touched=None, counts=None):
    """Plane ``z``'s read value at positions (yc, xc) under the outer
    stages: the core's, or for a nested plan the second level's over the
    inner core's output, materialized at the core's size (the same float32
    values the kernel computes at each tap). With ``touched`` it collects
    the base positions the taps a result needs read, and a nested plan's
    count of the core's positions they need into ``counts``."""
    plan = a.plan.for_plane(z)
    if not plan.core2:
        return _sample(_Reader(a, srcs, z, p, touched), plan.level(0), yc, xc, need)
    r = _Reader(a, srcs, z, p)
    lv = plan.level(0)
    dev = yc.device
    yi = torch.arange(lv.core_h, device=dev)[:, None].expand(lv.core_h, lv.core_w)
    xi = torch.arange(lv.core_w, device=dev)[None, :].expand(lv.core_h, lv.core_w)
    every = torch.ones_like(yi, dtype=torch.bool)
    values = _sample(r, lv, yi, xi, every)
    used = None if touched is None else []
    v = _sample(_MidReader(r, values, p, used), plan.level(1), yc, xc, need)
    if touched is not None:
        # the core's positions the second level's taps need, then the base
        # positions their own taps read
        mask = torch.zeros_like(every)
        for y, x in used:
            mask[y, x] = True
        if counts is not None:
            counts.append(int(mask.sum()))
        _sample(_Reader(a, srcs, z, p, touched), lv, yi, xi, mask)
    return v


def _frame_shape(a: Launch, k: int) -> Tuple[int, int]:
    """``(rows, width)`` of the launch's base array ``k``, from the head of
    the first plane that reads it (an NV12 buffer's rows: 3/2 of its
    image's height)."""
    plan = a.plan.for_plane(a.plane_src.index(k))
    h, w = plan.head[1:3]
    return (h if plan.base == "image" else h * 3 // 2), w


def _held(a: Launch, z: int) -> bool:
    """Whether plane ``z`` lies past its ``used_planes`` (a divergent
    batch's: its group's, counted over the batch's planes) and reads
    nothing."""
    off = a.plan.for_plane(z).word("used_off")
    return off >= 0 and z >= int(a.block[off])


def _used(a: Launch) -> int:
    """The planes a launch reads: ``used_planes`` clamped to [0, N] (read
    back from the block), else N."""
    plan = a.plan
    off = plan.word("used_off")
    if off < 0:
        return plan.n_planes
    return min(max(int(a.block[off]), 0), plan.n_planes)


def _reference(a: Launch, touched=None, counts=None, plane_value=None):
    """The plain version; with ``touched`` only the read of the planes
    below ``used_planes``, whose base positions it collects (and a nested
    plan's core positions needed per plane into ``counts``). ``plane_value``
    (``_plane_value``'s arguments but the last two) computes each plane's
    read value in place of ``_plane_value``."""
    plan = a.plan
    t = _tree(a.pipeline)
    dev = a.srcs[0].device
    srcs = _canonical_sources(a)
    w, h = plan.dsize
    y = torch.arange(h, device=dev)[:, None].expand(h, w)
    x = torch.arange(w, device=dev)[None, :].expand(h, w)
    core_dtype = plan.value_dtype
    planes = []
    for z, p in enumerate(t.planes[:_used(a)] if touched is not None else t.planes):
        shift = z * plan.word("plane_stride")
        blk, fblk = a.block.long()[shift:], a.block.view(torch.float32)[shift:]
        yc, xc, fill = _walk(plan.for_plane(z).stage_list(2), blk, y, x, torch.full_like(y, -1))
        if plane_value is None:
            v = _plane_value(a, srcs, z, p, yc, xc, fill < 0, touched, counts)
        else:
            v = plane_value(a, srcs, z, p, yc, xc, fill < 0)
        planes.append(_filled(v, fill, fblk, core_dtype))
    if touched is not None:
        return None
    v = torch.stack(planes) if plan.batch else planes[0]
    if plan.word("used_off") >= 0:
        # the planes from used_planes on hold the default, cast to the read
        # value's dtype (ops/memory.py::BatchRead)
        blk, fblk = a.block.long(), a.block.view(torch.float32)
        off = plan.word("default_off")
        default = dt.cast(fblk[off:off + plan.level(1 if plan.core2 else 0).ch], core_dtype)
        z = torch.arange(plan.n_planes, device=dev).reshape(-1, 1, 1, 1)
        v = _where(z < blk[plan.word("used_off")], v, default)
    for o in map_leaves(tuple(t.chain), lambda v: as_device_tensor(v, dev)):
        v = o.apply(v)
    return a.pipeline.write.write(v)


def _canonical_sources(a: Launch):
    """The launch's base arrays in their canonical dtype, each (rows, width,
    channels)."""
    return [dt.canonicalize(s).reshape(*_frame_shape(a, k), -1) for k, s in enumerate(a.srcs)]


def _divergent_reference(a: Launch, touched=None, counts=None):
    """The plain version of a divergent batch: each group's planes, each
    from its own head, as :func:`_reference` computes a plane (a nested
    plane's second level over its core's output, as its group's own
    launch); a ragged group's planes from its ``used_planes`` on (counted
    over the batch's planes) hold its default cast to the read value's
    dtype; the group's chain; its values cast into the batch's dtype
    (``utils.dtypes.astype``, what its store row computes) and scattered to
    its planes; the first sequence's write. With ``touched`` (a dict) only
    the read of the planes below their group's ``used_planes``, each
    plane's base positions collected under its index, and a nested plane's
    count of the core's positions its second level needs under its index
    in ``counts`` (a dict)."""
    plan = a.plan
    dev = a.srcs[0].device
    srcs = _canonical_sources(a)
    w, h = plan.dsize
    y = torch.arange(h, device=dev)[:, None].expand(h, w)
    x = torch.arange(w, device=dev)[None, :].expand(h, w)
    blk, fblk = a.block.long(), a.block.view(torch.float32)
    merged = None
    for g, t in zip(plan.groups, _group_trees(a.pipeline, plan)):
        values = []
        for z, p in zip(g.planes, t.planes):
            q = plan.for_plane(z)
            found = None
            if touched is not None:
                if _held(a, z):
                    continue
                touched[z], found = [], []
            yc, xc, fill = _walk(q.stage_list(2), blk, y, x, torch.full_like(y, -1))
            v = _plane_value(a, srcs, z, p, yc, xc, fill < 0,
                             None if touched is None else touched[z], found)
            if counts is not None:
                counts[z] = sum(found)
            values.append(_filled(v, fill, fblk, q.value_dtype))
        if touched is not None:
            continue
        v = torch.stack(values)
        if q.word("used_off") >= 0:
            off = q.word("default_off")
            default = dt.cast(fblk[off:off + q.level(1 if q.core2 else 0).ch], q.value_dtype)
            zs = torch.tensor(g.planes, device=dev).reshape(-1, 1, 1, 1)
            v = _where(zs < blk[q.word("used_off")], v, default)
        for o in map_leaves(tuple(t.chain), lambda v: as_device_tensor(v, dev)):
            v = o.apply(v)
        if merged is None:
            merged = torch.zeros((plan.n_planes, *v.shape[1:]), dtype=plan.out_dtype, device=dev)
        idx = torch.tensor(g.planes, device=dev)
        val = dt.astype(v, merged.dtype)
        if merged.dtype == torch.uint16:  # no index_put of uint16: its bits as int16
            merged.view(torch.int16)[idx] = val.view(torch.int16)
        else:
            merged[idx] = val
    if touched is not None:
        return None
    return a.pipeline[0].write.write(merged)


def composed_reference(a: Launch):
    """The plain PyTorch version of the kernel on the launch's sources (in
    their canonical dtype), from the plan's words and the block: the stage
    walks, the tap tables or the recomputed warp coordinates, the lerps with
    ``utils.dtypes``' flush ops, each chain op's own ``apply`` and the
    write op; a divergent batch's plane by plane, each with its own head
    (:func:`_divergent_reference`)."""
    return _divergent_reference(a) if a.plan.groups else _reference(a)


can_store = kbr.can_store


def _alloc_out(plan: ComposedPlan, device, out=None):
    return kp._alloc_out(plan, device, out)


def _check(a: Launch) -> None:
    plan = a.plan
    dev = a.srcs[0].device
    src_dtypes = [plan.for_plane(a.plane_src.index(k)).src_dtype for k in range(len(a.srcs))]
    for name, t, dtype in (("block", a.block, torch.int32), ("consts", a.consts, torch.int32),
                           *(("src", s, d) for s, d in zip(a.srcs, src_dtypes))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the source on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if len(plan.head) != (NESTED_INTS if plan.core2 else HEAD_INTS):
        raise ValueError("the plan's head does not match its kind")
    if a.block.numel() != plan.n_block or a.consts.numel() != plan.tables.size:
        raise ValueError("parameter block or tables do not match the plan")
    if plan.planes:
        if any(a.srcs[k].numel() != plan.for_plane(z).src_numel
               for z, k in enumerate(a.plane_src) if k >= 0):
            raise ValueError("a source does not match its plane's plan")
    elif any(s.numel() != plan.src_numel for s in a.srcs):
        raise ValueError("a source does not match the plan")
    if plan.batch and a.block.data_ptr() % 8:
        raise ValueError("the block's source addresses are not 8-byte aligned")


def composed(a: Launch, out: Optional[torch.Tensor] = None):
    """The kernel wrapper: launches on a CUDA tensor, runs the plain version
    on a CPU tensor, raises on anything else. It never falls back. With
    ``out`` (a view of the write's shape, any strides) the result is stored
    there, cast as ``utils.dtypes.astype`` casts, and ``out`` is returned."""
    global LAUNCHES
    dev = a.srcs[0].device
    if a.plan.groups and out is not None:
        raise ValueError("a divergent batch's store rows are for its own batch: no out=")
    if dev.type == "cpu":
        result = composed_reference(a)
        return result if out is None else kbr.reference_into(result, out, dev)
    if dev.type != "cuda":
        raise ValueError(f"composed runs on CUDA or CPU tensors, not {dev}")
    _check(a)
    lib = _build.load()
    plan = a.plan
    kbr.check_out_dtype("composed", plan, out)
    buf, (sn, sc, sy, sx), result = _alloc_out(plan, dev, out)
    w, h = plan.dsize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.cvgs_composed_nested if plan.core2 else lib.cvgs_composed
        err = entry(
            a.srcs[0].data_ptr(), plan.head_words(), *plan.conv, a.block.data_ptr(),
            a.consts.data_ptr(), plan.n_planes, w, h, buf.data_ptr(), TYPE_CODES[buf.dtype],
            plan.out_ch, store_cast(plan.out_dtype, buf.dtype), sn, sc, sy, sx, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"composed launch failed: CUDA error {err} ({lib.cvgs_error_string(err).decode()})"
        )
    LAUNCHES += 1
    _build.after_launch("composed", dev)
    return result


def run(pipeline, plan: ComposedPlan, device: torch.device, out=None):
    """One call of the kernel path: gather the arguments, launch. A
    divergent plan takes the batch's sequences as ``pipeline``."""
    return composed(prepare(pipeline, plan, device), out)


#: the wrapper, under the name every kernel module gives it
launch = composed


def _walk_axis(stages, blk, pos, axis: int):
    """``csrc/composed.cuh::walk_axis`` on a tensor of positions of one axis
    (0: y, 1: x): the positions inwards, and whether each lies outside a
    CONSTANT border on this axis (a tap there reads nothing)."""
    out = torch.zeros(pos.shape, dtype=torch.bool)
    for kind, sh, sw, mode, a, b, c, d in stages:
        if kind == STAGE_CROP:
            off, length, size = (b, sh, d) if axis == 0 else (a, sw, c)
            s = int(blk[off])
            pos = pos + min(max(s + length if s < 0 else s, 0), length - size)
        else:
            n, lead = (sh, a) if axis == 0 else (sw, b)
            j = pos - lead
            if mode == _CONSTANT:
                out |= (j < 0) | (j >= n)
            pos = _fold(j, n, mode)
    return pos, out


def _axis_reads(a: Launch, z: int, axis: int) -> np.ndarray:
    """The base positions one axis of a resize or one-pixel core reads for
    plane ``z``: the output positions through the outer stages, less those
    an outer CONSTANT border fills; for a nested plan, the second level's
    resize taps at them (``bounds.axis_reads``), through the above and the
    below stages, less those a CONSTANT border there fills; the core's
    resize taps at them; then through the upper and the lower stages, less
    those a CONSTANT border there fills. A tap is read where both its row
    and its column are, so the two axes' positions pair up."""
    plan = a.plan.for_plane(z)
    blk = a.block.long().cpu()[z * plan.word("plane_stride"):]
    pos, out = _walk_axis(plan.stage_list(2), blk, torch.arange(plan.dsize[1 - axis]), axis)
    pos = np.unique(pos[~out].numpy())
    levels = ((plan.level(1), (3, 4)),) if plan.core2 else ()
    for lv, lists in levels + ((plan.level(0), (1, 0)),):
        if lv.core == "resize":
            t = plan.tables[lv.taps_off:]
            cw, ch = lv.core_w, lv.core_h
            i0, i1 = ((t[:cw], t[cw:2 * cw]) if axis
                      else (t[2 * cw:2 * cw + ch], t[2 * cw + ch:2 * (cw + ch)]))
            wts = t[2 * (cw + ch):].view(np.float32)
            w = wts[:cw] if axis else wts[cw:cw + ch]
            pos = bounds.axis_reads(i0[pos], i1[pos], w[pos], bool(lv.keep))
        pos = torch.from_numpy(pos)
        out = torch.zeros(pos.shape, dtype=torch.bool)
        for k in lists:  # the stages above a fused read, then those below it
            pos, o = _walk_axis(plan.stage_list(k), blk, pos, axis)
            out |= o
        pos = np.unique(pos[~out].numpy())
    return pos


def _read_sectors(a: Launch) -> int:
    """The 32-byte sectors of the base arrays that a resize or one-pixel
    core's taps read (a nested plan's: under a resize or one-pixel second
    level), from the plan's tables and the block: each plane's
    rows and columns (:func:`_axis_reads`) in every pairing, for the planes
    below ``used_planes`` (the others read nothing); a sector of an array
    that several planes read counts once; an NV12 tap reads a luma byte and
    a chroma pair."""
    found = [f for z in range(_used(a)) for f in _grid_sectors(a, z)]
    return int(np.unique(np.concatenate(found)).size) * 32 if found else 0


def _elem(a: Launch, k: int) -> Tuple[int, ComposedPlan]:
    """The bytes of a tap of the launch's base array ``k`` (an NV12 tap's
    luma byte: 1) and the plan of the first plane that reads it."""
    plan = a.plan.for_plane(a.plane_src.index(k))
    return (plan.head[3] * a.srcs[k].element_size() if plan.base == "image" else 1), plan


def _grid_sectors(a: Launch, z: int) -> List[np.ndarray]:
    """The sectors plane ``z``'s resize or one-pixel taps read: its rows and
    columns (:func:`_axis_reads`) in every pairing, an NV12 tap's chroma
    pair too; each base array's bytes apart from the others'."""
    elem, plan = _elem(a, a.plane_src[z])
    h, w = plan.head[1:3]
    rows, cols = _axis_reads(a, z, 0), _axis_reads(a, z, 1)
    array = a.plane_src[z] * 2**45
    found = [bounds.grid_sectors(array + rows * w * elem, cols * elem, elem)]
    if plan.base == "yuv":
        found.append(bounds.grid_sectors(array + (h + np.unique(rows // 2)) * w,
                                         np.unique(cols // 2) * 2, 2))
    return found


def _touched_sectors(a: Launch, touched) -> List[torch.Tensor]:
    """The sectors of the base positions ``touched`` (``(array, y, x)``
    entries the plain version collects), an NV12 tap's chroma pair too."""
    found = []
    for k, y, x in touched:
        elem, plan = _elem(a, k)
        h, w = plan.head[1:3]
        array = k * 2**45
        y, x = y.cpu(), x.cpu()
        found.append(bounds.sectors(array + (y * w + x) * elem, elem))
        if plan.base == "yuv":
            chroma = (h + torch.div(y, 2, rounding_mode="floor")) * w + 2 * torch.div(
                x, 2, rounding_mode="floor")
            found.append(bounds.sectors(array + chroma, 2))
    return found


def work(a: Launch) -> Tuple[int, int, int]:
    """``(output bytes, source bytes touched, float32 operations)`` of one
    launch (``utils.bounds``): the output; the 32-byte sectors of the base
    arrays that the taps read: for resize and one-pixel levels from the
    plan's tap tables, weights and stages (:func:`_read_sectors`), where a
    level is a warp from the plain version's own positions (a tap of a
    CONSTANT border, outside a warp's source or under an outer border's
    fill reads none, nor a resize's second tap of weight 0 under the edge
    rule that keeps the first tap alone, nor an inner tap under a second
    level's tap that reads none; an NV12 tap reads a luma byte and a chroma
    pair; a plane past ``used_planes`` none); per output value of a plane
    read the resample's lerps (12; a warp 8 more for its coordinates) and
    the FusedRead's rows once per tap (an NV12 conversion 7 more); for a
    nested plan those once per value of the core that the second level's
    taps need (:func:`_core_evals`: the least work computes each once) with
    FusedRead2's rows, and the second level's lerps per output value read;
    per output value the pipeline's rows. A divergent batch's
    (:func:`_divergent_work`) sums its planes, each as its group's."""
    plan = a.plan
    if plan.groups:
        return _divergent_work(a)
    out_bytes, values = bounds.output(plan)
    if "warp" in (plan.core, plan.core2):
        src = _walked_sectors(a)
    else:
        src = _read_sectors(a)
    core = _core_ops(plan)
    read = values // plan.n_planes * _used(a)
    out_n = plan.word("out_n_ops")
    if plan.core2:
        per_core = plan.word("tap_ch") * (core + plan.word("mid_n_ops"))
        return (out_bytes, src,
                _core_evals(a) * per_core + read * _LERPS[plan.core2] + values * out_n)
    return out_bytes, src, read * max(core + out_n, 1) + (values - read) * out_n


#: float32 operations of a resampling node per output value: a resize's
#: three lerps, a warp's and its coordinates
_LERPS = {"none": 0, "resize": 12, "warp": 20}


def _core_ops(plan: ComposedPlan) -> int:
    """A plane's float32 operations per output value of its core: the
    resample's lerps and the fused read's rows once per tap (an NV12
    conversion 7 more)."""
    return _LERPS[plan.core] + (1 if plan.core == "none" else 4) * (
        plan.word("in_n_ops") + 7 * plan.head[10])


def _divergent_work(a: Launch) -> Tuple[int, int, int]:
    """:func:`work` of a divergent batch: the output; the sectors the taps
    of each plane read (a plane past its group's ``used_planes`` none; a
    resize or one-pixel core's from its tables, :func:`_axis_reads`; a
    warp's from the plain version's own positions), a sector that several
    planes read once; each plane's operations as its group's plan counts
    them: a nested plane's core once per value its second level needs
    (:func:`_core_evals`' count, per plane), whatever second level the
    launch carries a plane without one through."""
    plan = a.plan
    out_bytes, values = bounds.output(plan)
    per_plane = values // plan.n_planes
    touched: dict = {}
    counts: dict = {}
    _divergent_reference(a, touched, counts)
    found, ops = [], 0
    mine = [z for g in plan.groups for z in g.planes]  # a split batch's part: its own planes
    for z in mine:
        q = plan.for_plane(z)
        out_n = q.word("out_n_ops")
        if z not in touched:  # past its group's used_planes
            ops += per_plane * out_n
        elif q.core2:
            ops += (counts[z] * q.word("tap_ch") * (_core_ops(q) + q.word("mid_n_ops"))
                    + per_plane * (_LERPS[q.core2] + out_n))
        else:
            ops += per_plane * max(_core_ops(q) + out_n, 1)
        if z in touched:
            found += (_touched_sectors(a, touched[z]) if "warp" in (q.core, q.core2)
                      else _grid_sectors(a, z))
    src = int(np.unique(np.concatenate([np.asarray(f) for f in found])).size) * 32 if found else 0
    return out_bytes // plan.n_planes * len(mine), src, ops


def _core_evals(a: Launch) -> int:
    """The positions of a nested launch's core output that the second
    level's taps of its results need, summed over the planes read (from
    the plain version's own walk: a tap under a CONSTANT border or outside
    a warp's source needs none)."""
    counts: list = []
    _reference(a, [], counts)
    return sum(counts)


def _walked_sectors(a: Launch) -> int:
    """The sectors the taps of a launch read, from the plain version's own
    positions (``_reference`` collecting them): a warp core's count."""
    touched: list = []
    _reference(a, touched)
    found = _touched_sectors(a, touched)
    return int(torch.unique(torch.cat(found)).numel()) * 32 if found else 0


# ---------------------------------------------------------------------------
# the nested instances' blocks, as csrc/composed_nested.cuh chooses their form
# ---------------------------------------------------------------------------


def second_taps(a: Launch, z: int):
    """``(ys, xs, take)``, each ``(4, H, W)``: the taps v00, v01, v10, v11
    of a nested launch's second resample at each output pixel of plane
    ``z`` (positions in the middle image) and those its result takes, none
    where an outer CONSTANT border fills the pixel: what a thread of the
    kernel takes from its block's grid."""
    plan = a.plan.for_plane(z)
    shift = z * plan.word("plane_stride")
    blk, fblk = a.block.long()[shift:], a.block.view(torch.float32)[shift:]
    w, h = plan.dsize
    dev = a.block.device
    y = torch.arange(h, device=dev)[:, None].expand(h, w)
    x = torch.arange(w, device=dev)[None, :].expand(h, w)
    yc, xc, fill = _walk(plan.stage_list(2), blk, y, x, torch.full_like(y, -1))
    ys, xs, take, _, _ = _level_taps(plan, fblk, plan.level(1), yc, xc)
    return ys, xs, take & (fill < 0)


def resize_axis_taps(a: Launch, z: int, axis: int):
    """``(first, second, keep)``, each ``(n,)``: for each output column
    (``axis`` 1) or row (0) of plane ``z`` of a nested launch whose second
    level is a resize, its first and second tap in the middle image and
    whether the edge rule keeps the second (a weight of 0 drops it): the
    column walked through the outer stages alone, whether or not an outer
    CONSTANT border fills its pixels, as a warp of the kernel lists a
    tile's taps (``csrc/composed_nested.cuh::resize_axis``)."""
    plan = a.plan.for_plane(z)
    lv = plan.level(1)
    blk = a.block.long().cpu()[z * plan.word("plane_stride"):]
    pos, _ = _walk_axis(plan.stage_list(2), blk, torch.arange(plan.dsize[1 - axis]), axis)
    t = plan.tables[lv.taps_off:]
    cw, ch = lv.core_w, lv.core_h
    first, second = (t[:cw], t[cw:2 * cw]) if axis else (t[2 * cw:2 * cw + ch],
                                                          t[2 * cw + ch:2 * (cw + ch)])
    wts = t[2 * (cw + ch):].view(np.float32)
    weight = (wts[:cw] if axis else wts[cw:cw + ch])[pos.numpy()]
    pos = pos.numpy()
    return first[pos], second[pos], ~(bool(lv.keep) & (weight == 0.0))


def _tiles(t, fill, tile=TILE2):
    """``(k, H, W)`` -> ``(BH, BW, k * th * tw)``: each block's values of
    its ``tile`` (tw, th) of outputs, ``fill`` past the output's edge."""
    tw, th = tile
    k, h, w = t.shape
    bh, bw = -(-h // th), -(-w // tw)
    padded = torch.full((k, bh * th, bw * tw), fill, dtype=t.dtype, device=t.device)
    padded[:, :h, :w] = t
    return padded.reshape(k, bh, th, bw, tw).permute(1, 3, 0, 2, 4).reshape(bh, bw, -1)


def _distinct(v, take):
    """Per block (the last axis): the positions ``v`` it takes, their
    count of distinct values and their span (0 for none)."""
    big = torch.iinfo(torch.int64).max
    s = torch.where(take, v, big).sort(-1).values
    n = (s[..., :1] != big).sum(-1) + ((s[..., 1:] != s[..., :-1]) & (s[..., 1:] != big)).sum(-1)
    lo = s[..., 0]
    hi = torch.where(take, v, -1).amax(-1)
    return n, torch.where(n > 0, hi - lo + 1, 0)


def nested_tiles(a: Launch) -> np.ndarray:
    """The form each block of a nested launch with a second resample takes,
    as ``csrc/composed_nested.cuh`` chooses it (its host mirror):
    ``(planes, BH, BW, 3)`` int64 of the form's index in ``TILE_FORMS``,
    the rows and the columns listed. A block of TILE2 outputs stages its
    footprint ("staged") where its plane's ``stage2`` word is 1 (a warp; a
    resize whose tiles share taps, :func:`tap_share`; a mixed-geometry
    batch's planes each choose their own), each axis's list holds at most
    LIST2 positions and their grid at most GRID2 floats of ``mid_ch``
    lanes: under a resize the distinct taps of the tile's columns (rows)
    inside the output (:func:`resize_axis_taps`), spanning at most SPAN2;
    under a warp the box of the taps its pixels take (:func:`second_taps`);
    else it evaluates the core at each tap ("per_tap", its lists 0); a
    plane past ``used_planes`` is "held". A divergent batch's planes each
    as their group's; a plane with no second resample of its own (carried
    through an identity resize) "per_tap"."""
    plan = a.plan
    if plan.core2 not in ("resize", "warp"):
        raise ValueError("no second resample: the kernel's blocks take one form")
    w, h = plan.dsize
    tw, th = TILE2
    shape = (-(-h // th), -(-w // tw))
    planes = []
    for z in range(plan.n_planes):
        q = plan.for_plane(z)
        stage, ch = q.word("stage2"), q.word("mid_ch")
        out = torch.zeros((*shape, 3), dtype=torch.int64)
        if _held(a, z):
            out[..., 0] = TILE_FORMS.index("held")
            planes.append(out)
            continue
        if q.core2 not in ("resize", "warp"):
            out[..., 0] = TILE_FORMS.index("per_tap")
            planes.append(out)
            continue
        if q.core2 == "resize":
            lists = []
            for axis, tile in ((0, (1, th)), (1, (tw, 1))):
                first, second, keep = (torch.from_numpy(np.asarray(v)).reshape(
                    (-1, 1) if axis == 0 else (1, -1)) for v in resize_axis_taps(a, z, axis))
                both = torch.stack([first, second]).long()
                taken = torch.stack([torch.ones_like(keep), keep])
                n, span = _distinct(_tiles(both, 0, tile), _tiles(taken, False, tile))
                lists.append((n, span))
            (ny, span_y), (nx, span_x) = lists
            fits = (span_y <= SPAN2) & (ny <= LIST2) & (span_x <= SPAN2) & (nx <= LIST2)
        else:
            ys, xs, take = (t.cpu() for t in second_taps(a, z))
            take = _tiles(take, False)
            _, ny = _distinct(_tiles(ys, 0), take)
            _, nx = _distinct(_tiles(xs, 0), take)
            fits = (ny <= LIST2) & (nx <= LIST2)
        ny, nx = torch.broadcast_tensors(ny, nx)
        fits = fits & (nx * ny * ch <= GRID2) & bool(stage)
        out[..., 0] = torch.where(fits, TILE_FORMS.index("staged"), TILE_FORMS.index("per_tap"))
        out[..., 1] = torch.where(fits, ny, 0)
        out[..., 2] = torch.where(fits, nx, 0)
        planes.append(out)
    return torch.stack(planes).numpy()
