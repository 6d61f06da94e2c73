"""The split divergent kernel: plan, plain version, wrapper.

A divergent batch (``executor.launch_divergent_batch``: sequence
``plane_ids[z]`` on plane ``z``) whose groups neither the divergent kernel
(``cuda_divergent``, K6) nor the composed kernel's divergent plan
(``cuda_composed.build_divergent_plan``) takes alone, but which they take
between them: a ring, a batched image stack or ``resize_batch`` beside
letterboxes, ROI resizes, warps of crops or top views; K6's NV12 groups
beside image groups. The reference runs such a batch as one jitted program
(``cvgpuspeedup_tpu/exec/executor.py:366-380``); its model, FKL's
``launchDivergentBatchTransformDPP_Kernel``, runs separate kernel programs
per plane group within one launch (``SURVEY.md``, F9). So does this route
(``cuda:divergent:split``): one launch of ``csrc/divergent_split*.cu``, a
1-D grid of each part's blocks at the part's own tiling
(:meth:`SplitPlan.tiles`), whose every block runs, uniformly, K6's body on
a plane of K6's part or the composed kernel's on a plane of the other.

The partition (:func:`partition`, once per structure and plane ids): a
group goes to *K6's part* where K6 reads it (``cuda_divergent._classify``)
and either the composed plan cannot take it alone (a ring, a batched image
stack, ``resize_batch`` of a frame or of a stack) or it reads NV12 (the
general composed instances read no NV12 buffer); every other group goes to
*the composed part*, whose groups meet ``build_divergent_plan``'s rules
among themselves (one output (C, H, W), all resampling or all one-pixel,
one YUV conversion) and run, one level or nested, the uint8 body where
every group of the part reads uint8 images with one store row
(:attr:`SplitPlan.kind`), else the general ``AnyImage`` body, which reads
each plane's store row.

Each part keeps its own layout over the batch's planes (:func:`build_split_plan`):

- K6's part is ``cuda_divergent.build_plan`` of its groups: its table marks
  a plane of the other part ``cuda_divergent.FOREIGN`` (-1), which is the
  part table the kernel reads; its descriptors, source addresses and
  values are laid out as ``cuda_divergent.prepare`` lays them out;
- the composed part is ``build_divergent_plan`` of its groups: each of its
  planes' head and store row in the consts at the plane's index, zeros at
  a plane of K6's part, its block's source address 0.

A plane is the batch's plane in both: a ring's plane is ``first + z`` of the
batch's ``z``, a ragged group's ``used_planes`` counts the batch's planes,
and both parts cast into the batch's dtype, plane 0's group's, whichever
part that group is in (each group's store row); the first sequence's write
layout. The parameter block is K6's part's block, then the composed part's
(at ``Launch.cm_off``, a multiple of 16 bytes), gathered on the host and
moved in one pinned non-blocking copy: new ``first`` s, rects, matrices,
origins, ``used_planes`` and frames build no plan. The consts are K6's part's,
then the plane lists (:attr:`SplitPlan.lists`: K6's planes in order, then
the composed part's, padded to 16 bytes), then the composed part's (at
``SplitPlan.cm_consts_off``).

:func:`split_reference`, the plain version, is the eager merge
(``cuda_divergent.merge``) on the launch's device: it reads neither the
block nor the tables, so holding the kernel against it checks them.
:func:`divergent_split` launches on a CUDA tensor and runs the plain
version on a CPU tensor; it never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..graph import map_leaves
from ..ops.memory import BatchRead
from ..utils.dtypes import as_device_tensor
from . import _build
from . import cuda_batch_resize as kbr
from . import cuda_composed as kc
from . import cuda_divergent as kd
from .cuda_batch_resize import TYPE_CODES, Unsupported
from .cuda_divergent import FOREIGN, groups_of

__all__ = ["Unsupported", "partition", "build_split_plan", "prepare", "split_reference",
           "divergent_split", "run", "work", "instance", "PartTiles", "LAUNCHES"]

#: launches of the CUDA kernel in this process
LAUNCHES = 0

#: the composed part's instance forms (csrc/divergent_split.cuh): a
#: one-pixel read, a resample, nested with a FusedRead2 alone, a second
#: resample per tap, staged where any plane's stage2 asks for it
FORMS = ("one_pixel", "resample", "fused2", "per_tap", "staged")
#: the composed part's source kinds: uint8 images with one store row, any
#: other (csrc/divergent_split.cuh), and each as a profiler names the
#: instance's template argument
KINDS = {"uint8": "unsigned char", "any": "AnyImage"}
#: a tile of K6's part, and of the composed part but with a second
#: resample: ``csrc/chain.cuh::group_block``'s 64 x 4 threads at one pixel a
#: thread
GROUP = (64, 4)


@dataclasses.dataclass(frozen=True)
class PartTiles:
    """One part's blocks in the launch (``csrc/divergent_split.cuh::
    SplitPart``): its planes, whose ids start at word ``list`` of the plane
    lists, each cut into ``tiles`` tiles, ``tiles_x`` across, of ``bw`` x
    ``bh`` threads, one pixel a thread."""

    planes: int
    tiles_x: int
    tiles: int
    bw: int
    bh: int
    list: int

    @property
    def blocks(self) -> int:
        return self.planes * self.tiles


def _part_tiles(planes: int, w: int, h: int, block: Tuple[int, int], at: int) -> PartTiles:
    tiles_x = -(-w // block[0])
    return PartTiles(planes, tiles_x, tiles_x * -(-h // block[1]), *block, at)


def partition(seqs, plane_ids) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(K6's part, the composed part)``: the sequence ids of each, in
    order of first appearance. A group is K6's where K6 reads it and it is
    no ``BatchRead`` (a ring, an image stack, ``resize_batch``) or a
    ``BatchRead`` of NV12 reads; every other group is the composed part's."""
    n = len(plane_ids)
    k6, composed = [], []
    for sid in groups_of(plane_ids):
        seq = seqs[sid - 1]
        try:
            kind = kd._classify(seq, n)[0]
        except Unsupported:
            kind = None
        if kind is not None and (not isinstance(seq.read, BatchRead) or kind == "nv12"):
            k6.append(sid)
        else:
            composed.append(sid)
    return tuple(k6), tuple(composed)


def _refuse_group(seqs, plane_ids, sid: int) -> None:
    """Raise where no part takes the composed part's group ``sid``: neither
    kernel reads it, or it reads NV12 that K6 refuses."""
    n = len(plane_ids)
    seq = seqs[sid - 1]
    try:
        kd._classify(seq, n)
        k6_why = "a BatchRead the composed part takes"
    except Unsupported as e:
        k6_why = str(e)
    if not isinstance(seq.read, BatchRead):
        raise Unsupported(f"sequence {sid}: neither part takes it (the divergent kernel: "
                          f"{k6_why}; the composed kernel: a {type(seq.read).__name__}, no "
                          "BatchRead of read trees)")
    planes = groups_of(plane_ids)[sid]
    try:
        gplan = kc.build_plan(kc._group_pipeline(seq, planes))
    except Unsupported as e:
        raise Unsupported(f"sequence {sid}: neither part takes it (the divergent kernel: "
                          f"{k6_why}; the composed kernel: {e})") from e
    if gplan.base == "yuv":
        raise Unsupported(f"sequence {sid}: an NV12 group the divergent kernel refuses "
                          f"({k6_why}) would fall to the composed part, whose general "
                          "instances read no NV12 buffer")


def _lists(table: np.ndarray) -> np.ndarray:
    """K6's planes (its table's entries not ``FOREIGN``) in order, then the
    composed part's."""
    return np.concatenate([np.flatnonzero(table != FOREIGN),
                           np.flatnonzero(table == FOREIGN)]).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Both parts' plans over the batch's planes and the consts of one
    launch; ``n_planes``, ``out_ch``, ``dsize``, ``out_dtype`` and ``layout``
    size the output as ``cuda_batch_resize._alloc_out`` does."""

    plane_ids: Tuple[int, ...]
    k6: kd.DivergentPlan        # K6's part: its table marks the other part's planes FOREIGN
    composed: kc.ComposedPlan   # the composed part: heads and store rows at its planes alone
    consts: np.ndarray          # int32: K6's consts, zero-padded to 4 words, the plane lists
                                # (lists) zero-padded to 4 words, the composed part's tables
    cm_consts_off: int          # word offset of the composed part's consts
    #: per-device copies of the consts; the head words as a ctypes array
    device_consts: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def n_planes(self) -> int:
        return self.k6.n_planes

    @property
    def dsize(self):
        return self.k6.dsize

    @property
    def out_ch(self) -> int:
        return self.k6.out_ch

    @property
    def out_dtype(self) -> torch.dtype:
        return self.k6.out_dtype

    @property
    def layout(self) -> str:
        return self.k6.layout

    @property
    def parts(self) -> np.ndarray:
        """Each plane's part: 0 K6's, 1 the composed part's."""
        return (self.k6.table == FOREIGN).astype(np.int32)

    @property
    def lists(self) -> np.ndarray:
        """The plane lists the kernel reads: K6's planes in order, then the
        composed part's (int32, in the consts before the composed part's)."""
        return _lists(self.k6.table)

    @property
    def kind(self) -> str:
        """The composed part's source kind (``KINDS``), as the C entry picks
        it: "uint8" where each of its planes reads a uint8 image and all
        store with one row, else "any"."""
        c = self.composed
        mine = np.flatnonzero(self.parts)
        u8 = all(c.for_plane(int(z)).base != "yuv" and c.for_plane(int(z)).src_dtype == torch.uint8
                 for z in mine)
        return "uint8" if u8 and len({c.stores[z] for z in mine}) == 1 else "any"

    def tiles(self) -> Tuple[PartTiles, PartTiles]:
        """Each part's blocks, K6's then the composed part's, as the C entry
        chooses them: K6's part ``GROUP``, the composed part its form's tile
        (``GROUP``, or ``TILE2`` with a second resample). The grid holds
        K6's blocks, then the composed part's."""
        w, h = self.dsize
        n_k6 = int((self.parts == 0).sum())
        tile = kc.TILE2 if self.form in ("per_tap", "staged") else GROUP
        return (_part_tiles(n_k6, w, h, GROUP, 0),
                _part_tiles(self.n_planes - n_k6, w, h, tile, n_k6))

    @property
    def nested(self) -> bool:
        return bool(self.composed.core2)

    @property
    def form(self) -> str:
        """The composed part's instance form (``FORMS``), as the C entry
        chooses it from the heads."""
        c = self.composed
        if not c.core2:
            return "one_pixel" if c.core == "none" else "resample"
        if c.core2 == "none":
            return "fused2"
        stage = any(c.for_plane(z).word("stage2") for g in c.groups for z in g.planes)
        return "staged" if stage else "per_tap"

    def head_words(self):
        """The composed part's heads as the C entry takes them: each plane's
        (``HEAD_INTS`` words, ``NESTED_INTS`` where nested; zeros at a plane of
        K6's part), then each plane's store row, as the consts hold them."""
        c = self.device_consts.get("head")
        if c is None:
            width = kc.NESTED_INTS if self.nested else kc.HEAD_INTS
            words = self.composed.tables[:self.n_planes * (width + 1)].tolist()
            c = self.device_consts["head"] = (ctypes.c_int * len(words))(*words)
        return c

    def device_tables(self, device: torch.device) -> torch.Tensor:
        c = self.device_consts.get(device)
        if c is None:
            c = self.device_consts[device] = torch.from_numpy(self.consts.copy()).to(device)
        return c


def build_split_plan(seqs, plane_ids) -> SplitPlan:
    """The kernel plan of a divergent batch split between K6's body and the
    composed kernel's (:func:`partition`); raises :class:`Unsupported`,
    naming why, where a group no part takes, a part would be empty (such a
    batch is the other routes' to take or refuse), an NV12 group would fall
    to the composed part, a part breaks its own rules or the parts' planes
    do not stack."""
    plane_ids = tuple(plane_ids)
    k6_sids, cm_sids = partition(seqs, plane_ids)
    for sid in cm_sids:
        _refuse_group(seqs, plane_ids, sid)
    if not k6_sids:
        raise Unsupported("no group of a kind only the divergent kernel reads (a ring, an image "
                          "stack, resize_batch) or of NV12: no part for its body")
    if not cm_sids:
        raise Unsupported("every group is of a kind the divergent kernel reads: no part for the "
                          "composed kernel's body")

    def k6_part(out_dtype=None):
        try:
            return kd.build_plan(seqs, plane_ids, sids=set(k6_sids), out_dtype=out_dtype)
        except Unsupported as e:
            raise Unsupported(f"the divergent kernel's part: {e}") from e

    def composed_part(out_dtype=None):
        try:
            return kc.build_divergent_plan(seqs, plane_ids, sids=set(cm_sids),
                                           out_dtype=out_dtype)
        except Unsupported as e:
            raise Unsupported(f"the composed part: {e}") from e

    # plane 0's group gives the batch its dtype: its part first
    if plane_ids[0] in k6_sids:
        k6 = k6_part()
        cm = composed_part(k6.out_dtype)
    else:
        cm = composed_part()
        k6 = k6_part(cm.out_dtype)
    if (k6.dsize, k6.out_ch) != (cm.dsize, cm.out_ch):
        raise Unsupported(
            f"the divergent kernel's part gives planes of {k6.out_ch} channel(s) of "
            f"{k6.dsize.width}x{k6.dsize.height}, the composed part of {cm.out_ch} of "
            f"{cm.dsize.width}x{cm.dsize.height}: the planes must stack")
    # the plane lists at 16 bytes, padded so that they end where the
    # composed part's consts start
    pad = np.zeros(-k6.consts.size % 4, np.int32)
    lists = np.concatenate([_lists(k6.table), np.zeros(-len(plane_ids) % 4, np.int32)])
    consts = np.concatenate([k6.consts, pad, lists, cm.tables]).astype(np.int32)
    return SplitPlan(plane_ids=plane_ids, k6=k6, composed=cm, consts=consts,
                     cm_consts_off=consts.size - cm.tables.size)


def instance(plan: SplitPlan) -> str:
    """The kernel instance a plan launches, as a profiler names it without
    namespaces: the composed part's form and source kind
    (csrc/divergent_split.cuh); K6's part stores into any output type."""
    src = KINDS[plan.kind]
    return {"one_pixel": f"divergent_split_kernel<{src}, 1>",
            "resample": f"divergent_split_kernel<{src}, 4>",
            "fused2": f"divergent_split_nested<{src}, false>",
            "per_tap": f"divergent_split_nested<{src}, true>",
            "staged": f"divergent_split_nested_staged<{src}>"}[plan.form]


@dataclasses.dataclass(frozen=True)
class Launch:
    """One call's arguments, every tensor on one device: the one block and
    the consts, and each part's launch over its views of them."""

    plan: SplitPlan
    seqs: Tuple                 # the sequences the arguments come from
    block: torch.Tensor         # int32: K6's part's block, then the composed part's
    consts: torch.Tensor        # int32: the plan's consts
    k6: kd.Launch               # K6's part over block[:cm_off] and its consts
    composed: kc.Launch         # the composed part over block[cm_off:] and its consts
    cm_off: int                 # word offset of the composed part's block


def prepare(seqs, plan: SplitPlan, device: torch.device) -> Launch:
    """Gather one call's arguments on ``device``: both parts' blocks in one
    block, moved in one pinned non-blocking copy of its host part, and the
    sources, an array both parts read moved once. Nothing here waits for
    the device."""
    moved: Dict = {}
    k6_srcs, blk, ptr_off, desc_off = kd.gather(seqs, plan.k6, device, moved)
    cm_srcs, plane_src, cm_blk = kc.divergent_block(seqs, plan.composed, device, moved)
    cm_off = blk.extend(cm_blk)
    assert cm_off % 4 == 0, cm_off  # K6's block ends with its 16-word descriptors
    block = blk.to(device)
    consts = plan.device_tables(device)
    k6 = kd.Launch(plan=plan.k6, seqs=tuple(seqs), srcs=tuple(k6_srcs), block=block[:cm_off],
                   ptr_off=ptr_off, desc_off=desc_off, consts=consts[:plan.k6.consts.size])
    cm = kc.Launch(plan=plan.composed, pipeline=tuple(seqs), srcs=tuple(cm_srcs),
                   plane_src=tuple(plane_src), block=block[cm_off:],
                   consts=consts[plan.cm_consts_off:])
    return Launch(plan=plan, seqs=tuple(seqs), block=block, consts=consts, k6=k6, composed=cm,
                  cm_off=cm_off)


def split_reference(a: Launch):
    """The plain PyTorch version of the kernel on the launch's device: the
    eager merge (``cuda_divergent.merge``) of the sequences with every leaf
    there."""
    dev = a.block.device
    return kd.merge(map_leaves(a.seqs, lambda v: as_device_tensor(v, dev)), a.plan.plane_ids)


def _check(a: Launch) -> None:
    kd._check(a.k6)
    kc._check(a.composed)
    if a.block.data_ptr() % 16 or a.cm_off % 4 or a.plan.cm_consts_off % 4:
        raise ValueError("the block or a part's words are not 16-byte aligned")
    if a.consts.numel() != a.plan.consts.size:
        raise ValueError("the consts do not match the plan")


def divergent_split(a: Launch):
    """The kernel wrapper: launches on a CUDA tensor, runs the plain version
    on a CPU tensor, raises on anything else. It never falls back."""
    global LAUNCHES
    dev = a.block.device
    if dev.type == "cpu":
        return split_reference(a)
    if dev.type != "cuda":
        raise ValueError(f"divergent_split runs on CUDA or CPU tensors, not {dev}")
    _check(a)
    lib = _build.load()
    plan = a.plan
    buf, (sn, sc, sy, sx), result = kbr._alloc_out(plan, dev)
    w, h = plan.dsize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cvgs_divergent_split(
            a.block.data_ptr(), a.consts.data_ptr(), a.k6.ptr_off, a.k6.desc_off,
            len(plan.k6.groups), a.cm_off, plan.cm_consts_off, plan.head_words(),
            int(plan.nested), *plan.composed.conv, plan.n_planes, w, h, buf.data_ptr(),
            TYPE_CODES[plan.out_dtype], plan.out_ch, sn, sc, sy, sx, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"divergent_split launch failed: CUDA error {err} "
            f"({lib.cvgs_error_string(err).decode()})"
        )
    LAUNCHES += 1
    _build.after_launch("divergent_split", dev)
    return result


def run(seqs, plan: SplitPlan, device: torch.device):
    """One call of the kernel path: gather the arguments, launch."""
    return divergent_split(prepare(seqs, plan, device))


#: the wrapper, under the name every kernel module gives it (no ``out``)
launch = divergent_split


def work(a: Launch) -> Tuple[int, int, int]:
    """``(output bytes, source bytes touched, float32 operations)`` of one
    launch (``utils.bounds``): each part's over its own planes
    (``cuda_divergent.work``, ``cuda_composed.work``), summed; an array
    both parts read counts in each."""
    return tuple(int(x + y) for x, y in zip(kd.work(a.k6), kc.work(a.composed)))

