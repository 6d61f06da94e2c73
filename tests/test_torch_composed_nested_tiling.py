"""The nested instances' staged footprint, emulated in numpy.

With a second resample, ``csrc/composed_nested.cuh`` gives a block a tile
of ``TILE_W`` x ``TILE_H`` outputs, one a thread, and stages its
footprint of the middle image. Under a resize one warp builds each axis's
list: the tile's columns (rows) inside the output walked through the
outer stages, their first taps and the second where the edge rule keeps
it, the span of those, flags over it and a scan into a list of distinct
positions and a map from a position to its index. Under a warp the list
is the box of the taps the tile's pixels take, its map the identity. The
block evaluates every entry of the grid of listed rows x listed columns
once into shared memory; each thread takes its up to 4 taps from the grid
through the two maps. A block whose resize span passes ``SPAN``, whose
lists pass ``LIST`` or whose grid passes ``GRID`` floats of ``mid_ch``
lanes evaluates the core at each tap (the per-tap form), as does every
block of a plan whose ``stage2`` word is 0; a plane past ``used_planes``
is held. None of this runs without a card, so :func:`emulate_nested`
repeats those steps block by block: the lists (:func:`resize_list`,
:func:`box_list`, :func:`footprint`), the staged grid (the plain version's
value of the middle image at each entry, ``cuda_composed._MidReader``)
and each tap's look-up through the maps (:class:`GridReader`, which fails
on a tap the footprint left out), then the second level's lerps as the
plain version takes them. Its output must equal ``composed_reference``
bit for bit and each block's form and lists the host's mirror
``nested_tiles``. Keep the constants and the steps in step with the
source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
import torch_composed_cases as cc

CPU = torch.device("cpu")
# csrc/composed_nested.cuh: kTile2W, kTile2H, kSpan2, kList2, kGrid2
TILE_W, TILE_H, SPAN, LIST, GRID = 16, 16, 256, 64, 4096
HEADER = Path(kc.__file__).resolve().parents[1] / "csrc" / "composed_nested.cuh"
STAGED, PER_TAP, HELD = (kc.TILE_FORMS.index(f) for f in ("staged", "per_tap", "held"))


def resize_list(first: np.ndarray, second: np.ndarray, keep: np.ndarray):
    """One axis of a resize's footprint, as one warp builds it from a
    tile's columns (rows) inside the output: their first taps and the
    second where the edge rule keeps it; ``None`` past the budget, else
    ``(list, map, low)``: the span of those taps, their flags over it, the
    scan (an exclusive prefix sum of the flags) giving each flagged
    position its index in the list and the others -1."""
    taken = np.concatenate([first, second[keep]]).astype(np.int64)
    lo, hi = int(taken.min()), int(taken.max())
    if hi - lo + 1 > SPAN:
        return None
    flags = np.zeros(hi - lo + 1, np.int64)
    flags[taken - lo] = 1
    scan = np.cumsum(flags) - flags
    listed = lo + np.flatnonzero(flags)
    if listed.size > LIST:
        return None
    return listed, np.where(flags == 1, scan, -1), lo


def box_list(v: np.ndarray, take: np.ndarray):
    """One axis of a warp's footprint: the box side of the taps the tile's
    pixels take (``(4, th, tw)``), listed whole, its map the identity;
    ``None`` past LIST, an empty list where no pixel takes a tap."""
    if not take.any():
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    lo, hi = int(v[take].min()), int(v[take].max())
    if hi - lo + 1 > LIST:
        return None
    return np.arange(lo, hi + 1), np.arange(hi - lo + 1), lo


def footprint(axes, mid_ch: int):
    """A block's footprint from its two axes' lists (x, y): ``None`` where
    an axis or the grid of listed rows x listed columns (``mid_ch`` floats
    an entry) passes the budget, else ``(lists, maps, lows)``."""
    if any(ax is None for ax in axes):
        return None
    (lx, mx, ox), (ly, my, oy) = axes
    if lx.size * ly.size * mid_ch > GRID:
        return None
    return (lx, ly), (mx, my), (ox, oy)


class GridReader:
    """A block's staged grid read as ``cuda_composed._sample`` reads taps:
    each tap taken through the axes' maps into the grid (``(ny, nx, C)``);
    a tap not taken holds 0 (the lerps drop it)."""

    def __init__(self, mid, grid, maps, lows):
        self.plan, self.fblk = mid.plan, mid.fblk
        self.grid, self.maps, self.lows = grid, maps, lows

    def tap(self, y, x, need):
        index = []
        for pos, m, lo in ((y, self.maps[1], self.lows[1]), (x, self.maps[0], self.lows[0])):
            i = pos.numpy() - lo
            inside = (i >= 0) & (i < m.size)
            j = np.where(inside, m[np.clip(i, 0, max(m.size - 1, 0))] if m.size else -1, -1)
            assert not (need.numpy() & (j < 0)).any(), "a tap taken outside the footprint"
            index.append(torch.from_numpy(np.maximum(j, 0)))
        if self.grid.numel() == 0:
            return torch.zeros((*y.shape, self.grid.shape[-1]), dtype=self.grid.dtype)
        v = self.grid[index[0], index[1]]
        return kc._where(need[..., None], v, torch.zeros_like(v))


def emulate_nested(a: kc.Launch, forms: list):
    """The kernel's output for a nested launch, block by block as
    ``composed_nested.cuh`` stages or evaluates per tap; each plane's
    blocks' ``(form, rows listed, columns listed)`` appended to ``forms``
    (none for a plan without a second resample: one pixel a thread)."""
    plan = a.plan
    w, h = plan.dsize
    used, ch = kc._used(a), plan.word("mid_ch")

    def plane_value(a, srcs, z, p, yc, xc, need):
        # a mixed-geometry batch's plane: its own levels and stage2
        q = plan.for_plane(z)
        lv0, lv1, stage = q.level(0), q.level(1), q.word("stage2")
        r = kc._Reader(a, srcs, z, p)
        yi = torch.arange(lv0.core_h)[:, None].expand(lv0.core_h, lv0.core_w)
        xi = torch.arange(lv0.core_w)[None, :].expand(lv0.core_h, lv0.core_w)
        mid = kc._MidReader(r, kc._sample(r, lv0, yi, xi, torch.ones_like(yi, dtype=torch.bool)),
                            p)
        if lv1.core == "none":
            return kc._sample(mid, lv1, yc, xc, need)
        ys, xs, take = (t.numpy() for t in kc.second_taps(a, z))
        if lv1.core == "resize":
            row_taps, col_taps = (kc.resize_axis_taps(a, z, axis) for axis in (0, 1))
        out = torch.zeros((h, w, ch), dtype=torch.float32)
        blocks = np.zeros((-(-h // TILE_H), -(-w // TILE_W), 3), np.int64)
        for by in range(blocks.shape[0]):
            for bx in range(blocks.shape[1]):
                sl = (slice(by * TILE_H, (by + 1) * TILE_H), slice(bx * TILE_W, (bx + 1) * TILE_W))
                reader, form = mid, (HELD if z >= used else PER_TAP)
                fp = None
                if z < used and stage and lv1.core == "resize":
                    fp = footprint([resize_list(*(v[sl[1]] for v in col_taps)),
                                    resize_list(*(v[sl[0]] for v in row_taps))], ch)
                elif z < used and stage:
                    tile = (slice(None), *sl)
                    fp = footprint([box_list(xs[tile], take[tile]),
                                    box_list(ys[tile], take[tile])], ch)
                if fp is not None:
                    (cols, rows), maps, lows = fp
                    yy, xx = torch.broadcast_tensors(torch.from_numpy(rows)[:, None],
                                                     torch.from_numpy(cols)[None, :])
                    grid = mid.tap(yy, xx)  # each entry once: the staged values
                    reader, form = GridReader(mid, grid, maps, lows), STAGED
                    blocks[by, bx] = (form, rows.size, cols.size)
                else:
                    blocks[by, bx, 0] = form
                out[sl] = kc._sample(reader, lv1, yc[sl], xc[sl], need[sl])
        forms.append(blocks)
        return out

    return kc._reference(a, plane_value=plane_value)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _check(ops, stage=None):
    """The emulation against the plain version bit for bit, and its blocks'
    forms against the host's mirror; returns the forms. ``stage`` 0 or 1
    sets the plan's ``stage2`` word (the kernel instance) in place of
    ``build_plan``'s choice."""
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    if stage is not None and plan.core2 in ("resize", "warp"):
        if plan.planes:  # a mixed-geometry batch: every plane's word
            t = kc._tree(p)
            plan = kc._mixed([kc.dataclasses.replace(q, head=kc._with_words(q.head, stage2=stage))
                              for q in (kc._plane_plan(t, pl, p) for pl in t.planes)])
        else:
            plan = kc.dataclasses.replace(plan, head=kc._with_words(plan.head, stage2=stage),
                                          device_consts={})
    a = kc.prepare(p, plan, CPU)
    forms: list = []
    got, want = emulate_nested(a, forms), kc.composed_reference(a)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(_bits(g), _bits(w))
    if plan.core2 == "none":
        assert forms == []
        return None
    forms = np.stack(forms)
    np.testing.assert_array_equal(forms, kc.nested_tiles(a))
    return forms


def _nested(size=(36, 48), values=0, seed=3):
    return cc.nested_cases(T, cc.nested_frames(*size, seed), values)


def test_the_constants_are_the_kernels():
    src = HEADER.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert (const("kTile2W"), const("kTile2H"), const("kSpan2"), const("kList2"),
            const("kGrid2")) == (TILE_W, TILE_H, SPAN, LIST, GRID)
    assert (kc.TILE2, kc.SPAN2, kc.LIST2, kc.GRID2) == ((TILE_W, TILE_H), SPAN, LIST, GRID)
    assert "int stage2;" in src and kc._MID_WORDS[-1] == "stage2"
    # the staged grid and the three op tables fit a block's 48 KB of static
    # shared memory: 4 words, each warp's 4 extremes, the maps, 7 words a
    # listed position, the grid; the tables' rows of 32 bytes; and each
    # thread's four taps' slots in the grid
    assert 4 * (4 + 8 * 4 + 2 * SPAN + 2 * LIST * 7 + GRID) + 3 * 256 * 32 <= 48 * 1024
    assert GRID >= 4 * 4 * 256
    # and, in the mixed instances, the block's copy of its plane's head
    # (kNestedWords int32 words): 47,792 bytes in all
    staged_mixed = 4 * (4 + 8 * 4 + 2 * SPAN + 2 * LIST * 7 + GRID + kc.NESTED_INTS) + 3 * 256 * 32
    assert staged_mixed == 47792 <= 48 * 1024


@pytest.mark.parametrize("stage", [None, 1])
@pytest.mark.parametrize("values", [0, 1])
@pytest.mark.parametrize("size", [(36, 48), (54, 96)])
@pytest.mark.parametrize("name", cc.NESTED_NAMES)
def test_nested_cases(name, size, values, stage):
    """Each case as ``build_plan`` routes it, and staged wherever its
    footprint fits."""
    forms = _check(_nested(size, values)[name], stage)
    if forms is None:
        assert name.startswith("n5")
        return
    if name.startswith("n6"):
        used = cc.N6_USED - values
        assert (forms[used:, ..., 0] == HELD).all() and (forms[:used, ..., 0] != HELD).all()


@pytest.mark.parametrize("stage", [None, 1])
@pytest.mark.parametrize("name", list(cc.more_nested_cases(T)))
def test_more_nested_cases(name, stage):
    _check(cc.more_nested_cases(T)[name], stage)


@pytest.mark.parametrize("name", ["n1_top_view_resized", "n2_resize_then_rotate",
                                  "n6_top_views_of_8_cameras_ragged"])
def test_every_block_per_tap_where_the_plan_says_so(name):
    forms = _check(_nested()[name], stage=0)
    assert set(np.unique(forms[..., 0])) <= {PER_TAP, HELD}
    assert (forms[..., 0] == PER_TAP).any()


def test_which_structures_stage():
    """``build_plan``'s stage2 word from the structure: a warp second level
    stages, a resize where its tiles share taps (an upscale), not where
    each output takes its own (a 3:1 downscale under the edge rule, N4's
    2.4:1 one)."""
    stage = {name: kc.build_plan(T.build_pipeline(*ops)).word("stage2")
             for name, ops in {**_nested(), **cc.more_nested_cases(T)}.items()}
    assert stage["n2_resize_then_rotate"] == stage["quarter_scale_warp_of_a_resize"] == 1
    assert stage["warp_of_a_warp"] == stage["upscale_of_a_downscale"] == 1
    for name in ("n1_top_view_resized", "n3_two_level_downscale",
                 "n4_crop_of_a_downscale_resized", "n6_top_views_of_8_cameras_ragged",
                 "n5_letterbox_of_a_normalized_resize"):
        assert stage[name] == 0, name
    taps = kc._resample(T.resize(T.image(np.zeros((8, 8, 1), np.uint8)), T.Size(100, 75)),
                        30, 40, 1)[-1]
    assert kc.tap_share(taps, 75, 100, True) < 0.1


def test_a_quarter_scale_warp_passes_the_budget():
    """A 16x16 tile of a warp at scale 0.25 spans about 74 columns and rows
    of the middle image: its blocks evaluate per tap; a block that holds
    the warp's corner with few taps inside the source may still stage."""
    forms = _check(cc.more_nested_cases(T)["quarter_scale_warp_of_a_resize"])[0]
    assert (forms[:2, :3, 0] == PER_TAP).all(), forms[..., 0]
    assert (forms[..., 0] == PER_TAP).sum() >= 6


def test_an_upscale_shares_its_taps():
    """A 2.5x upscale: a 16x16 tile's taps are 8 or 9 columns and rows, an
    eighth of a core value a pixel where the per-tap form takes 4."""
    forms = _check(cc.more_nested_cases(T)["upscale_of_a_downscale"])[0]
    assert (forms[..., 0] == STAGED).all()
    full = forms[:-1, :-1]
    assert full[..., 1].max() <= 9 and full[..., 2].max() <= 9
    assert (full[..., 1] * full[..., 2]).mean() / (TILE_W * TILE_H) < 0.35


def test_a_warp_at_scale_1_stages_under_two_values_a_pixel():
    """N2 at a reduced size (a 96x64 middle image rotated 10 degrees): a
    tile inside it stages a box of 19 x 19 to 20 x 20 entries, about 1.5
    core values a pixel where the per-tap form takes 4."""
    forms = _check(_nested((96, 144))["n2_resize_then_rotate"])[0]
    assert (forms[..., 0] == STAGED).all()
    inside = forms[1:-1, 1:-1]
    assert (inside[..., 1] >= 19).all() and (inside[..., 1] <= 20).all()
    per_pixel = (inside[..., 1] * inside[..., 2]).mean() / (TILE_W * TILE_H)
    assert 1.3 < per_pixel < 1.7, per_pixel


@pytest.mark.parametrize("name", ["n1_top_view_resized", "n3_two_level_downscale"])
def test_a_3_to_1_resize_stages_one_value_a_pixel(name):
    """Under the 3:1 edge rule each output takes one tap: staged, a full
    16x16 tile lists 16 columns and 16 rows, a core value a pixel as per
    tap (so ``build_plan`` takes the per-tap instance)."""
    forms = _check(_nested((96, 144))[name], stage=1)[0]
    full = forms[:-1, :-1]
    assert (full[..., 0] == STAGED).all()
    assert (full[..., 1] == 16).all() and (full[..., 2] == 16).all()


def test_an_outer_wrap_spreads_the_tile_past_the_budget():
    """A WRAP border above the second level maps a tile across its edge to
    both ends of a 300-wide middle image: that block's span passes
    SPAN and it evaluates per tap; the blocks inside stage."""
    img = cc._img((72, 96, 3), 31)
    ops = (T.make_border(T.resize(T.resize(T.image(img), T.Size(300, 40)), T.Size(300, 40)),
                         0, 0, 8, 8, T.BorderMode.WRAP), *cc.normalize(T), T.split_tensor())
    forms = _check(ops, stage=1)[0]
    assert forms[0, 0, 0] == PER_TAP and forms[0, -1, 0] == PER_TAP
    assert (forms[:, 1:-1, 0] == STAGED).all()


@pytest.mark.parametrize("dst", [(97, 61), (3, 250), (301, 1)])
def test_outputs_off_the_tile_grid(dst):
    """Widths and heights off 16: a block's threads past the output take no
    tap and stage nothing."""
    img = cc._img((72, 96, 3), 32)
    size = T.Size(*dst)
    for ops in ((T.resize(T.resize(T.image(img), T.Size(61, 37)), size), *cc.normalize(T),
                 T.split_tensor()),
                (T.warp(T.resize(T.image(img), T.Size(120, 80)), cc.rotation((60, 40), 7.0), size),
                 T.split_tensor())):
        _check(ops, stage=1)


@pytest.mark.parametrize("used", [0, 3, 8, -1])
def test_held_planes_take_neither_form(used):
    read = _nested()["n6_top_views_of_8_cameras_ragged"]
    ops = (T.batch_read(list(read[0].ops), used_planes=used, default=(-1.5, 300.7, 0.25)),
           *read[1:])
    forms = _check(ops, stage=1)
    held = min(max(used, 0), cc.N6_PLANES)
    assert (forms[held:, ..., 0] == HELD).all() and (forms[:held, ..., 0] != HELD).all()


@pytest.mark.parametrize("stage", [None, 0, 1])
@pytest.mark.parametrize("family", ["uint8", "nv12"])
@pytest.mark.parametrize("name", cc.NESTED_MIXED_NAMES)
def test_nested_mixed_cases(name, family, stage):
    """A batch of nested planes of their own geometry, block by block as
    the mixed nested instances take it: each plane's blocks in the form its
    own ``stage2`` and footprint give (as ``build_plan`` sets each plane's
    word, or every plane per tap or staged), equal to the plain version and
    to ``nested_tiles``."""
    ops = cc.nested_mixed_cases(T, cc.mixed_frames(family, 16))[name]
    forms = _check(ops, stage)
    if name.startswith("nm2"):
        assert forms is None
        return
    if stage == 0:
        assert set(np.unique(forms[..., 0])) <= {PER_TAP, HELD}
    if name.startswith("nm1"):
        assert (forms[2:, ..., 0] == HELD).all() and (forms[:2, ..., 0] != HELD).all()


def test_planes_of_one_launch_take_their_own_forms():
    """NM4 at a larger size: the planes whose crops are upscaled stage every
    block, the plane whose crop is downscaled (``stage2`` 0) takes the
    per-tap form in every block, in one launch."""
    f = cc.mixed_frames("uint8", 17, ((90, 120), (120, 160), (70, 50)))
    forms = _check(cc.nested_mixed_cases(T, f)["nm4_roi_crops_of_a_downscale"])
    assert (forms[[0, 2], ..., 0] == STAGED).all()
    assert (forms[1, ..., 0] == PER_TAP).all()
