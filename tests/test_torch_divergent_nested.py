"""Divergent batches with a nested group in one launch of the composed
kernel's nested instances, on the CPU: which batches
``cuda_composed.build_divergent_plan`` takes, its plain version against the
JAX package and the port's eager merge, the plan's words, and the second
level that a plane without one of its own is carried through.

- Routing, decided on the host: DVN1-DVN4 (``torch_composed_cases.
  divergent_nested_cases``: letterboxes beside top views; per-tap top views,
  ragged, beside staged rotated downscales; a FusedRead2 alone beside a
  uint16 sensor's regions resized twice; NV12 letterboxes beside NV12 top
  views) are refused by the divergent kernel and taken by the composed
  kernel's divergent plan with ``NESTED_INTS``-word heads:
  ``executor._select_divergent(..., cuda)`` names
  ``cuda:composed:divergent``; ``cuda_composed.divergent_instance`` names
  the instance the C entries launch. DV1-DV4 keep their one-level heads and
  instances, and the divergent kernel keeps its batches.
- Parity: each batch built with the JAX factories and carried across with
  ``from_jax``: the port's eager merge equals the reference's merge loop
  op by op bit for bit and its ``ParBackend.XLA`` merge within 1e-4
  (float32) or 1 (uint8); the plain version equals the eager merge bit for
  bit, also with a nested group of each source dtype beside a uint8
  one-level group.
- The lift: a plane with no second resample beside one with it carries an
  identity resize (``_identity_taps``, the edge rule kept, ``stage2`` 0);
  a one-level plane beside FusedRead2s alone an empty FusedRead2. The plain
  version read through the lifted heads' own words equals the plain
  version of the planes as they are bit for bit, on sources of NaN,
  infinities and subnormals too.
- The plan: every head ``NESTED_INTS`` words, ``batch`` ``DIVERGENT``,
  ``plane_stride`` 0, its block offsets absolute (the block's words there
  are the plane's own values), each nested plane's ``stage2`` its group's;
  each plane's staged rows (both chains and FusedRead2's) and tap tables
  (both levels) those of its group's own launch; ``nested_tiles`` per
  plane; new values build no plan; ``work`` sums the groups'.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import flatten
import torch_composed_cases as cc
from test_torch_divergent_composed import (_assert_equal, _chip_smoke_rows, _k6_batches, _records,
                                           check)

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # only named: the routing is decided on shapes
DTYPES = ("uint8", "int8", "uint16", "int16", "float16", "float32", "int32", "int64", "float64")
#: the instance each case launches (``kc.divergent_instance``)
INSTANCES = {
    "dvn1": "composed_kernel_nested_mixed<unsigned char, true>",
    "dvn2": "composed_kernel_nested_mixed_staged<unsigned char>",
    "dvn3": "composed_kernel_nested_mixed_staged<AnyImage>",
    "dvn4": "composed_kernel_nested_mixed<Nv12, true>",
    "dv1": "composed_kernel_mixed<unsigned char, 4, 1>",
    "dv2": "composed_kernel_mixed<AnyImage, 4, 1>",
    "dv3": "composed_kernel_mixed<AnyImage, 4, 1>",
    "dv4": "composed_kernel_mixed<unsigned char, 1, 1>",
}


def _tseqs(ops):
    return tuple(T.build_operation_sequence(*o) for o in ops)


def _jseqs(ops):
    return tuple(J.build_operation_sequence(*o) for o in ops)


def _nv12_check(ids, jseqs):
    """``check`` for NV12 groups: against the reference's XLA merge within
    one uint8 step of a converted tap through the normalizing chain (XLA
    contracts the YUV sums, ``ROADMAP.md`` §3), as the NV12 nested mixed
    batches are held."""
    out = check(ids, jseqs, xla=False)
    xla = J.launch_divergent_batch(ids, *jseqs, backend=J.ParBackend.XLA)
    for g, x in zip(out[1], xla, strict=True):
        d = np.abs(g.numpy().astype(np.float64) - np.asarray(x, np.float64)).max()
        assert d <= 1 / 255.0 / min(cc.STD) + 1e-5, d
    return out


def _plain(ids, seqs, lift=None):
    plan = kc.build_divergent_plan(seqs, ids, lift)
    a = kc.prepare(seqs, plan, CPU)
    return a, kc.composed(a)


def _case(name, M=T, seed=71, values=0, **frames):
    return cc.divergent_nested_cases(M, cc.divergent_nested_frames(seed, **frames), values)[name]


def _sensor_beside_boxes(M, dtype, seed=73):
    """DVN1's uint8 letterboxes (one level) beside DVN3's regions of the
    sensor frame resized twice (nested), the sensor of ``dtype``."""
    f = cc.divergent_nested_frames(seed, dtype)
    boxes = cc.divergent_nested_cases(M, f)["dvn1_top_views_beside_letterboxes"][1][0]
    rois = cc.divergent_nested_cases(M, f)["dvn3_normalized_letterboxes_beside_a_12bit_sensor"][1][1]
    return [1, 2] * 4, (boxes, rois)


def _lifted(a: kc.Launch) -> kc.Launch:
    """The launch with each plane's plan read through its head's own second
    level (``core2`` from the head's word): a lifted plane as the kernel
    runs it, an identity resize or an empty FusedRead2 over its value."""
    planes = tuple(dataclasses.replace(q, core2=kc.CORES[q.word("core2")])
                   for q in a.plan.planes)
    return dataclasses.replace(a, plan=dataclasses.replace(a.plan, planes=planes))


# --- routing and parity -----------------------------------------------------------


@pytest.mark.parametrize("values", [0, 1])
@pytest.mark.parametrize("name", cc.DIVERGENT_NESTED_NAMES)
def test_a_nested_divergent_batch_against_the_reference(name, values):
    """The eager merge bit for bit the reference op by op and within the
    tolerance of its XLA merge; the plain version bit for bit the eager
    merge; ``cuda:composed:divergent``, the nested instance named."""
    ids, ops = _case(name, J, 51 + values, values)
    _, _, a = (_nv12_check if name.startswith("dvn4") else check)(ids, _jseqs(ops))
    assert len(a.plan.head) == kc.NESTED_INTS and a.plan.core2
    assert kc.divergent_instance(a.plan) == INSTANCES[name[:4]]


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_source_dtype_as_a_nested_group(dtype):
    """A nested group (regions of the sensor frame resized twice) of each
    source dtype beside a uint8 one-level group (letterboxes): the
    reference op by op and the eager merge bit for bit; the general nested
    instances where the two read different kinds of source."""
    ids, ops = _sensor_beside_boxes(J, dtype)
    _, _, a = check(ids, _jseqs(ops))
    canonical = {"int64": "int32", "float64": "float32"}.get(dtype, dtype)
    assert [str(a.plan.for_plane(z).src_dtype)[6:] for z in (0, 1)] == ["uint8", canonical]
    src = "unsigned char" if dtype == "uint8" else "AnyImage"
    assert kc.divergent_instance(a.plan).split("<")[1].startswith(src)


def test_an_int32_fused_read2_beside_a_second_resample():
    """A FusedRead2 alone whose chain ends in int32 (a letterbox of a resize
    cast to int32) beside a second resample: lifted to the identity resize,
    whose value keeps its int32 bits (``mid_type`` float32 in its head);
    the reference op by op and the eager merge bit for bit."""
    f = cc.divergent_nested_frames(74)
    wide = f["wide"]
    h, w = wide[0].shape[:2]
    (iw, ih), (t, b, l, r) = cc.letterbox(w, h, 16)
    boxes = J.batch_read([J.make_border(J.fuse(J.resize(J.image(c), J.Size(iw, ih)),
                                               J.convert_to(np.int32, alpha=3.0, beta=-200.0)),
                                        t, b, l, r, J.BorderMode.CONSTANT, -7.0) for c in wide])
    tops = cc.divergent_nested_cases(J, f)["dvn1_top_views_beside_letterboxes"][1][1][0]
    ids = [1, 2] * 4
    tseqs, _, a = check(ids, _jseqs(((boxes, J.convert_to(np.float32, alpha=0.5),
                                      J.split_tensor()),
                                     (tops, J.convert_to(np.float32, alpha=0.5),
                                      J.split_tensor()))))
    q = a.plan.for_plane(0)
    assert q.core2 == "none" and q.mid_dtype == torch.int32
    assert q.word("core2") == kc.CORES.index("resize")
    assert q.word("mid_type") == kc.TYPE_CODES[torch.float32]
    assert q.word("core_type") == kc.TYPE_CODES[torch.int32]
    _assert_equal(kc.composed_reference(_lifted(a)), kc.composed_reference(a), "lifted")


@pytest.mark.parametrize("name", cc.DIVERGENT_NAMES)
def test_the_one_level_batches_keep_their_plan_and_instance(name):
    """DV1-DV4 keep their ``HEAD_INTS``-word heads and the one-level mixed
    or general instances (the divergent plan of PR 22)."""
    ids, ops = cc.divergent_cases(T, cc.divergent_frames(75))[name]
    plan = kc.build_divergent_plan(_tseqs(ops), ids)
    assert plan.core2 == "" and len(plan.head) == kc.HEAD_INTS
    assert plan.tables[:plan.n_planes * kc.HEAD_INTS].size == plan.n_planes * len(plan.head)
    assert kc.divergent_instance(plan) == INSTANCES[name[:3]]
    assert executor._select_divergent(_tseqs(ops), ids, T.ParBackend.AUTO, CUDA).backend == \
        "cuda:composed:divergent"


@pytest.mark.parametrize("name", ["ring_and_stack", "crop_resize_and_warps", "nv12_and_images",
                                  "d1_circular_first3", "d2_nv12_bt709", "d3_crop_resize",
                                  "d4_warp_crop_pass", "d14_ragged"])
def test_the_divergent_kernel_keeps_its_batches(name):
    """A batch the divergent kernel takes keeps ``cuda:divergent``."""
    ids, seqs = (_chip_smoke_rows() if name[0] == "d" else _k6_batches())[name]
    kd.build_plan(seqs, ids)
    assert executor._select_divergent(seqs, ids, T.ParBackend.AUTO, CUDA).backend == \
        "cuda:divergent"


# --- the lift ---------------------------------------------------------------------


def _edge_cameras(seed: int):
    """Eight float32 cameras (27x48) of values in 0..255 with a sixteenth of
    them NaN, an infinity, or a subnormal of either sign."""
    rng = np.random.default_rng(seed)
    edges = np.array([np.nan, np.inf, -np.inf, 1e-40, -3e-39, 1e-45, -0.0], np.float32)
    out = []
    for _ in range(8):
        c = (rng.random((27, 48, 3)) * 255).astype(np.float32)
        mask = rng.random(c.shape) < 1 / 16
        c[mask] = rng.choice(edges, int(mask.sum()))
        out.append(c)
    return out


@pytest.mark.parametrize("lift", kc.LIFTS)
@pytest.mark.parametrize("name", cc.DIVERGENT_NAMES[:3])
def test_a_one_level_batch_lifted(name, lift):
    """DV1-DV3 with every plane lifted (``lift``): every head
    ``NESTED_INTS`` words, the second level an identity resize or an empty
    FusedRead2, ``stage2`` 0; the plain version through the lifted words
    bit for bit the batch's own plain version and the eager merge."""
    ids, ops = cc.divergent_cases(T, cc.divergent_frames(76))[name]
    seqs = _tseqs(ops)
    a, got = _plain(ids, seqs, lift)
    _assert_equal(got, T.launch_divergent_batch(ids, *seqs, device="cpu"), "plain vs eager")
    assert a.plan.core2 == lift and len(a.plan.head) == kc.NESTED_INTS
    for q in a.plan.planes:
        assert q.core2 == "" and q.word("core2") == kc.CORES.index(lift)
        assert q.word("stage2") == 0 and q.word("mid_n_ops") == 0
        assert (q.word("mid_h"), q.word("mid_w")) == (q.word("core_h"), q.word("core_w"))
    _assert_equal(kc.composed_reference(_lifted(a)), got, "lifted vs plain")
    form = {"resize": "true", "none": "false"}[lift]
    assert kc.divergent_instance(a.plan).endswith(f", {form}>")


@pytest.mark.parametrize("lift", kc.LIFTS)
def test_one_pixel_groups_are_not_lifted(lift):
    """DV4's one-pixel groups: the nested instances sample a resampling
    core, so the plan refuses to lift them, naming why."""
    ids, ops = cc.divergent_cases(T, cc.divergent_frames(84))["dv4_one_pixel_groups"]
    with pytest.raises(kc.Unsupported, match="nested instances sample a resampling core"):
        kc.build_divergent_plan(_tseqs(ops), ids, lift)


@pytest.mark.parametrize("lift", kc.LIFTS)
def test_the_lift_copies_nan_infinities_and_subnormals(lift):
    """DVN1's trees over float32 cameras holding NaN, infinities and
    subnormals, no chain: letterboxes whose exact 3:1 resize copies its
    taps (subnormals kept) beside top views: the plain version through the
    lifted heads bit for bit the plain version and the eager merge, more
    than 0 outputs NaN and subnormal each; and the letterboxes alone lifted
    by ``lift`` alike."""
    cams = _edge_cameras(77)
    persp = dict(warp_type=T.WarpType.PERSPECTIVE, default=0.0)
    ids = [1, 1, 2, 2] * 2
    seqs = _tseqs((
        (T.batch_read([T.make_border(T.resize(T.image(c), T.Size(16, 9)), 3, 4, 0, 0,
                                     T.BorderMode.CONSTANT, 114.0) for c in cams]),
         T.split_tensor()),
        (T.batch_read([T.resize(T.warp(T.image(c), cc.top_view(48, 27, k), T.Size(48, 27),
                                       **persp), T.Size(16, 16)) for k, c in enumerate(cams)]),
         T.split_tensor())))
    a, got = _plain(ids, seqs)
    _assert_equal(got, T.launch_divergent_batch(ids, *seqs, device="cpu"), "plain vs eager")
    _assert_equal(kc.composed_reference(_lifted(a)), got, "lifted vs plain")
    assert bool(torch.isnan(got).any())
    assert bool(((got != 0) & (got.abs() < 2.0 ** -126)).any())
    a, got = _plain([1] * 8, seqs[:1], lift)
    _assert_equal(kc.composed_reference(_lifted(a)), got, "the letterboxes lifted vs plain")
    assert bool(torch.isnan(got).any())


def test_a_one_level_group_beside_fused_read2s_alone():
    """DV1's letterboxes beside DVN3's N5 letterboxes (a FusedRead2 alone):
    no second resample in the batch, so the one-level planes carry an empty
    FusedRead2 (``core2`` "none"), the FusedRead2 instance; bit for bit."""
    f = cc.divergent_nested_frames(78)
    cases = cc.divergent_nested_cases(J, f)
    boxes = cases["dvn1_top_views_beside_letterboxes"][1][0]
    fused = cases["dvn3_normalized_letterboxes_beside_a_12bit_sensor"][1][0]
    _, _, a = check([1, 2, 2, 1] * 2, _jseqs(((boxes[0], J.split_tensor()), fused)))
    assert a.plan.core2 == "none"
    assert [q.word("core2") for q in a.plan.planes] == [kc.CORES.index("none")] * 8
    assert kc.divergent_instance(a.plan) == "composed_kernel_nested_mixed<unsigned char, false>"
    _assert_equal(kc.composed_reference(_lifted(a)), kc.composed_reference(a), "lifted")


# --- the plan ---------------------------------------------------------------------


def test_the_plan_s_words():
    """Every head ``NESTED_INTS`` words, ``batch`` DIVERGENT, ``plane_stride``
    0, in the consts a plane apart from 0, then each plane's store row; each
    nested plane's ``stage2`` its group's own launch's; a lifted plane's
    second level the identity (its taps at ``taps2_off``, ``keep_edge2``
    1); the block's words at the offsets are the plane's own values:
    DVN1's border value and both maps, DVN2's ``used_planes``, DVN3's crop
    origins above the core, FusedRead2's scalar and the border under it."""
    for name in cc.DIVERGENT_NESTED_NAMES:
        ids, ops = _case(name)
        seqs = _tseqs(ops)
        a, _ = _plain(ids, seqs)
        plan, n = a.plan, a.plan.n_planes
        words = plan.tables[:n * kc.NESTED_INTS].reshape(n, -1)
        assert tuple(plan.tables[n * kc.NESTED_INTS:][:n]) == plan.stores
        assert plan.head_words()[:] == [w for q in plan.planes for w in q.head] + list(plan.stores)
        for g in plan.groups:
            pipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
            own = kc.build_plan(pipe)
            for j, z in enumerate(g.planes):
                q = plan.for_plane(z)
                assert len(q.head) == kc.NESTED_INTS and tuple(words[z]) == q.head
                assert q.word("batch") == kc.DIVERGENT and q.word("plane_stride") == 0
                if q.core2 in ("resize", "warp"):
                    assert q.word("stage2") == own.for_plane(j).word("stage2"), (name, z)
                    continue
                assert q.word("core2") == kc.CORES.index("resize") and q.word("stage2") == 0
                assert q.word("keep_edge2") == 1
                at, mw, mh = q.word("taps2_off"), q.word("mid_w"), q.word("mid_h")
                assert np.array_equal(plan.tables[at:at + 3 * (mw + mh)],
                                      kc._identity_taps(mh, mw))
    fblk = lambda a: a.block.view(torch.float32)  # noqa: E731
    ids, ops = _case("dvn1_top_views_beside_letterboxes", values=1)
    seqs = _tseqs(ops)
    a, _ = _plain(ids, seqs)
    for z, sid in enumerate(ids):
        q = a.plan.for_plane(z)
        if sid == 1:
            (st,) = q.stage_list(2)
            assert float(fblk(a)[st[6]]) == 100.0
        else:
            warp = seqs[1].read.ops[z].source
            coeffs = np.asarray(warp.coeffs, np.float32).reshape(-1)
            at = q.word("coef_off")
            assert np.array_equal(fblk(a)[at:at + 9].numpy(), coeffs)
    ids, ops = _case("dvn2_top_views_beside_rotated_downscales")
    a, _ = _plain(ids, _tseqs(ops))
    q = a.plan.for_plane(0)
    assert int(a.block[q.word("used_off")]) == cc.DVN2_USED
    assert a.plan.for_plane(1).word("used_off") == -1
    coeffs = np.asarray(a.pipeline[1].read.ops[1].coeffs, np.float32).reshape(-1)
    at = a.plan.for_plane(1).word("coef2_off")
    assert np.array_equal(fblk(a)[at:at + 6].numpy(), coeffs[:6])
    ids, ops = _case("dvn3_normalized_letterboxes_beside_a_12bit_sensor", values=1)
    a, _ = _plain(ids, _tseqs(ops))
    for z, sid in enumerate(ids):
        q = a.plan.for_plane(z)
        if sid == 1:
            assert float(fblk(a)[q.word("mid_fp_off")]) == np.float32(1 / 255.0)
            (st,) = q.stage_list(2)
            assert float(fblk(a)[st[6]]) == np.float32(0.447 - 0.1)
        else:
            (st,) = q.stage_list(4)  # below the second resample: no FusedRead2 there
            crop = a.pipeline[1].read.ops[z].source
            assert (int(a.block[st[4]]), int(a.block[st[5]])) == (int(crop.x), int(crop.y))


def _mid_records(plan, head, block):
    """FusedRead2's rows as the kernel stages them and the second
    resample's tap tables, of the nested plane head ``head``."""
    from test_torch_tiling import stage_rows

    q = dataclasses.replace(plan, head=head)
    n, ops, fp = q.word("mid_n_ops"), q.word("mid_ops_off"), q.word("mid_fp_off")
    table = plan.tables[ops:ops + 5 * n + 1]
    rows = [(c, a, ch, v.tolist()) for chunk in stage_rows(table, n, block.view(
        torch.float32).numpy()[fp:]) for c, a, ch, v in chunk]
    at = q.word("taps2_off")
    size = 3 * (q.word("core2_w") + q.word("core2_h")) if q.word("core2") == 1 else 0
    return rows, plan.tables[at:at + size].tolist()


@pytest.mark.parametrize("name", cc.DIVERGENT_NESTED_NAMES)
def test_each_plane_stages_its_group_s_rows_and_taps(name):
    """The kernel reads a plane's op tables (both chains and FusedRead2's),
    its chain scalars and its tap tables (both levels) at its head's
    offsets: from the divergent plan's consts and block, each plane's
    staged rows and tap tables equal those its group's own launch over its
    planes reads (its one-geometry or mixed plan, held on the card since
    PRs 18 and 21)."""
    ids, ops = _case(name, seed=79)
    seqs = _tseqs(ops)
    a, _ = _plain(ids, seqs)
    for g in a.plan.groups:
        pipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
        own = kc.prepare(pipe, kc.build_plan(pipe), CPU)
        for j, z in enumerate(g.planes):
            head = a.plan.for_plane(z).head
            q = own.plan.for_plane(j)
            stride = j * q.word("plane_stride")
            want_head = kc._rebase(q, stride, 0) if stride else q.head
            assert _records(a.plan, head, a.block) == _records(own.plan, want_head,
                                                               own.block), (name, z)
            if q.core2:  # a FusedRead2 alone's identity resize: test_the_plan_s_words
                got, want = (_mid_records(p, h, b) for p, h, b in (
                    (a.plan, head, a.block), (own.plan, want_head, own.block)))
                assert got[0] == want[0] and (q.core2 == "none" or got[1] == want[1]), (name, z)


@pytest.mark.parametrize("name", cc.DIVERGENT_NESTED_NAMES[:3])
def test_each_plane_s_blocks_take_its_group_s_forms(name):
    """``nested_tiles`` per plane: a nested plane's blocks take the forms
    of its group's own launch (staged, per tap, held past the group's
    ``used_planes``, counted over the batch's planes), a lifted plane's per
    tap."""
    ids, ops = _case(name, seed=80)
    seqs = _tseqs(ops)
    a, _ = _plain(ids, seqs)
    tiles = kc.nested_tiles(a)
    for g in a.plan.groups:
        pipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
        own = kc.prepare(pipe, kc.build_plan(pipe), CPU)
        if not own.plan.core2 or own.plan.core2 == "none":
            assert (tiles[list(g.planes)][..., 0] == kc.TILE_FORMS.index("per_tap")).all()
            continue
        mine = kc.nested_tiles(own)
        for j, z in enumerate(g.planes):
            if kc._held(a, z):
                assert (tiles[z][..., 0] == kc.TILE_FORMS.index("held")).all()
            else:
                assert np.array_equal(tiles[z], mine[j]), (name, z)
    if name.startswith("dvn2"):  # plane 6 past the top views' used_planes
        assert (tiles[6][..., 0] == kc.TILE_FORMS.index("held")).all()
        assert (tiles[1][..., 0] == kc.TILE_FORMS.index("staged")).any()


@pytest.mark.parametrize("name", cc.DIVERGENT_NESTED_NAMES)
def test_new_values_build_no_plan(name):
    """New frames of the same sizes, maps, angles, origins, border values
    and ``used_planes`` leave the batch's plan as it was; through
    ``launch_divergent_batch`` no plan on the second call."""
    plans, keys = [], []
    for values in (0, 1):
        ids, ops = _case(name, seed=81 + values, values=values)
        seqs = _tseqs(ops)
        keys.append(flatten(seqs)[0])
        plans.append(kc.build_divergent_plan(seqs, ids))
        builds = executor.PLAN_BUILDS
        T.launch_divergent_batch(ids, *seqs, device="cpu")
        if values:
            assert executor.PLAN_BUILDS == builds
    assert keys[0] == keys[1]
    assert plans[0].head_words()[:] == plans[1].head_words()[:]
    assert np.array_equal(plans[0].tables, plans[1].tables)
    assert plans[0].n_block == plans[1].n_block


@pytest.mark.parametrize("name", cc.DIVERGENT_NESTED_NAMES)
def test_work_sums_the_groups(name):
    """``work()``: the batch's output bytes; the source sectors and the
    operations each group's own launch over its planes counts (a nested
    plane's core once per value its second level needs), summed. DVN2's
    top views are ragged: the batch reads 3 of their planes, their own
    launch all 4."""
    ids, ops = _case(name, seed=82)
    seqs = _tseqs(ops)
    a, got = _plain(ids, seqs)
    out_bytes, src, flops = kc.work(a)
    assert out_bytes == sum(t.numel() * t.element_size() for t in got)
    parts = []
    for g in a.plan.groups:
        pipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
        parts.append(kc.work(kc.prepare(pipe, kc.build_plan(pipe), CPU)))
    if name.startswith("dvn2"):
        assert parts[1][1] < src < sum(p[1] for p in parts)
        assert parts[1][2] < flops < sum(p[2] for p in parts)
    else:
        assert src == sum(p[1] for p in parts)
        assert flops == sum(p[2] for p in parts)


def _refusals():
    """``name -> (plane ids, sequences, what the refusal names)``: batches
    with a nested group that stay eager (a nested group beside a ring is
    the split kernel's: ``test_torch_divergent_split.py``)."""
    f = cc.divergent_nested_frames(83)
    cases = cc.divergent_nested_cases(T, f)
    tops = cases["dvn1_top_views_beside_letterboxes"][1][1]
    nv12_tops = cases["dvn4_nv12_top_views_beside_nv12_letterboxes"][1][1]
    seq = T.build_operation_sequence
    third = [T.resize(T.warp(T.resize(T.image(c), T.Size(32, 18)), cc.rotation((16, 9), 5.0),
                             T.Size(32, 18)), T.Size(16, 16)) for c in f["wide"]]
    return {
        "nested_nv12_beside_nested_images": ([1, 2] * 4, (seq(*tops), seq(*nv12_tops)),
                                             "NV12 planes run their own instance"),
        "a_third_resampling_node": ([1, 2] * 4, (seq(*tops), seq(T.batch_read(third),
                                                                 T.split_tensor())),
                                    "sequence 2: a third resampling node"),
        "nested_groups_of_different_outputs": ([1, 2] * 4, (seq(*tops), seq(
            T.batch_read([T.resize(T.warp(T.image(c), cc.top_view(64, 36), T.Size(64, 36),
                                          warp_type=T.WarpType.PERSPECTIVE), T.Size(16, 12))
                          for c in f["wide"]]), T.split_tensor())),
            "must stack"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_what_stays_eager_beside_a_nested_group(name):
    """Each refusal is an ``Unsupported`` naming why; AUTO keeps the eager
    merge and an explicit CUDA raises naming every route's reasons."""
    ids, seqs, why = _refusals()[name]
    with pytest.raises(kc.Unsupported, match=why):
        kc.build_divergent_plan(seqs, ids)
    assert executor._select_divergent(seqs, ids, T.ParBackend.AUTO, CUDA).backend == \
        "torch:divergent"
    with pytest.raises(ValueError, match=f"cuda:divergent: .*; cuda:composed:divergent: .*{why}"):
        executor._select_divergent(seqs, ids, T.ParBackend.CUDA, CUDA)


def test_the_c_entry_and_the_general_instances():
    """The nested C entry accepts a ``CM_DIVERGENT`` head and checks each
    plane's head by ``same_nested_instance`` and its store row; the general
    nested instances are ``launch_nested<AnyImage>`` in a file of their own,
    whose mixed body reads its plane's store row after the heads."""
    from cvgpuspeedup_tpu_torch.exec import _build

    csrc = _build.PACKAGE_DIR / "csrc"
    assert csrc / "composed_nested_divergent.cu" in _build.SOURCES
    assert "kc::launch_nested<kc::AnyImage>(a)" in (
        csrc / "composed_nested_divergent.cu").read_text()
    entry = (csrc / "composed_nested.cu").read_text().split("cvgs_composed_nested(")[1]
    assert "same_nested_instance(n, p)" in entry and "composed_nested_divergent(a)" in entry
    assert "n_planes * kc::kNestedWords + z" in entry
    body = (csrc / "composed_nested.cuh").read_text().split("void nested_mixed_body(")[1]
    assert "gridDim.z * kNestedWords + blockIdx.z" in body.split("nested_body<")[0]
