"""Divergent batches split between the divergent kernel's body and the
composed kernel's in one launch (``cuda:divergent:split``), on the CPU:
which batches ``cuda_divergent_split.build_split_plan`` takes, its plain
version against the JAX package and the port's eager merge, the plan's
words, and what still stays eager and why.

- Parity: DK1-DK4 (``torch_composed_cases.split_cases``: a ring beside
  letterboxes, ascending from a negative ``first`` and descending;
  ``resize_batch`` of a frame beside warps of crops; ``resize_batch`` of a
  stack beside a 12-bit sensor's ROIs; NV12 reads of the divergent
  kernel's kind beside top views), a ragged group in each part, store
  casts both ways (a float32 part into a uint8 batch, a uint8 part into a
  float32 batch), a staged part into a uint16 batch and a FusedRead2 part
  into a float16 one, a ring of int8, uint16 and float16, and the three
  batches ``test_torch_divergent_composed.py`` kept eager before this
  route; each built with the JAX factories and carried across with
  ``from_jax``: the port's eager merge equals the reference's
  ``ParBackend.XLA`` merge within 1e-4 (integer outputs exactly) and, for
  DK1, its merge loop rebuilt outside jit bit for bit; the plain version equals the eager
  merge bit for bit, and the composed part's own plain version, computed
  from its words and the block (``cuda_composed.composed_reference``),
  equals it on the part's planes. Each group's chain ends in the batch's
  dtype where the reference's merge would promote (``ROADMAP.md`` §3).
- The routing: neither the divergent kernel nor the composed kernel's
  divergent plan takes these batches; ``executor._select_divergent``
  names ``cuda:divergent:split``.
- The plan: the part table (K6's table, FOREIGN at the composed part's
  planes), K6's descriptors, the composed heads and store rows at its
  planes alone, the consts and the block of both parts; new values build
  no plan; ``work`` sums the parts.
- The launch's geometry (``csrc/divergent_split.cuh``): each part's plane
  list in the consts, its tiles (``SplitPlan.tiles``: K6's part at
  ``group_block``'s 64 x 4, the composed part at its form's tile), the
  composed part's source kind and the instance it names, and a Python
  decoder of each block's part, plane and tile, as the kernel decodes
  them, covering every output pixel exactly once; every output element
  type through the run-time store.
- Refusals: a group no part takes, an empty part, an NV12 group that would
  fall to the composed part, a part that breaks its own rules, parts that
  do not stack: each an ``Unsupported`` naming why; ``ParBackend.CUDA``
  raises naming all three routes' reasons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_divergent_split as ks
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import flatten
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
import torch_composed_cases as cc

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # only named: the routing is decided on shapes
F32_TOL = 1e-4
ROUTE = "cuda:divergent:split"


def _tuple(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def _host(x):
    return tuple(np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for v in _tuple(x))


def _assert_equal(actual, expected, msg):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.shape == e.shape and a.dtype == e.dtype, (
            f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}")
        same = (np.array_equal(a.view(np.int32), e.view(np.int32)) if a.dtype == np.float32
                else np.array_equal(a.view(np.int16), e.view(np.int16)) if a.dtype == np.float16
                else np.array_equal(a, e))
        assert same, f"{msg}: not bit-equal, max |diff| {np.abs(a.astype(np.float64) - e).max()}"


def _assert_close(actual, expected, msg):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.shape == e.shape and a.dtype == e.dtype, (
            f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}")
        d = np.abs(a.astype(np.float64) - e.astype(np.float64)).max()
        assert d <= (F32_TOL if a.dtype.kind == "f" else 0), f"{msg}: max |diff| {d}"


def reference_merge(ids, *seqs):
    """The reference's merge loop (``executor.py:364-381``) outside jit:
    each sequence's own ``lower_planes`` and ``apply``, op by op."""
    groups = {}
    for z, sid in enumerate(ids):
        groups.setdefault(sid, []).append(z)
    merged = None
    for sid, planes in groups.items():
        s = seqs[sid - 1]
        x = s.read.lower_planes(tuple(planes))
        for o in s.compute:
            x = o.apply(x)
        if merged is None:
            merged = jnp.zeros((len(ids),) + x.shape[1:], dtype=x.dtype)
        merged = merged.at[jnp.asarray(planes)].set(x)
    return seqs[0].write.write(merged)


def _tseqs(ops):
    return tuple(T.build_operation_sequence(*o) for o in ops)


def check(ids, jseqs, xla=True, op_by_op=False):
    """The port's eager merge against the reference's XLA merge (and, with
    ``op_by_op``, its merge loop op by op: seconds a case, each region's
    shape compiled anew, so DK1's alone); the plain version and the
    composed part's plain version from its words against the eager merge;
    the routing. Returns the port's sequences and the launch."""
    tseqs = tuple(from_jax(s) for s in jseqs)
    eager = T.launch_divergent_batch(ids, *tseqs, device="cpu")
    assert T.last_backend() == "torch:divergent"
    if op_by_op:
        _assert_equal(eager, reference_merge(ids, *jseqs), "eager vs the reference op by op")
    if xla:
        _assert_close(eager, J.launch_divergent_batch(ids, *jseqs, backend=J.ParBackend.XLA),
                      "eager vs the reference's XLA merge")
    plan = ks.build_split_plan(tseqs, ids)
    a = ks.prepare(tseqs, plan, CPU)
    _assert_equal(ks.divergent_split(a), eager, "plain version vs eager")
    mine = np.flatnonzero(plan.parts).tolist()  # the composed part's planes
    for got, want in zip(_tuple(kc.composed_reference(a.composed)), _tuple(eager), strict=True):
        axis = 1 if plan.layout in ("tsplit", "split_write") else 0
        _assert_equal(got.index_select(axis, torch.tensor(mine)),
                      want.index_select(axis, torch.tensor(mine)),
                      "the composed part from its words vs eager, on its planes")
    with pytest.raises(kd.Unsupported):
        kd.build_plan(tseqs, ids)
    with pytest.raises(kc.Unsupported):
        kc.build_divergent_plan(tseqs, ids)
    for backend in (T.ParBackend.AUTO, T.ParBackend.CUDA):
        assert executor._select_divergent(tseqs, ids, backend, CUDA).backend == ROUTE
    return tseqs, a


@pytest.mark.parametrize("values", [0, 1])
@pytest.mark.parametrize("name", cc.SPLIT_NAMES)
def test_dk_against_the_reference(name, values):
    ids, ops = cc.split_cases(J, cc.split_frames(81 + values), values, (name,))[name]
    check(ids, tuple(J.build_operation_sequence(*o) for o in ops), op_by_op=name.startswith("dk1"))


@pytest.mark.parametrize("name", cc.SPLIT_MORE)
def test_more_split_batches_against_the_reference(name):
    """A descending ring, ragged groups, store casts both ways, a staged
    part, a FusedRead2 part, and the batches kept eager before."""
    ids, ops = cc.split_cases(J, cc.split_frames(83), 1, (name,))[name]
    _, a = check(ids, tuple(J.build_operation_sequence(*o) for o in ops))
    want = {"dk6": "one_pixel", "dk8": "staged", "dk9": "fused2", "nest": "per_tap"}
    assert a.plan.form == want.get(name[:3] if name[:2] == "dk" else name[:4], a.plan.form)


@pytest.mark.parametrize("dtype", ["int8", "uint16", "float16"])
def test_a_ring_of_another_dtype(dtype):
    """DK1 with its ring of int8, uint16 and float16, its chain ending in
    the batch's float32."""
    name = "dk1_ring_beside_letterboxes"
    ids, ops = cc.split_cases(J, cc.split_frames(84, dtype), 0, (name,))[name]
    _, a = check(ids, tuple(J.build_operation_sequence(*o) for o in ops))
    assert a.plan.k6.groups[0].src_dtype == getattr(torch, dtype) and a.plan.k6.general


def test_the_plan_s_words():
    """DK1's plan: the part table (the ring's planes 0, 2, 4, 6 K6's, the
    letterboxes' the composed part's); K6's table with FOREIGN at the
    composed part's planes, its descriptor's ``first``; the composed heads
    and store rows at its planes alone (zeros at K6's), each with batch
    DIVERGENT and its source address, 0 at K6's planes; the consts of both
    parts at their offsets; the head words the C entry takes."""
    name = "dk1_ring_beside_letterboxes"
    ids, ops = cc.split_cases(T, cc.split_frames(85), 0, (name,))[name]
    seqs = _tseqs(ops)
    plan = ks.build_split_plan(seqs, ids)
    a = ks.prepare(seqs, plan, CPU)
    n, width = plan.n_planes, kc.HEAD_INTS
    assert ks.partition(seqs, ids) == ((1,), (2,))
    assert plan.parts.tolist() == [0, 1] * 4
    assert plan.k6.table.tolist() == [0, kd.FOREIGN] * 4
    assert [g.kind for g in plan.k6.groups] == ["circ"]
    heads = plan.composed.tables[:n * width].reshape(n, width)
    for z in range(n):
        if plan.parts[z]:
            q = plan.composed.for_plane(z)
            assert tuple(heads[z]) == q.head and q.word("batch") == kc.DIVERGENT
        else:
            assert not heads[z].any() and plan.composed.for_plane(z) is None
    assert not plan.composed.tables[n * width:n * (width + 1)].any()  # float32 all through
    assert plan.head_words()[:] == plan.composed.tables[:n * (width + 1)].tolist()
    assert np.array_equal(plan.consts[:plan.k6.consts.size], plan.k6.consts)
    assert plan.cm_consts_off % 4 == 0 and np.array_equal(
        plan.consts[plan.cm_consts_off:], plan.composed.tables)
    # the one block: K6's part, then the composed part's at cm_off
    assert a.cm_off % 4 == 0 and a.block.numel() == a.cm_off + plan.composed.n_block
    desc = a.block[a.k6.desc_off:a.k6.desc_off + kd.DESC_INTS].tolist()
    assert desc[0] == kd.KINDS.index("circ") and int(a.block[desc[6]]) == 3
    addrs = a.block[a.cm_off:a.cm_off + 2 * n].view(torch.int64).tolist()
    assert [bool(v) for v in addrs] == [bool(p) for p in plan.parts]
    # a letterbox's border value at its plane's head offset in the composed block
    q = plan.composed.for_plane(1)
    (st,) = q.stage_list(2)
    assert float(a.block[a.cm_off:].view(torch.float32)[st[6]]) == 114.0


def test_the_batch_takes_plane_0_s_dtype_in_either_part():
    """DK6: plane 0's group is K6's (a uint8 ring), so the composed part's
    float32 group stores through its row into the uint8 batch; DK7: plane
    0's group is the composed part's (float32 letterboxes), so K6's uint8
    ring is stored into the float32 batch (by the store: no row)."""
    cases = cc.split_cases(T, cc.split_frames(86), 0, ("dk6_float_part_into_a_u8_batch",
                                                      "dk7_integer_part_into_a_f32_batch"))
    ids, ops = cases["dk6_float_part_into_a_u8_batch"]
    plan = ks.build_split_plan(_tseqs(ops), ids)
    assert plan.out_dtype == plan.composed.out_dtype == torch.uint8
    assert set(plan.composed.stores) == {0, kc.store_cast(torch.float32, torch.uint8)}
    ids, ops = cases["dk7_integer_part_into_a_f32_batch"]
    plan = ks.build_split_plan(_tseqs(ops), ids)
    assert plan.out_dtype == plan.k6.out_dtype == torch.float32
    assert set(plan.composed.stores) == {0}
    # a uint8 value needs no row for a float32 buffer: the store converts it
    (g,) = plan.k6.groups
    assert kc.store_cast(torch.uint8, torch.float32) == 0 and g.n_ops == 0


@pytest.mark.parametrize("name", cc.SPLIT_NAMES + ("dk5_ragged_groups",))
def test_new_values_build_no_plan(name):
    """New frames, ``first``, rects, matrices, origins, border values and
    ``used_planes`` leave the structure and the plan as they were."""
    plans, keys = [], []
    for values in (0, 1):
        ids, ops = cc.split_cases(T, cc.split_frames(87 + values), values, (name,))[name]
        seqs = _tseqs(ops)
        keys.append(flatten(seqs)[0])
        plans.append(ks.build_split_plan(seqs, ids))
    assert keys[0] == keys[1]
    assert np.array_equal(plans[0].consts, plans[1].consts)
    assert plans[0].head_words()[:] == plans[1].head_words()[:]
    assert plans[0].composed.n_block == plans[1].composed.n_block
    assert np.array_equal(plans[0].k6.table, plans[1].k6.table)


@pytest.mark.parametrize("name", cc.SPLIT_NAMES)
def test_work_sums_the_parts(name):
    """``work()``: the batch's output bytes; K6's part's source bytes (its
    groups alone) beside the composed part's sectors, which equal its
    group's own launch over its planes; the operations of each part."""
    ids, ops = cc.split_cases(T, cc.split_frames(89), 0, (name,))[name]
    seqs = _tseqs(ops)
    plan = ks.build_split_plan(seqs, ids)
    a = ks.prepare(seqs, plan, CPU)
    out_bytes, src, flops = ks.work(a)
    got = _tuple(ks.divergent_split(a))
    assert out_bytes == sum(t.numel() * t.element_size() for t in got)
    k6, cm = kd.work(a.k6), kc.work(a.composed)
    assert (out_bytes, src, flops) == tuple(x + y for x, y in zip(k6, cm))
    assert k6[0] == cm[0] == out_bytes // 2  # four planes each
    (g,) = plan.composed.groups
    pipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
    own = kc.work(kc.prepare(pipe, kc.build_plan(pipe), CPU))
    assert cm[1:] == own[1:]
    assert k6[1] > 0 and k6[2] == 14 * out_bytes // 2 // plan.out_dtype.itemsize


def _refusals():
    """``name -> (plane ids, sequences, what the split route's refusal
    names)``: batches no route takes, and batches the other routes take."""
    f = cc.split_frames(90)
    cases = cc.split_cases(T, f, 0, ("dk1_ring_beside_letterboxes", "dk5_ragged_groups"))
    seq = T.build_operation_sequence
    ring_ids, ring_ops = cases["dk1_ring_beside_letterboxes"]
    ring = seq(*ring_ops[0])
    boxes = seq(*ring_ops[1])
    ragged_boxes = seq(*cases["dk5_ragged_groups"][1][1])  # 12x12
    wide, big = f["wide"], f["big"]
    dst = T.Size(16, 16)
    third_node = seq(T.batch_read([T.resize(T.warp(T.resize(T.image(c), T.Size(32, 18)),
                                                   cc.rotation((16, 9), 5.0), T.Size(32, 18)),
                                            dst) for c in wide]), T.convert_to(np.float32),
                     T.split_tensor())
    nv12_u8 = seq(T.batch_read([T.resize(T.fuse(T.read_yuv(b), T.convert_yuv_to_rgb(
        out_dtype=np.uint8)), dst) for b in f["nv12"]]), T.convert_to(np.float32),
        T.split_tensor())
    crops = seq(T.crop_batch(T.image(big), [T.Rect(k, k, 16, 16) for k in range(8)]),
                T.convert_to(np.float32), T.split_tensor())
    stack = seq(T.image(f["stack"][:, :16, :16].copy()), T.convert_to(np.float32),
                T.split_tensor())
    dv_ids, dv_ops = cc.divergent_cases(T, cc.divergent_frames(91))["dv1_letterboxes_and_warps"]
    return {
        "a_group_no_part_takes": ([1, 2] * 4, (ring, third_node),
                                  "sequence 2: neither part takes it"),
        "an_nv12_group_k6_refuses": ([1, 2] * 4, (ring, nv12_u8),
                                     "NV12 group the divergent kernel refuses"),
        "no_k6_part": (dv_ids, _tseqs(dv_ops), "no group of a kind only the divergent kernel"),
        "no_composed_part": ([1, 2] * 4, (ring, stack), "every group is of a kind the "
                                                        "divergent kernel reads"),
        "the_composed_part_s_own_rules": ([1, 2, 3, 1, 2, 3, 1, 2], (ring, boxes, crops),
                                          "the composed part: .*resampling group beside a "
                                          "one-pixel group"),
        "parts_that_do_not_stack": ([1, 2] * 4, (ring, ragged_boxes), "must stack"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_what_the_split_route_refuses_and_why(name):
    """Each refusal is an ``Unsupported`` naming why; a batch no route
    takes keeps the eager merge under AUTO and raises under CUDA, naming
    all three routes' reasons; a batch another route takes keeps it."""
    ids, seqs, why = _refusals()[name]
    with pytest.raises(ks.Unsupported, match=why):
        ks.build_split_plan(seqs, ids)
    backend = executor._select_divergent(seqs, ids, T.ParBackend.AUTO, CUDA).backend
    if name == "no_k6_part":
        assert backend == "cuda:composed:divergent"
        return
    if name == "no_composed_part":
        assert backend == "cuda:divergent"
        return
    assert backend == "torch:divergent"
    with pytest.raises(ValueError, match=f"cuda:divergent: .*; cuda:composed:divergent: .*; "
                                         f"{ROUTE}: .*{why}"):
        executor._select_divergent(seqs, ids, T.ParBackend.CUDA, CUDA)
    if name != "parts_that_do_not_stack":  # the eager merge raises there, as the reference's
        T.launch_divergent_batch(ids, *seqs, device="cpu")
        assert T.last_backend() == "torch:divergent"


def test_the_other_routes_keep_their_batches():
    """DV1-DV4 keep ``cuda:composed:divergent`` and K6's batches
    ``cuda:divergent``: the split route is tried after both, and refuses
    them on its own (a part would be empty)."""
    for name, (ids, ops) in cc.divergent_cases(T, cc.divergent_frames(92)).items():
        seqs = _tseqs(ops)
        assert executor._select_divergent(seqs, ids, T.ParBackend.AUTO, CUDA).backend == \
            "cuda:composed:divergent", name
        with pytest.raises(ks.Unsupported, match="no group of a kind only"):
            ks.build_split_plan(seqs, ids)


NAMES = cc.SPLIT_NAMES + cc.SPLIT_MORE
#: the composed part's source kind of each split batch: uint8 images with
#: one store row, else any (the general AnyImage body)
KIND = {**{name: "uint8" for name in NAMES},
        "dk3_stack_resized_beside_sensor_rois": "any",
        "dk10_two_sources_in_the_composed_part": "any"}


def _plan(name, f=None):
    ids, ops = cc.split_cases(T, f or cc.split_frames(93), 0, (name,))[name]
    seqs = _tseqs(ops)
    return seqs, ids, ks.build_split_plan(seqs, ids)


def _large(dtype=np.float32):
    ids, ops = cc.split_large(T, dtype)
    seqs = _tseqs(ops)
    return seqs, ids, ks.build_split_plan(seqs, ids)


@pytest.mark.parametrize("name", NAMES)
def test_the_plane_lists_and_the_tiles(name):
    """The plane lists (K6's planes in order, then the composed part's) in
    the consts, ending where the composed part's consts start, after K6's;
    each part's tiles as the C entry chooses them on an H100."""
    _, _, plan = _plan(name)
    n, parts = plan.n_planes, plan.parts
    k6, cm = np.flatnonzero(parts == 0).tolist(), np.flatnonzero(parts == 1).tolist()
    assert plan.lists.tolist() == k6 + cm
    at = plan.cm_consts_off - -(-n // 4) * 4
    assert at % 4 == 0 and at >= plan.k6.consts.size
    assert plan.consts[at:at + n].tolist() == k6 + cm and not plan.consts[at + n:at + -(-n // 4) * 4].any()
    assert np.array_equal(plan.consts[:plan.k6.consts.size], plan.k6.consts)
    assert np.array_equal(plan.consts[plan.cm_consts_off:], plan.composed.tables)
    kt, ct = plan.tiles()
    w, h = plan.dsize
    assert (kt.planes, kt.list, ct.planes, ct.list) == (len(k6), 0, len(cm), len(k6))
    assert (kt.bw, kt.bh) == ks.GROUP == (64, 4)
    assert (ct.bw, ct.bh) == (kc.TILE2 if plan.form in ("per_tap", "staged") else (64, 4))
    for p in (kt, ct):
        assert p.tiles_x == -(-w // p.bw) and p.tiles == p.tiles_x * -(-h // p.bh)
        assert p.blocks == p.planes * p.tiles


def test_a_large_batch_s_tiles():
    """A ring of 8 planes of 241x403 beside cameras resized to it: each
    part 4 planes of 7 x 61 tiles of 64 x 4 threads, the last column of
    tiles 13 pixels wide."""
    _, _, plan = _large()
    kt, ct = plan.tiles()
    assert kt == ks.PartTiles(4, 7, 7 * 61, 64, 4, 0)
    assert ct == ks.PartTiles(4, 7, 7 * 61, 64, 4, 4) and plan.form == "resample"


@pytest.mark.parametrize("name", NAMES)
def test_the_composed_part_s_source_kind_and_instance(name):
    """The composed part's source kind as the C entry reads it from the
    heads it takes (each plane of the part an image of uint8, one store
    row), and the instance ``instance`` names: the form x the kind."""
    _, _, plan = _plan(name)
    width = kc.NESTED_INTS if plan.nested else kc.HEAD_INTS
    words = np.asarray(plan.head_words()[:])
    n, mine = plan.n_planes, np.flatnonzero(plan.parts)
    heads = words[:n * width].reshape(n, width)[mine]
    rows = words[n * width:n * (width + 1)][mine]
    u8 = ((heads[:, 0] != kp.BASES.index("yuv")) & (heads[:, 4] == kp.SRC_CODES[torch.uint8])
          ).all() and len(set(rows.tolist())) == 1
    assert plan.kind == ("uint8" if u8 else "any") == KIND[name]
    src = {"uint8": "unsigned char", "any": "AnyImage"}[KIND[name]]
    assert ks.instance(plan) == {
        "one_pixel": f"divergent_split_kernel<{src}, 1>",
        "resample": f"divergent_split_kernel<{src}, 4>",
        "fused2": f"divergent_split_nested<{src}, false>",
        "per_tap": f"divergent_split_nested<{src}, true>",
        "staged": f"divergent_split_nested_staged<{src}>"}[plan.form]


def test_two_store_rows_take_the_general_body():
    """DK6 with a second composed group whose uint8 values need no row into
    the uint8 batch, beside the float32 one's saturating row: two store
    rows, so the general body, which reads each plane's."""
    f = cc.split_frames(95)
    ids, ops = cc.split_cases(T, f, 0, ("dk6_float_part_into_a_u8_batch",))[
        "dk6_float_part_into_a_u8_batch"]
    crops = ops[1][0]
    seqs = _tseqs((*ops, (crops, T.write_tensor())))
    plan = ks.build_split_plan(seqs, [1, 2, 3] * 2 + [1, 2])
    assert len({plan.composed.stores[z] for z in np.flatnonzero(plan.parts)}) == 2
    assert plan.kind == "any" and ks.instance(plan) == "divergent_split_kernel<AnyImage, 1>"


def _blocks(plan):
    """Each output pixel's count of the threads that write it and the part
    of the blocks that write each plane, as csrc/divergent_split.cuh decodes
    a block of the 1-D grid (k6_block, part_tile, tile_place, k6_part and
    the composed bodies' pixel): K6's part's blocks first, then the
    composed part's; a block's part by its index against K6's part's
    blocks, its plane from the part's list, its tile, each thread's
    pixel."""
    k6, cm = plan.tiles()
    lists = plan.lists
    w, h = plan.dsize
    cover = np.zeros((plan.n_planes, h, w), np.int64)
    part = np.full(plan.n_planes, -1)
    for b in range(k6.blocks + cm.blocks):
        p = k6 if b < k6.blocks else cm
        local = b if b < k6.blocks else b - k6.blocks
        plane, t = divmod(local, p.tiles)
        by, bx = divmod(t, p.tiles_x)
        z = int(lists[p.list + plane])
        ty, tx = np.divmod(np.arange(256), p.bw)
        y, x = by * p.bh + ty, bx * p.bw + tx
        on = (x < w) & (y < h)
        np.add.at(cover, (z, y[on], x[on]), 1)
        assert part[z] in (-1, int(p is cm)), (z, part[z])
        part[z] = int(p is cm)
    return cover, part


@pytest.mark.parametrize("name", NAMES + ("large",))
def test_the_blocks_cover_every_pixel_once(name):
    """Decoded block by block, the launch writes every output pixel of
    every plane exactly once, each plane by its own part's blocks."""
    _, _, plan = _large() if name == "large" else _plan(name)
    cover, part = _blocks(plan)
    assert (cover == 1).all(), np.argwhere(cover != 1)[:5]
    assert part.tolist() == plan.parts.tolist()


@pytest.mark.parametrize("dtype", cc.SPLIT_OUT_DTYPES)
def test_every_output_type_takes_the_split_plan(dtype):
    """A ring of each output element type beside letterboxes converted into
    it: one split plan (the uint8 body, one store row), a batch of that
    dtype, the plain version equal to the eager merge."""
    ids, ops = cc.split_ring_beside_letterboxes(T, cc.split_frames(96), dtype)
    seqs = _tseqs(ops)
    plan = ks.build_split_plan(seqs, ids)
    assert plan.out_dtype == getattr(torch, dtype) and plan.kind == "uint8"
    eager = T.launch_divergent_batch(ids, *seqs, device="cpu")
    _assert_equal(ks.divergent_split(ks.prepare(seqs, plan, CPU)), eager, dtype)
