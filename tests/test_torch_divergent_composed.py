"""Divergent batches in one launch of the composed kernel, on the CPU: which
batches ``cuda_composed.build_divergent_plan`` takes, its plain version
against the JAX package and the port's eager merge, the plan's words, and
what stays eager and why.

- Routing, decided on the host: DV1-DV4 (``torch_composed_cases.
  divergent_cases``: letterboxes of 16:9 cameras beside warps of 4:3 ones;
  ROIs of a uint8 frame beside ROIs of a 12-bit uint16 sensor frame; a
  uint8 chain beside a ragged float32 group stored into a uint8 batch;
  ``crop_batch`` beside bordered crops) are refused by the divergent kernel
  (``cuda_divergent.build_plan``) and taken by the composed kernel's
  divergent plan: ``executor._select_divergent(..., cuda)`` names
  ``cuda:composed:divergent``; every batch the divergent kernel took keeps
  ``cuda:divergent``.
- Parity: each batch built with the JAX factories and carried across with
  ``from_jax``; the port's eager merge equals the reference's merge loop
  rebuilt outside jit from its ``lower_planes`` and ``apply`` bit for bit,
  and the reference's ``ParBackend.XLA`` ``launch_divergent_batch`` within
  1e-4 (float32) or 1 (uint8): XLA-CPU contracts FMAs (``ROADMAP.md`` §3);
  the kernel's plain version (``prepare`` and the wrapper on CPU tensors)
  equals the eager merge bit for bit, also with a group of each source
  dtype.
- The plan: each plane's head its group's, ``batch`` ``DIVERGENT``,
  ``plane_stride`` 0, its block offsets absolute (the block's words there
  are the plane's own values), each plane's store row after the heads;
  new values build no plan; ``work`` sums the groups'.
- Refusals: an NV12 group beside an image group, NV12 groups whose chains
  end in different dtypes, a resampling group beside a one-pixel group,
  groups of different output, groups converting YUV with different
  coefficients, a group the composed kernel refuses: each an
  ``Unsupported`` naming why; they stay eager, and ``ParBackend.CUDA``
  raises naming every route's reasons. A group of a kind only the
  divergent kernel reads (a ring, an image stack, ``resize_batch``)
  beside a composed group, one level or nested, is the split kernel's
  (``test_torch_divergent_split.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import flatten
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
import torch_composed_cases as cc

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # only named: the routing is decided on shapes
F32_TOL = 1e-4
DTYPES = ("uint8", "int8", "uint16", "int16", "float16", "float32", "int32", "int64", "float64")


def _tuple(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def _host(x):
    return tuple(np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for v in _tuple(x))


def _assert_equal(actual, expected, msg):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.shape == e.shape and a.dtype == e.dtype, (
            f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}")
        same = (np.array_equal(a.view(np.int32), e.view(np.int32)) if a.dtype == np.float32
                else np.array_equal(a, e))
        assert same, f"{msg}: not bit-equal, max |diff| {np.abs(a.astype(np.float64) - e).max()}"


def _assert_close(actual, expected, msg):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.shape == e.shape and a.dtype == e.dtype, (
            f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}")
        d = np.abs(a.astype(np.float64) - e.astype(np.float64)).max()
        assert d <= (1 if a.dtype == np.uint8 else F32_TOL), f"{msg}: max |diff| {d}"


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


def _jseqs(ops):
    return tuple(J.build_operation_sequence(*o) for o in ops)


def _tseqs(ops):
    return tuple(T.build_operation_sequence(*o) for o in ops)


def _plain(ids, seqs):
    plan = kc.build_divergent_plan(seqs, ids)
    a = kc.prepare(seqs, plan, CPU)
    return a, kc.composed(a)


def check(ids, jseqs, xla=True):
    """The port's eager merge against the reference op by op and its XLA
    merge, the plain version against the eager merge; the routing. Returns
    the port's sequences, the eager output and the launch."""
    tseqs = tuple(from_jax(s) for s in jseqs)
    eager = T.launch_divergent_batch(ids, *tseqs, device="cpu")
    assert T.last_backend() == "torch:divergent"
    _assert_equal(eager, reference_merge(ids, *jseqs), "eager vs the reference op by op")
    if xla:
        _assert_close(eager, J.launch_divergent_batch(ids, *jseqs, backend=J.ParBackend.XLA),
                      "eager vs the reference's XLA merge")
    a, got = _plain(ids, tseqs)
    _assert_equal(got, eager, "plain version vs eager")
    with pytest.raises(kd.Unsupported):
        kd.build_plan(tseqs, ids)
    for backend in (T.ParBackend.AUTO, T.ParBackend.CUDA):
        assert executor._select_divergent(tseqs, ids, backend, CUDA).backend == \
            "cuda:composed:divergent"
    return tseqs, eager, a


@pytest.mark.parametrize("values", [0, 1])
@pytest.mark.parametrize("name", cc.DIVERGENT_NAMES)
def test_a_divergent_batch_against_the_reference(name, values):
    ids, ops = cc.divergent_cases(J, cc.divergent_frames(51 + values), values)[name]
    check(ids, _jseqs(ops))


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_source_dtype_as_a_group(dtype):
    """DV2's regions of a uint8 frame beside those of a sensor frame of each
    source dtype (int64 and float64 as int32 and float32, as the reference
    reads them): bit for bit the reference op by op and the eager merge."""
    f = cc.divergent_frames(53, 1, dtype)
    ids, ops = cc.divergent_cases(J, f)["dv2_rois_of_two_sensors"]
    _, _, a = check(ids, _jseqs(ops))
    canonical = {"int64": "int32", "float64": "float32"}.get(dtype, dtype)
    assert [str(a.plan.for_plane(z).src_dtype)[6:] for z in (0, 1)] == ["uint8", canonical]


def test_the_plan_s_words():
    """Each plane's head is its group's for that plane (its base's size and
    core), ``batch`` DIVERGENT, ``plane_stride`` 0, in the consts HEAD_INTS
    words a plane from 0, then each plane's store row; the block's words at
    its offsets are its own values: DV1's border value and warp
    coefficients, DV2's crop origins, DV3's ragged group's ``used_planes``
    and default, a fused chain's and the pipeline chain's scalars."""
    f = cc.divergent_frames(55)
    cases = cc.divergent_cases(T, f)
    for name, (ids, ops) in cases.items():
        seqs = _tseqs(ops)
        a, _ = _plain(ids, seqs)
        plan, blk = a.plan, a.block
        fblk = blk.view(torch.float32)
        assert len(plan.planes) == plan.n_planes == len(ids)
        words = plan.tables[:plan.n_planes * kc.HEAD_INTS].reshape(plan.n_planes, -1)
        for z, q in enumerate(plan.planes):
            assert q.word("batch") == kc.DIVERGENT and q.word("plane_stride") == 0
            assert tuple(words[z]) == q.head
        assert tuple(plan.tables[plan.n_planes * kc.HEAD_INTS:][:plan.n_planes]) == plan.stores
        assert plan.head_words()[:] == [w for q in plan.planes for w in q.head] + \
            list(plan.stores)
        for g in plan.groups:
            seq = seqs[g.sid - 1]
            scalars = np.concatenate([np.asarray(v, np.float32).reshape(-1)
                                      for v in flatten(tuple(seq.compute))[1]])
            for z in g.planes:
                at = plan.for_plane(z).word("out_fp_off")
                assert np.array_equal(fblk[at:at + scalars.size].numpy(), scalars), (name, z)
    ids, ops = cases["dv1_letterboxes_and_warps"]
    a, _ = _plain(ids, _tseqs(ops))
    fblk = a.block.view(torch.float32)
    for z, sid in enumerate(ids):
        q = a.plan.for_plane(z)
        if sid == 1:  # the letterbox's outer CONSTANT border: 114
            (st,) = q.stage_list(2)
            assert float(fblk[st[6]]) == 114.0
        else:
            coeffs = a.pipeline[1].read.ops[z].coeffs
            assert np.array_equal(fblk[q.word("coef_off"):q.word("coef_off") + 6].numpy(),
                                  np.asarray(coeffs, np.float32).reshape(-1)[:6])
    ids, ops = cases["dv2_rois_of_two_sensors"]
    a, _ = _plain(ids, _tseqs(ops))
    for z, sid in enumerate(ids):
        (st,) = a.plan.for_plane(z).stage_list(0)
        crop = a.pipeline[sid - 1].read.ops[z].source
        assert (int(a.block[st[4]]), int(a.block[st[5]])) == (int(crop.x), int(crop.y))
    ids, ops = cases["dv3_store_casts_and_a_ragged_group"]
    a, _ = _plain(ids, _tseqs(ops))
    assert a.plan.stores == (0, kbr.store_cast(torch.float32, torch.uint8)) * 4
    assert a.plan.out_dtype == torch.uint8 and a.plan.layout == "packed"
    q = a.plan.for_plane(1)
    assert int(a.block[q.word("used_off")]) == 3
    assert float(a.block.view(torch.float32)[q.word("default_off")]) == np.float32(300.7)
    assert a.plan.for_plane(0).word("used_off") == -1
    # a fused chain's scalars at each plane's in_fp_off
    rng = np.random.default_rng(56)
    cams = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8) for _ in range(4)]
    seqs = _tseqs((
        (T.batch_read([T.resize(T.fuse(T.image(c), T.multiply(0.25 * (k + 1)), T.add(k)),
                                T.Size(8, 6)) for k, c in enumerate(cams)]), T.split_tensor()),
        (T.batch_read([T.resize(T.crop(T.image(c), T.Rect(k, 1, 12, 9)), T.Size(8, 6))
                       for k, c in enumerate(cams)]), T.split_tensor())))
    a, got = _plain([1, 2, 2, 1], seqs)
    _assert_equal(got, T.launch_divergent_batch([1, 2, 2, 1], *seqs, device="cpu"),
                  "fused group: plain version vs eager")
    fblk = a.block.view(torch.float32)
    for z in (0, 3):
        at = a.plan.for_plane(z).word("in_fp_off")
        assert fblk[at:at + 2].tolist() == [0.25 * (z + 1), z]


def _records(plan, head, block):
    """The fused chain's and the pipeline chain's rows as the kernel stages
    them from the consts (``test_torch_tiling.stage_rows``: code, aux,
    channels, scalars read from the block), and the resize's tap tables, of
    the plane head ``head`` (``kc.ComposedPlan.word``'s names)."""
    from test_torch_tiling import stage_rows

    words = dict(zip(kc._CORE_WORDS, head[3 * kc.kp.HEAD_INTS:]))
    fblk = block.view(torch.float32).numpy()
    out = []
    for n, ops, fp in (("in_n_ops", "in_ops_off", "in_fp_off"),
                       ("out_n_ops", "out_ops_off", "out_fp_off")):
        table = plan.tables[words[ops]:words[ops] + 5 * words[n] + 1]
        out.append([(c, a, ch, q.tolist()) for chunk in stage_rows(table, words[n],
                                                                   fblk[words[fp]:])
                    for c, a, ch, q in chunk])
    if words["core"] == kc.CORES.index("resize"):
        n = 3 * (words["core_w"] + words["core_h"])
        out.append(plan.tables[words["taps_off"]:words["taps_off"] + n].tolist())
    return out


@pytest.mark.parametrize("name", cc.DIVERGENT_NAMES)
def test_each_plane_stages_its_group_s_rows_and_taps(name):
    """The kernel reads a plane's op tables, its chain scalars and its tap
    tables at its head's offsets: from the divergent plan's consts and
    block, each plane's staged rows (code, aux, channels, scalars) and tap
    tables equal those its group's own launch over its planes reads (its
    one-geometry or mixed plan, held on the card since PRs 17 and 20)."""
    f = cc.divergent_frames(64)
    ids, ops = cc.divergent_cases(T, f)[name]
    seqs = _tseqs(ops)
    a, _ = _plain(ids, seqs)
    for g in a.plan.groups:
        pipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
        own = kc.prepare(pipe, kc.build_plan(pipe), CPU)
        for j, z in enumerate(g.planes):
            got = _records(a.plan, a.plan.for_plane(z).head, a.block)
            q = own.plan.for_plane(j)
            # the group's own head holds its plane 0's value offsets
            stride = j * q.word("plane_stride")
            head = kc._rebase(q, stride, 0) if stride else q.head
            want = _records(own.plan, head, own.block)
            assert got == want, (name, z)


@pytest.mark.parametrize("name", cc.DIVERGENT_NAMES)
def test_new_values_build_no_plan(name):
    """New frames of the same sizes, origins, angles, the border value and
    ``used_planes`` leave the batch's structure, and so its plan, as it
    was: the plan cache's key and the plan's words and tables are equal;
    through ``launch_divergent_batch`` no plan is built on the second
    call."""
    plans, keys = [], []
    for values in (0, 1):
        ids, ops = cc.divergent_cases(T, cc.divergent_frames(57 + values), values)[name]
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


@pytest.mark.parametrize("name", cc.DIVERGENT_NAMES)
def test_work_sums_the_groups(name):
    """``work()``: the batch's output bytes; the source sectors each group's
    own launch over its planes reads, a sector two groups read once (DV4's
    groups read one frame); the operations each group's planes take. A
    ragged group's own launch counts its ``used_planes`` over its planes,
    the batch over the batch's (DV3: plane 1 of the planes 1, 3, 5, 7 read,
    where the group alone reads 3)."""
    ids, ops = cc.divergent_cases(T, cc.divergent_frames(59, 2))[name]
    seqs = _tseqs(ops)
    a, got = _plain(ids, seqs)
    out_bytes, src, flops = kc.work(a)
    assert out_bytes == sum(t.numel() * t.element_size() for t in _tuple(got))
    parts = []
    for g in a.plan.groups:
        pipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
        parts.append(kc.work(kc.prepare(pipe, kc.build_plan(pipe), CPU)))
    if name.startswith("dv4"):  # one frame under both groups
        assert max(p[1] for p in parts) <= src < sum(p[1] for p in parts)
    elif name.startswith("dv3"):  # the ragged group reads 1 plane, its own launch 3
        assert parts[0][1] < src < sum(p[1] for p in parts)
    else:
        assert src == sum(p[1] for p in parts)
    if not name.startswith("dv3"):
        assert flops == sum(p[2] for p in parts)


def _k6_batches():
    rng = np.random.default_rng(60)
    stack = rng.integers(0, 256, (4, 8, 16, 3), dtype=np.uint8)
    frame = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    rects = np.array([[z, 2 * z, 20, 10] for z in range(4)], np.int32)
    imgs = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8) for _ in range(4)]
    bufs = [rng.integers(0, 256, (12, 16), dtype=np.uint8) for _ in range(4)]
    mats = [cc.rotation((12, 10), 10.0 * z, 1.1) for z in range(4)]
    f32 = T.convert_to(np.float32)
    seq = T.build_operation_sequence
    return {
        "ring_and_stack": ([1, 2, 1, 2], (
            seq(T.circular_batch_read(stack, first=-2), f32), seq(T.image(stack), f32))),
        "crop_resize_and_warps": ([2, 1, 1, 2], (
            seq(T.resize_batch(frame, rects=rects, dsize=T.Size(16, 8))),
            seq(T.warp_batch(imgs, mats, T.Size(16, 8), default=2.0)))),
        "nv12_and_images": ([1, 1, 2, 2], (
            seq(T.batch_read([T.resize(T.fuse(T.read_yuv(b), T.convert_yuv_to_rgb(
                out_dtype=np.float32)), T.Size(16, 8)) for b in bufs])),
            seq(T.batch_read([T.image(s) for s in stack]), f32))),
    }


def _chip_smoke_rows():
    """``chip_smoke.py``'s divergent rows D1-D4 and D14, which its phase 4
    drives through ``launch_divergent_batch`` on the card, over a small
    frame (the routing reads shapes alone)."""
    import chip_smoke

    frame = torch.from_numpy(np.random.default_rng(65).integers(0, 256, (300, 400, 3),
                                                                  dtype=np.uint8))
    rows = chip_smoke.DivergentRows(T, CPU, frame)
    return {**rows.timed(), "d14_ragged": rows.d14()}


@pytest.mark.parametrize("name", ["ring_and_stack", "crop_resize_and_warps", "nv12_and_images",
                                  "d1_circular_first3", "d2_nv12_bt709", "d3_crop_resize",
                                  "d4_warp_crop_pass", "d14_ragged"])
def test_the_divergent_kernel_keeps_its_batches(name):
    """A batch the divergent kernel takes keeps ``cuda:divergent``: it is
    tried first."""
    ids, seqs = (_chip_smoke_rows() if name[0] == "d" else _k6_batches())[name]
    kd.build_plan(seqs, ids)
    for backend in (T.ParBackend.AUTO, T.ParBackend.CUDA):
        assert executor._select_divergent(seqs, ids, backend, CUDA).backend == "cuda:divergent"


def _refusals():
    """``name -> (plane ids, sequences, what the refusal names)``: the
    batches that stay eager."""
    rng = np.random.default_rng(61)
    cams = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8) for _ in range(4)]
    bufs = [rng.integers(0, 256, (30, 24), dtype=np.uint8) for _ in range(4)]
    dst = T.Size(8, 6)
    seq = T.build_operation_sequence
    f32 = T.convert_to(np.float32, alpha=1 / 255.0)
    resized = seq(T.batch_read([T.resize(T.image(c), dst) for c in cams]), T.split_tensor())

    def rgb(b, conv=None):
        return T.fuse(T.read_yuv(b), conv or T.convert_yuv_to_rgb(out_dtype=np.uint8))

    return {
        "nv12_beside_images": ([1, 2, 1, 2], (resized, seq(T.batch_read(
            [T.resize(rgb(b), dst) for b in bufs]), f32, T.split_tensor())),
            "NV12 planes run their own instance"),
        "nv12_groups_of_two_dtypes": ([1, 2, 1, 2], (
            seq(T.batch_read([T.make_border(T.resize(rgb(b), T.Size(8, 4)), 1, 1, 0, 0,
                                            T.BorderMode.CONSTANT, 114.0) for b in bufs]),
                T.convert_to(np.uint8), T.split_tensor()),
            seq(T.batch_read([T.resize(rgb(b), dst) for b in bufs]), f32, T.split_tensor())),
            "NV12 groups whose chains end in torch.uint8 and torch.float32"),
        "resample_beside_one_pixel": ([1, 2, 1, 2], (resized, seq(T.crop_batch(
            T.image(cams[0]), [T.Rect(z, z, 8, 6) for z in range(4)]), f32,
            T.split_tensor())), "resampling group beside a one-pixel group"),
        "different_outputs": ([1, 2, 1, 2], (resized, seq(T.batch_read(
            [T.resize(T.image(c), T.Size(8, 7)) for c in cams]), T.split_tensor())),
            "must stack"),
        "different_conversions": ([1, 2, 1, 2], (
            seq(T.batch_read([T.resize(rgb(b), dst) for b in bufs]), T.split_tensor()),
            seq(T.batch_read([T.resize(T.crop(rgb(b, T.convert_yuv_to_rgb(
                standard=T.ColorStandard.BT709, out_dtype=np.uint8)), T.Rect(0, 0, 20, 16)),
                dst) for b in bufs]), T.split_tensor())), "different coefficients"),
        "a_group_the_composed_kernel_refuses": ([1, 2, 1, 2], (resized, seq(T.batch_read(
            [T.resize(T.warp(T.resize(T.image(c), T.Size(16, 12)), cc.rotation((8, 6), 5.0),
                             T.Size(16, 12)), dst) for c in cams]), T.split_tensor())),
            "sequence 2: a third resampling node"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_what_stays_eager_and_why(name):
    """Each refusal is an ``Unsupported`` naming why; the batch keeps the
    eager merge under AUTO, which runs it on the CPU, and an explicit CUDA
    raises naming every route's reasons."""
    ids, seqs, why = _refusals()[name]
    with pytest.raises(kc.Unsupported, match=why):
        kc.build_divergent_plan(seqs, ids)
    assert executor._select_divergent(seqs, ids, T.ParBackend.AUTO, CUDA).backend == \
        "torch:divergent"
    with pytest.raises(ValueError, match=f"cuda:divergent: .*; cuda:composed:divergent: .*{why}"):
        executor._select_divergent(seqs, ids, T.ParBackend.CUDA, CUDA)
    if name == "different_outputs":  # the eager merge raises too, as the reference's scatter
        with pytest.raises(ValueError, match="gives planes of"):
            T.launch_divergent_batch(ids, *seqs, device="cpu")
        return
    T.launch_divergent_batch(ids, *seqs, device="cpu")
    assert T.last_backend() == "torch:divergent"


def test_a_heterogeneous_batch_read_through_execute_operations_stays_as_it_is():
    """A ``batch_read`` whose planes differ in structure is not a divergent
    batch: ``execute_operations`` keeps it eager, as before."""
    rng = np.random.default_rng(62)
    cams = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8) for _ in range(2)]
    dst = T.Size(8, 6)
    ops = (T.batch_read([T.resize(T.image(cams[0]), dst),
                         T.warp(T.image(cams[1]), cc.rotation((12, 10), 5.0), dst)]),
           T.split_tensor())
    assert executor._select(T.build_pipeline(*ops), T.ParBackend.AUTO, CUDA).backend == "torch"


def test_the_plain_version_raises_for_out():
    ids, ops = cc.divergent_cases(T, cc.divergent_frames(63))["dv4_one_pixel_groups"]
    seqs = _tseqs(ops)
    a = kc.prepare(seqs, kc.build_divergent_plan(seqs, ids), CPU)
    with pytest.raises(ValueError, match="no out="):
        kc.composed(a, out=torch.empty(8, 3, 16, 16))
