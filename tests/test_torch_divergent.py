"""The divergent slice (``build_operation_sequence``,
``launch_divergent_batch``, the divergent kernel's plan, parameter block and
plain version): the port against the JAX package.

Each batch is built with the JAX package's factories and carried across
with ``from_jax``. The port runs it through the eager merge
(``launch_divergent_batch`` on CPU tensors) and through the kernel's wrapper
on CPU tensors, which gathers the parameter block with ``prepare`` and runs
the plain version.

Tolerances:

- the port equals the reference's merge loop (``executor.py:364-381``)
  rebuilt here outside jit from the JAX package's own ``lower_planes`` and
  ``apply`` (its op-by-op lowering) bit for bit, and the kernel's plain
  version equals the port's eager output bit for bit;
- against the reference's jitted ``ParBackend.XLA`` merge, float32 within
  1e-4 and uint8 within 1: XLA-CPU contracts lerps and ``x*a + b`` into
  FMAs (ROADMAP §3);
- against the reference's Pallas divergent kernel in interpret mode, where
  the JAX tests call it, within 1e-4. Its NV12 groups resize by
  ``axis_lerp`` taps where the port follows ``ResizeRead``'s edge rule, and
  its warp groups can be stale when a bake meets a new source size
  (ADVICE r5), so that case is held against the XLA merge only.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from conftest import assert_backend
from cvgpuspeedup_tpu.exec import pallas_divergent as pd
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import flatten
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.ops.resize import axis_taps

F32_TOL = 1e-4
CPU = torch.device("cpu")


def _rng(seed):
    return np.random.default_rng(seed)


def rotation(center, angle, scale):
    """``cv2.getRotationMatrix2D``."""
    a = math.radians(angle)
    al, be = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])


def _tuple(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def _host(x):
    return tuple(np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for v in _tuple(x))


def _assert_equal(actual, expected, msg):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.shape == e.shape and a.dtype == e.dtype, (
            f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}")
        assert np.array_equal(a, e), (
            f"{msg}: not bit-equal, max |diff| {np.abs(a.astype(np.float64) - e).max()}")


def _assert_close(actual, expected, msg, tol=F32_TOL):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.shape == e.shape and a.dtype == e.dtype, (
            f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}")
        d = np.abs(a.astype(np.float64) - e.astype(np.float64)).max()
        assert d <= (1 if a.dtype == np.uint8 else tol), f"{msg}: max |diff| {d}"


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


def check_divergent(ids, *jseqs, pallas=False, kinds=None):
    """Run a divergent batch in the JAX package (op by op, the jitted XLA
    merge and, with ``pallas``, its Pallas kernel in interpret mode) and in
    both port versions; returns the port's eager output and its plan."""
    tseqs = tuple(from_jax(s) for s in jseqs)
    eager = T.launch_divergent_batch(ids, *tseqs, device="cpu")
    assert T.last_backend() == "torch:divergent"
    _assert_equal(eager, reference_merge(ids, *jseqs), "eager vs the reference op by op")
    _assert_close(eager, J.launch_divergent_batch(ids, *jseqs, backend=J.ParBackend.XLA),
                  "eager vs the reference's XLA merge")
    plan = kd.build_plan(tseqs, ids)
    if kinds is not None:
        assert [g.kind for g in plan.groups] == kinds
    _assert_equal(kd.run(tseqs, plan, CPU), eager, "kernel plain version vs eager")
    if pallas:
        got = pd.try_lower(list(jseqs), list(ids), interpret=True)
        assert got is not None, "the Pallas divergent kernel did not take the batch"
        _assert_close(eager, jseqs[0].write.write(got), "eager vs the reference's Pallas K6")
    return eager, plan


# --- the reference's divergent tests (tests/test_nv12_divergent.py) ----------


def test_two_sequences_by_selector():
    data = _rng(1).integers(0, 200, (6, 10, 12, 3)).astype(np.float32)
    seq1 = J.build_operation_sequence(J.image(data), J.add(3.0), J.split_tensor())
    seq2 = J.build_operation_sequence(J.image(data), J.split_tensor())
    ids = [1 if z % 2 == 0 else 2 for z in range(6)]
    out, _ = check_divergent(ids, seq1, seq2, kinds=["image", "image"])
    assert tuple(out.shape) == (6, 3, 10, 12)
    # a callable selector routes the same way
    tseqs = (from_jax(seq1), from_jax(seq2))
    again = T.launch_divergent_batch(lambda z: 1 if z % 2 == 0 else 2, *tseqs, device="cpu")
    _assert_equal(again, out, "callable selector vs id list")


def test_different_reads():
    rng = _rng(2)
    a = rng.integers(0, 100, (4, 8, 8, 1)).astype(np.float32)
    b = rng.integers(0, 100, (4, 8, 8, 1)).astype(np.float32)
    seq1 = J.build_operation_sequence(J.circular_batch_read(a, first=2))
    seq2 = J.build_operation_sequence(J.image(b))
    out, _ = check_divergent([1, 1, 2, 2], seq1, seq2, kinds=["circ", "image"])
    for z in range(4):
        expect = a[(2 + z) % 4] if z < 2 else b[z]
        np.testing.assert_array_equal(out.numpy()[z], expect)


@pytest.mark.parametrize("first", [0, 3])
def test_circ_and_image_per_channel_chains(first):
    rng = _rng(3)
    a = rng.integers(0, 200, (6, 16, 128, 3)).astype(np.float32)
    b = rng.integers(0, 200, (6, 16, 128, 3)).astype(np.uint8)
    seq1 = J.build_operation_sequence(J.circular_batch_read(a, first=first),
                                      J.multiply((2.0, 0.5, 1.0)), J.add(1.0))
    seq2 = J.build_operation_sequence(J.image(b), J.convert_to(np.float32, alpha=0.25))
    ids = [1, 2, 2, 1, 2, 1]
    check_divergent(ids, seq1, seq2, kinds=["circ", "image"])
    p = J.launch_divergent_batch(ids, seq1, seq2, backend=J.ParBackend.PALLAS_INTERPRET)
    assert_backend("pallas:divergent:interpret")
    eager = T.launch_divergent_batch(ids, from_jax(seq1), from_jax(seq2), device="cpu")
    _assert_close(eager, p, "eager vs the reference's Pallas K6")


def test_whole_plane_stack_resize():
    rng = _rng(4)
    stack = rng.integers(0, 256, (6, 32, 128, 3)).astype(np.uint8)
    flat = rng.integers(0, 200, (6, 16, 64, 3)).astype(np.float32)
    seq1 = J.build_operation_sequence(J.resize_batch(stack, dsize=J.Size(64, 16)),
                                      J.multiply(0.5), J.write_tensor())
    seq2 = J.build_operation_sequence(J.image(flat), J.write_tensor())
    ids = [1 if z % 2 == 0 else 2 for z in range(6)]
    check_divergent(ids, seq1, seq2, pallas=True, kinds=["resize", "image"])


@pytest.mark.parametrize("fmt,crange", [
    (J.PixelFormat.NV12, J.ColorRange.FULL),
    (J.PixelFormat.NV21, J.ColorRange.LIMITED),
])
def test_nv12_resize_group(fmt, crange):
    rng = _rng(5)
    sh, sw, h, w = 32, 128, 16, 64
    bufs = [rng.integers(0, 256, (sh * 3 // 2, sw)).astype(np.uint8) for _ in range(4)]
    cams = [J.resize(J.fuse(J.read_yuv(b, pixel_format=fmt),
                            J.convert_yuv_to_rgb(standard=J.ColorStandard.BT709,
                                                 color_range=crange, out_dtype=np.float32)),
                     J.Size(w, h)) for b in bufs]
    flat = rng.integers(0, 200, (4, h, w, 3)).astype(np.float32)
    seq1 = J.build_operation_sequence(J.batch_read(cams), J.multiply(0.5), J.write_tensor())
    seq2 = J.build_operation_sequence(J.image(flat), J.write_tensor())
    check_divergent([1, 2, 1, 2], seq1, seq2, pallas=True, kinds=["nv12", "image"])


def test_nv12_group_without_resize_alpha():
    """Full-resolution NV12 reads (nearest chroma) with an alpha channel, a
    group the reference's Pallas kernel refuses and the port's takes."""
    rng = _rng(6)
    bufs = [rng.integers(0, 256, (24, 20)).astype(np.uint8) for _ in range(3)]
    cams = [J.fuse(J.read_yuv(b), J.convert_yuv_to_rgb(alpha=True, out_dtype=np.float32))
            for b in bufs]
    flat = rng.integers(0, 200, (3, 16, 20, 4)).astype(np.float32)
    seq1 = J.build_operation_sequence(J.batch_read(cams), J.subtract(1.5), J.split_tensor())
    seq2 = J.build_operation_sequence(J.image(flat), J.split_tensor())
    check_divergent([1, 1, 2], seq1, seq2, kinds=["nv12", "image"])


def _crop_batch(rects, chain_alpha=0.5, n=8):
    rng = _rng(7)
    frame = rng.integers(0, 256, (296, 128, 3)).astype(np.uint8)
    seq1 = J.build_operation_sequence(
        J.resize_batch(frame, rects=rects, dsize=J.Size(64, 128)),
        J.convert_to(np.float32, alpha=chain_alpha), J.subtract((1.0, 2.0, 3.0)), J.write_tensor())
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    seq2 = J.build_operation_sequence(J.image(flat), J.multiply(2.0), J.write_tensor())
    return seq1, seq2


def test_crop_resize_group():
    rects = np.array([[5 * z, 3 * z, 60, 120] for z in range(8)], np.int32)
    ids = [1 if z % 3 else 2 for z in range(8)]
    check_divergent(ids, *_crop_batch(rects), pallas=True, kinds=["image", "crop_resize"])


def test_crop_resize_bottom_of_frame():
    rects = np.array([[8 * z, 176 - z, 60, 120] for z in range(4)], np.int32)
    check_divergent([1, 1, 2, 1], *_crop_batch(rects, n=4), pallas=True)


def test_crop_resize_negative_origins_and_letterbox():
    """Rects left of and above the frame read from the far edge, as K1's do;
    a letterboxed, ragged crop group (the reference's Pallas kernel refuses
    both; the port's kernel takes them)."""
    rng = _rng(8)
    frame = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    rects = np.array([[-7, 3, 30, 20], [5, -9, 20, 30], [-90, -2, 24, 24], [70, 50, 24, 24]],
                     np.int32)
    seq1 = J.build_operation_sequence(
        J.resize_batch(frame, rects=rects, dsize=J.Size(16, 12), used_planes=3,
                       background=(9.0, 8.0, 7.0), aspect_ratio=J.AspectRatio.PRESERVE_AR),
        J.multiply(0.5))
    flat = rng.integers(0, 200, (4, 12, 16, 3)).astype(np.float32)
    seq2 = J.build_operation_sequence(J.image(flat))
    check_divergent([1, 2, 1, 1], seq1, seq2, kinds=["crop_resize", "image"])


def test_rect_jitter_builds_no_plan():
    outs = []
    builds = None
    for shift in range(3):
        rects = np.array([[5 * z + shift, 3 * z, 40, 56] for z in range(4)], np.int32)
        rng = _rng(9)
        frame = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
        seq1 = T.build_operation_sequence(T.resize_batch(frame, rects=rects, dsize=T.Size(32, 64)),
                                          T.write_tensor())
        seq2 = T.build_operation_sequence(
            T.image(rng.integers(0, 200, (4, 64, 32, 3)).astype(np.float32)), T.write_tensor())
        outs.append(T.launch_divergent_batch([1, 2, 1, 2], seq1, seq2, device="cpu"))
        if builds is None:
            builds = executor.PLAN_BUILDS
    assert executor.PLAN_BUILDS == builds
    assert not torch.equal(outs[0], outs[1])


def _warp_mix(angle0=-14.0, src_hw=(96, 128), dsize=(64, 128), n=8):
    rng = _rng(10)
    h, w = src_hw
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(n)]
    mats = [rotation((w / 2, h / 2), 4.0 * z + angle0, 1.0) for z in range(n)]
    frame = rng.integers(0, 256, (160, 128, 3)).astype(np.uint8)
    rects = np.array([[5 * z, 3 * z, 60, 120] for z in range(n)], np.int32)
    flat = rng.integers(0, 200, (n, dsize[1], dsize[0], 3)).astype(np.float32)
    seq_warp = J.build_operation_sequence(J.warp_batch(imgs, mats, J.Size(*dsize)),
                                          J.multiply(0.5), J.write_tensor())
    seq_crop = J.build_operation_sequence(
        J.resize_batch(frame, rects=rects, dsize=J.Size(*dsize)),
        J.convert_to(np.float32, alpha=0.5), J.write_tensor())
    seq_pass = J.build_operation_sequence(J.image(flat), J.multiply(2.0), J.write_tensor())
    return seq_warp, seq_crop, seq_pass


def test_warp_crop_pass_mix():
    ids = [1, 2, 3, 1, 2, 3, 1, 2]
    check_divergent(ids, *_warp_mix(), pallas=True, kinds=["warp", "crop_resize", "image"])


def test_new_matrices_build_no_plan():
    ids = [1, 2, 1, 2]
    outs, builds = [], []
    for ang in (5.0, 25.0):
        seq_warp, _, seq_pass = _warp_mix(angle0=ang, n=4)
        eager, _ = check_divergent(ids, seq_warp, seq_pass)
        outs.append(eager)
        builds.append(executor.PLAN_BUILDS)
    assert builds[0] == builds[1]
    assert not torch.equal(outs[0], outs[1])


def test_same_matrices_new_source_size_and_dsize():
    """ADVICE r5: the reference's Pallas divergent warp keys its bake on the
    matrices alone and can return a stale bake when the same matrices meet
    a new source size and dsize. The port takes the matrices at runtime and
    equals the reference's XLA merge in both geometries."""
    ids = [1, 2, 1, 2]
    seen = set()
    for src_hw, dsize in (((96, 128), (64, 128)), ((64, 96), (32, 64))):
        seq_warp, _, seq_pass = _warp_mix(angle0=5.0, src_hw=(96, 128), dsize=dsize, n=4)
        rng = _rng(11)
        imgs = [rng.integers(0, 256, src_hw + (3,)).astype(np.uint8) for _ in range(4)]
        mats = [rotation((64, 48), 5.0 + 4.0 * z, 1.0) for z in range(4)]  # the same in both
        seq_warp = J.build_operation_sequence(J.warp_batch(imgs, mats, J.Size(*dsize)),
                                              J.multiply(0.5), J.write_tensor())
        eager, plan = check_divergent(ids, seq_warp, seq_pass)
        assert plan.dsize == T.Size(*dsize)
        seen.add(tuple(eager.shape))
    assert len(seen) == 2


# --- what the port adds: the merge cast, floor modulo, integer chains --------


def test_merge_casts_other_groups_to_plane_zeros_dtype():
    """The merged batch takes the dtype of plane 0's group; another group's
    float values are clamped, then truncated (3.7 -> 3, 297.5 -> 255,
    -0.5 -> 0), not rounded as saturate_cast would."""
    u8 = np.full((2, 2, 4, 1), 7, np.uint8)
    f = np.zeros((2, 2, 4, 1), np.float32)
    f[1, 0, :, 0] = (3.7, 200.9, -0.5, 255.6)
    f[1, 1, :, 0] = (297.5, -300.0, 254.5, 0.5)
    seq1 = J.build_operation_sequence(J.image(u8))
    seq2 = J.build_operation_sequence(J.image(f))
    tseqs = (from_jax(seq1), from_jax(seq2))
    out = T.launch_divergent_batch([1, 2], *tseqs, device="cpu")
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy()[1, :, :, 0], [[3, 200, 0, 255], [255, 0, 254, 0]])
    _assert_equal(out, J.launch_divergent_batch([1, 2], seq1, seq2, backend=J.ParBackend.XLA),
                  "merge cast vs the reference's XLA merge")
    _assert_equal(out, reference_merge([1, 2], seq1, seq2), "merge cast vs op by op")
    # the kernel takes such a batch: the float group stores through the same cast
    plan = kd.build_plan(tseqs, [1, 2])
    assert plan.out_dtype == torch.uint8
    assert [g.flags & kd.CLAMP_STORE for g in plan.groups] == [0, kd.CLAMP_STORE]
    _assert_equal(kd.run(tseqs, plan, CPU), out, "kernel plain version vs eager")


@pytest.mark.parametrize("first_group", ["uint8", "float32"])
def test_groups_of_different_output_dtypes_run_as_one_batch(first_group):
    """A uint8 crop-resize chain, a float32 ring read and a float32 warp in
    one batch: the batch takes plane 0's group's dtype, the kernel's plan
    takes it (AUTO no longer runs it group by group) and marks exactly the
    float32 groups of a uint8 batch for the clamp-then-truncate store."""
    rng = _rng(21)
    n = 6
    frame = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    rects = np.array([[2 + 3 * z, 1 + 2 * z, 20, 24] for z in range(n)], np.int32)
    ring = (rng.random((n, 12, 16, 3), dtype=np.float32) * 400 - 70).astype(np.float32)
    imgs = [rng.integers(0, 256, (24, 32, 3)).astype(np.uint8) for _ in range(n)]
    mats = [rotation((16, 12), 5.0 * z - 7.0, 1.4) for z in range(n)]
    seq_u8 = J.build_operation_sequence(
        J.resize_batch(frame, rects=rects, dsize=J.Size(16, 12)),
        J.convert_to(np.uint8, alpha=0.9, beta=2.0), J.write_tensor())
    seq_ring = J.build_operation_sequence(J.circular_batch_read(ring, first=-2),
                                          J.multiply(1.1), J.write_tensor())
    seq_warp = J.build_operation_sequence(J.warp_batch(imgs, mats, J.Size(16, 12), default=300.0),
                                          J.add(-3.25), J.write_tensor())
    if first_group == "uint8":
        ids, seqs = [1, 2, 3, 1, 2, 3], (seq_u8, seq_ring, seq_warp)
        marked = [0, kd.CLAMP_STORE, kd.CLAMP_STORE]
    else:
        ids, seqs = [1, 2, 3, 3, 2, 1], (seq_ring, seq_u8, seq_warp)
        marked = [0, 0, 0]
    out, plan = check_divergent(ids, *seqs)
    assert str(out.dtype) == f"torch.{first_group}" and plan.out_dtype == out.dtype
    assert [g.flags & kd.CLAMP_STORE for g in plan.groups] == marked


@pytest.mark.parametrize("ascendent", [True, False])
@pytest.mark.parametrize("first", [-5, -1, 0, 3, 18])
def test_first_is_taken_floor_modulo(first, ascendent):
    n = 16
    ring = np.arange(n, dtype=np.float32)[:, None, None, None] * np.ones((1, 2, 3, 1), np.float32)
    seq1 = J.build_operation_sequence(J.circular_batch_read(ring, first=first, ascendent=ascendent),
                                      J.add(0.5))
    seq2 = J.build_operation_sequence(J.image(ring), J.multiply(-1.0))
    ids = [1 if z % 2 == 0 else 2 for z in range(n)]
    out, _ = check_divergent(ids, seq1, seq2, kinds=["circ", "image"])
    for z in range(0, n, 2):
        src = (first + z) % n if ascendent else (first - z) % n
        assert out.numpy()[z, 0, 0, 0] == src + 0.5


def test_uint8_chain_saturates_per_op():
    """A binary op on a uint8 value saturates after each op (the Pallas
    kernel refuses such a chain; the port's encoder takes it)."""
    rng = _rng(12)
    a = rng.integers(0, 256, (4, 6, 10, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (4, 6, 10, 3)).astype(np.uint8)
    seq1 = J.build_operation_sequence(J.image(a), J.multiply(1.7), J.add(-20.5))
    seq2 = J.build_operation_sequence(J.circular_batch_read(b, first=1),
                                      J.convert_to(np.uint8, alpha=0.5, beta=3.0))
    out, plan = check_divergent([2, 1, 1, 2], seq1, seq2, kinds=["circ", "image"])
    assert out.dtype == torch.uint8 and plan.out_dtype == torch.uint8
    assert pd.supports([seq1, seq2], [2, 1, 1, 2]) is False


@pytest.mark.parametrize("write", ["split_tensor", "split_tensor_transposed", "split",
                                   "split_tensor_packed", "write_tensor", "write"])
def test_every_write_layout(write):
    seq_warp, seq_crop, seq_pass = _warp_mix(n=4, src_hw=(48, 64), dsize=(16, 32))
    seqs = [J.build_operation_sequence(s.read, *s.compute, getattr(J, write)())
            for s in (seq_warp, seq_crop, seq_pass)]
    _, plan = check_divergent([3, 1, 2, 3], *seqs)
    assert plan.layout == kd.kbr._LAYOUTS[type(from_jax(seqs[0].write))]


# --- the kernel's plan and parameter block -----------------------------------


def _six_kinds():
    """One divergent batch of four planes with a group of each kind."""
    rng = _rng(13)
    h, w = 8, 16
    stack = rng.integers(0, 256, (6, h, w, 3)).astype(np.uint8)
    frame = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
    rects = np.array([[z, 2 * z, 20, 10] for z in range(6)], np.int32)
    bufs = [rng.integers(0, 256, (12, 16)).astype(np.uint8) for _ in range(6)]
    imgs = [rng.integers(0, 256, (20, 24, 3)).astype(np.uint8) for _ in range(6)]
    mats = [rotation((12, 10), 10.0 * z, 1.1) for z in range(6)]
    to_f32 = J.convert_to(np.float32)
    return [
        J.build_operation_sequence(J.image(stack), to_f32, J.multiply((1.0, 2.0, 3.0))),
        J.build_operation_sequence(J.circular_batch_read(stack, first=-2, ascendent=False),
                                   to_f32),
        J.build_operation_sequence(J.resize_batch(frame, rects=rects, dsize=J.Size(w, h),
                                                  used_planes=4, background=5.0)),
        J.build_operation_sequence(J.resize_batch(list(stack[:, :6, :12]), dsize=J.Size(w, h)),
                                   J.add(1.0)),
        J.build_operation_sequence(J.batch_read([J.resize(J.fuse(J.read_yuv(b),
                                                                 J.convert_yuv_to_rgb(
                                                                     out_dtype=np.float32)),
                                                          J.Size(w, h)) for b in bufs])),
        J.build_operation_sequence(J.warp_batch(imgs, mats, J.Size(w, h), default=2.0)),
    ]


def test_build_plan_classifies_each_kind():
    seqs = _six_kinds()
    ids = [1, 2, 3, 4, 5, 6]
    _, plan = check_divergent(ids, *seqs,
                              kinds=["image", "circ", "crop_resize", "resize", "nv12", "warp"])
    assert plan.table.tolist() == [0, 1, 2, 3, 4, 5]
    assert plan.dsize == T.Size(16, 8) and plan.out_ch == 3 and plan.out_dtype == torch.float32
    circ = plan.groups[1]
    assert circ.n_src == 6 and not circ.ascendent and circ.src_dtype == torch.uint8
    nv12 = plan.groups[4]
    assert nv12.src_h == 8 and nv12.src_w == 16 and nv12.nch == 1 and nv12.tab_off >= 0


def test_prepare_fills_the_parameter_block():
    seqs = [from_jax(s) for s in _six_kinds()]
    ids = [6, 1, 2, 3, 4, 5]
    plan = kd.build_plan(seqs, ids)
    a = kd.prepare(seqs, plan, CPU)
    blk = a.block.numpy()
    fblk = blk.view(np.float32)
    n = 6
    np.testing.assert_array_equal(blk[:n], plan.table)
    assert plan.table.tolist() == [0, 1, 2, 3, 4, 5] and plan.groups[0].sid == 6
    ptrs = blk[a.ptr_off:a.ptr_off + 2 * n].view(np.uint64)
    desc = blk[a.desc_off:a.desc_off + kd.DESC_INTS * len(plan.groups)].reshape(-1, kd.DESC_INTS)
    for g, (group, d) in enumerate(zip(plan.groups, desc)):
        seq = seqs[group.sid - 1]
        assert d[0] == kd.KINDS.index(group.kind)
        assert tuple(d[1:4]) == (group.src_h, group.src_w, group.nch)
        assert d[10:12].tolist() == [group.op_off, group.n_ops]
        leaves = [np.asarray(v, np.float32).reshape(-1) for v in flatten(tuple(seq.compute))[1]]
        if leaves:
            np.testing.assert_array_equal(fblk[d[12]:d[12] + sum(v.size for v in leaves)],
                                          np.concatenate(leaves))
        z = group.planes[0]
        src = a.srcs[[s.data_ptr() for s in a.srcs].index(int(ptrs[z]))]
        if group.kind == "circ":
            assert blk[d[6]] == -2 and d[7] == 0 and d[5] == 6
        elif group.kind == "crop_resize":
            assert blk[d[9]] == 4
            np.testing.assert_array_equal(blk[d[13]:d[13] + 4 * n].reshape(n, 4), seq.read.rects)
            np.testing.assert_array_equal(fblk[d[15]:d[15] + 4], [5.0, 5.0, 5.0, 0.0])
            assert src.data_ptr() != 0 and tuple(src.shape) == (40, 50 * 3)
        elif group.kind == "warp":
            w = seq.read.ops[z]
            np.testing.assert_array_equal(fblk[d[13] + 9 * z:d[13] + 9 * z + 6], w.coeffs)
            np.testing.assert_array_equal(fblk[d[15] + 4 * z:d[15] + 4 * z + 3], w.default)
            assert torch.equal(src, torch.from_numpy(np.asarray(w.source.data)))
            assert d[14] == 0  # affine
        elif group.kind == "nv12":
            consts = plan.consts
            taps = consts[d[13]:d[13] + 4 * (16 + 8)]
            np.testing.assert_array_equal(taps[:32], np.concatenate(axis_taps(16, 16, True)[:2]))
            np.testing.assert_array_equal(taps[48:64], np.arange(16) // 2)  # chroma x0
            np.testing.assert_array_equal(consts[d[15]:d[15] + 16].view(np.float32),
                                          axis_taps(16, 16, True)[2])
    # one distinct source moves once: six planes of one stack share an address
    stack_groups = [g for g in plan.groups if g.kind in ("image", "circ")]
    assert len({int(ptrs[g.planes[0]]) for g in stack_groups}) == 1


def test_divergent_reference_equals_eager_bit_for_bit():
    seqs = [from_jax(s) for s in _six_kinds()]
    ids = [3, 3, 6, 1, 5, 2]
    plan = kd.build_plan(seqs, ids)
    a = kd.prepare(seqs, plan, CPU)
    _assert_equal(kd.divergent_reference(a), T.launch_divergent_batch(ids, *seqs, device="cpu"),
                  "plain version vs eager")
    _assert_equal(kd.divergent(a), kd.divergent_reference(a), "wrapper on CPU tensors")


# --- routing and error paths (tests/test_api_edges.py:59,97,106) -------------


def test_routing_decision_before_any_launch():
    seqs = [from_jax(s) for s in _six_kinds()]
    ids = [1, 2, 3, 4, 5, 6]
    cuda = torch.device("cuda")  # nothing touches the device: the choice is made on shapes
    assert executor._select_divergent(seqs, ids, T.ParBackend.AUTO, cuda).backend == \
        "cuda:divergent"
    assert executor._select_divergent(seqs, ids, T.ParBackend.TORCH, cuda).backend == \
        "torch:divergent"
    # a ragged BatchRead group takes the kernel (the reference's TPU kernel
    # refuses it, pallas_divergent.py:166, and its AUTO runs one XLA
    # program): both port versions equal the reference's merge op by op
    imgs = [_rng(30 + k).integers(0, 256, (8, 16, 3)).astype(np.uint8) for k in range(6)]
    jragged = J.build_operation_sequence(
        J.batch_read([J.image(im) for im in imgs], used_planes=3, default=7.6),
        J.convert_to(np.float32, alpha=0.5))
    jflat = J.build_operation_sequence(J.image(np.stack(imgs).astype(np.float32)))
    mixed = [from_jax(jflat), from_jax(jragged)]
    for backend in (T.ParBackend.AUTO, T.ParBackend.CUDA):
        assert executor._select_divergent(mixed, [1, 2, 1, 2, 1, 2], backend,
                                          cuda).backend == "cuda:divergent"
    eager, plan = check_divergent([1, 2, 1, 2, 1, 2], jflat, jragged, kinds=["image", "image"])
    assert plan.groups[1].held == torch.uint8 and plan.groups[0].held is None
    np.testing.assert_array_equal(eager.numpy()[5], np.full((8, 16, 3), 3.5, np.float32))
    # a batch the kernel refuses still raises under an explicit CUDA
    narrow = T.build_operation_sequence(T.image(np.zeros((6, 8, 15, 3), np.float32)))
    with pytest.raises(ValueError, match="cannot run"):
        executor._select_divergent([mixed[0], narrow], [1, 2, 1, 2, 1, 2], T.ParBackend.CUDA,
                                   cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.CUDA, device="cpu")


@pytest.mark.parametrize("kind", ["image", "nv12", "warp"])
@pytest.mark.parametrize("used", [0, 2, 4])
def test_ragged_batch_read_groups_run_in_the_kernel(kind, used):
    """A ragged ``BatchRead`` group of images, NV12 reads or warps: its
    planes from ``used_planes`` on hold the default, cast to the read's
    dtype, through the group's chain, as the reference's merge gives them;
    the descriptor points at ``used_planes`` (word 9) and the default (word
    6) in the parameter block."""
    rng = _rng(40)
    n, h, w = 4, 8, 16
    if kind == "image":
        reads = [J.image(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)) for _ in range(n)]
        default, held = (200.7, 2.2, 9.9), np.uint8
    elif kind == "nv12":
        reads = [J.resize(J.fuse(J.read_yuv(rng.integers(0, 256, (24, 32)).astype(np.uint8)),
                                 J.convert_yuv_to_rgb(out_dtype=np.float32)), J.Size(w, h))
                 for _ in range(n)]
        default, held = 7.25, np.float32
    else:
        srcs = [rng.integers(0, 256, (12, 20, 3)).astype(np.uint8) for _ in range(n)]
        reads = [J.warp(J.image(s), rotation((10, 6), 5.0 * k, 1.0), J.Size(w, h))
                 for k, s in enumerate(srcs)]
        default, held = (1.5, -2.0, 250.0), np.float32
    jragged = J.build_operation_sequence(J.batch_read(reads, used_planes=used, default=default),
                                         J.convert_to(np.float32, alpha=0.5), J.add(1.0))
    jflat = J.build_operation_sequence(
        J.image(rng.integers(0, 200, (n, h, w, 3)).astype(np.float32)), J.multiply(2.0))
    ids = [2, 1, 2, 2]
    eager, plan = check_divergent(ids, jflat, jragged, kinds=[kind, "image"])
    ragged = [g for g in plan.groups if g.held is not None]
    assert len(ragged) == 1 and ragged[0].planes == (0, 2, 3)
    # the planes past used_planes: the default as the read's dtype, then the chain
    want = np.broadcast_to(np.asarray(default, np.float64).astype(held).astype(np.float32),
                           (3,)) * np.float32(0.5) + np.float32(1.0)
    for z in (0, 2, 3):
        if z >= used:
            np.testing.assert_array_equal(eager.numpy()[z], np.broadcast_to(want, (h, w, 3)))
    tseqs = tuple(from_jax(s) for s in (jflat, jragged))
    a = kd.prepare(tseqs, plan, CPU)
    words = a.block.numpy()
    d = words[a.desc_off + kd.DESC_INTS * plan.groups.index(ragged[0]):][:kd.DESC_INTS]
    assert words[d[9]] == used
    np.testing.assert_array_equal(words[d[6]:d[6] + 3].view(np.float32),
                                  np.broadcast_to(np.asarray(default, np.float64).astype(held)
                                                  .astype(np.float32), (3,)))
    assert all(words[a.desc_off + kd.DESC_INTS * k + 9] == -1
               for k, g in enumerate(plan.groups) if g.held is None and g.kind == "image")


def test_selector_errors():
    data = _rng(14).random((2, 4, 4, 1), dtype=np.float32)
    seq = T.build_operation_sequence(T.image(data))
    with pytest.raises(ValueError, match="out of range"):
        T.launch_divergent_batch(lambda z: 5, seq, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        T.launch_divergent_batch([0, 1], seq, device="cpu")
    with pytest.raises(ValueError, match="entries"):
        T.launch_divergent_batch([1, 1, 1], seq, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        T.launch_divergent_batch([1, 1], device="cpu")
    with pytest.raises(ValueError):
        J.launch_divergent_batch(lambda z: 5, J.build_operation_sequence(J.image(data)))


def test_id_list_and_fresh_lambdas_reuse_one_plan():
    data = _rng(15).random((4, 4, 4, 1), dtype=np.float32)
    seq1 = T.build_operation_sequence(T.image(data), T.multiply(2.0))
    seq2 = T.build_operation_sequence(T.image(data))
    out = T.launch_divergent_batch([1, 2, 1, 2], seq1, seq2, device="cpu")
    np.testing.assert_array_equal(out.numpy()[0], data[0] * np.float32(2.0))
    np.testing.assert_array_equal(out.numpy()[1], data[1])
    builds = executor.PLAN_BUILDS
    for _ in range(3):
        seq = T.build_operation_sequence(T.image(data), T.add(1.0))
        T.launch_divergent_batch(lambda z: 1, seq, device="cpu")
    assert executor.PLAN_BUILDS == builds + 1
