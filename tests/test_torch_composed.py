"""The composed-read kernel's slice on the CPU: which read trees it takes,
and its plain version against the JAX package and the port's eager lowering.

- Routing, decided on the host: each composition that ran eagerly on the
  card before (a resize, a warp or a one-pixel read over crops, borders and
  fused reads, under crops and borders, ``crop_batch``) is taken by
  ``cuda_composed.build_plan`` and ``executor._select(..., CUDA)`` names
  ``cuda:composed``, and so is each tree with a second resampling node or a
  fused read above the core that stayed eager before
  (``test_torch_composed_nested.py`` holds them); a third resampling node,
  a second fused read in one section, five stages in one, a nested resize
  over the commuted float NV12 read, a batched image under a resample and
  a ``BatchRead`` whose planes differ in structure or of batched images
  stay ``"torch"`` (``test_torch_composed_batch.py`` holds the batches it
  takes); every pipeline one of the five other kernels takes keeps its
  kernel.
- Parity: C1-C8 (``torch_composed_cases``) built with the JAX factories and
  carried across with ``from_jax``: ``composed_reference`` within 1e-4 of the
  reference's jitted XLA path (on the 0..255 scale), and bit for bit (as
  int32 bits) the port's eager lowering on uint8, int16, uint16, float16,
  int32, float64 and subnormal float32 sources.
- New crop origins, matrices and border values build no plan, and the plan
  of the first values runs the second ones right.
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import flatten
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
import torch_composed_cases as cc

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # only named: the routing is decided on shapes
F32_TOL = 1e-4               # against the jitted XLA path, on values of 0..255
H, W = 108, 192
C = T.ColorConversionCode


def _backend(ops, backend=T.ParBackend.AUTO):
    return executor._select(T.build_pipeline(*ops), backend, CUDA).backend


def _img(shape, seed=0, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(dtype)


# --- routing -------------------------------------------------------------------


@pytest.mark.parametrize("name", cc.NAMES)
def test_each_composition_of_the_table_takes_the_kernel(name):
    ops = cc.cases(T, cc.frames(H, W))[name]
    plan = kc.build_plan(T.build_pipeline(*ops))
    assert plan.core == {"c4": "warp", "c6": "none", "c7": "none"}.get(name[:2], "resize")
    assert _backend(ops) == "cuda:composed"
    assert _backend(ops, T.ParBackend.CUDA) == "cuda:composed"


@pytest.mark.parametrize("name", list(cc.more_cases(T)))
def test_each_other_composition_takes_the_kernel(name):
    ops = cc.more_cases(T)[name]
    kc.build_plan(T.build_pipeline(*ops))
    assert _backend(ops) == "cuda:composed"


def _nested_moved():
    """The trees a second resampling node or a fused read above the core
    kept eager until the kernel took two levels (``_plane``'s ``core2``)."""
    img = _img((36, 48, 3), 4)
    m = cc.rotation((24, 18), 10.0)
    return {
        "resize_of_a_resize": (T.resize(T.resize(T.image(img), T.Size(30, 20)), T.Size(15, 10)),),
        "resize_of_a_warp": (T.resize(T.warp(T.image(img), m, T.Size(30, 20)), T.Size(15, 10)),),
        "warp_of_a_resize": (T.warp(T.resize(T.image(img), T.Size(30, 20)), m, T.Size(15, 10)),),
        "resize_of_a_crop_of_a_resize": (
            T.resize(T.crop(T.resize(T.image(img), T.Size(30, 20)), T.Rect(1, 1, 20, 10)),
                     T.Size(15, 10)),),
        "a_batch_of_resizes_of_resizes": (
            T.batch_read([T.resize(T.resize(T.image(img), T.Size(30, 20)), T.Size(8, 8))] * 2),
            T.split_tensor()),
        "a_crop_of_a_fused_read_of_a_resize": (
            T.crop(T.fuse(T.resize(T.image(img), T.Size(30, 20)), T.multiply(2.0)),
                   T.Rect(1, 1, 20, 10)),),
    }


@pytest.mark.parametrize("name", list(_nested_moved()))
def test_the_nested_trees_that_stayed_eager_take_the_kernel(name):
    ops = _nested_moved()[name]
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    assert plan.core2 == ("none" if name.startswith("a_crop") else
                          "warp" if name.startswith("warp") else "resize")
    assert _backend(ops) == "cuda:composed"
    assert _backend(ops, T.ParBackend.CUDA) == "cuda:composed"
    got = kc.run(p, plan, CPU)
    np.testing.assert_array_equal(_arrays(got)[0],
                                  _arrays(T.execute_operations(*ops, device="cpu"))[0])


def _refused():
    img = _img((36, 48, 3), 4)
    stack = _img((2, 36, 48, 3), 5)
    nv12 = _img((36 * 3 // 2, 48), 6)
    m = cc.rotation((24, 18), 10.0)
    small = T.resize(T.image(img), T.Size(30, 20))
    crops = small
    for k in range(5):
        crops = T.crop(crops, T.Rect(0, 0, 29 - k, 19 - k))
    return {
        "resize_of_a_batched_image": (T.resize(T.image(stack), T.Size(15, 10)),),
        "resize_of_a_crop_of_a_batched_image": (
            T.resize(T.crop(T.image(stack), T.Rect(1, 1, 20, 10)), T.Size(15, 10)),),
        "a_batch_of_planes_of_two_structures": (
            T.batch_read([T.resize(T.image(img), T.Size(8, 8)),
                          T.resize(T.crop(T.image(img), T.Rect(1, 1, 20, 10)), T.Size(8, 8))]),
            T.split_tensor()),
        "a_batch_of_batched_images": (T.batch_read([T.image(stack)] * 2), T.split_tensor()),
        "a_uint32_source": (T.resize(T.crop(T.image(img.astype(np.uint32)), T.Rect(0, 0, 20, 10)),
                                     T.Size(15, 10)),),
        "a_resize_of_a_warp_of_a_resize": (
            T.resize(T.warp(small, m, T.Size(30, 20)), T.Size(15, 10)),),
        "a_second_fused_read_between_two_resizes": (
            T.resize(T.fuse(T.crop(T.fuse(small, T.multiply(2.0)), T.Rect(1, 1, 20, 10)),
                            T.multiply(0.5)), T.Size(15, 10)),),
        "five_stages_between_two_resizes": (T.resize(crops, T.Size(12, 8)),),
        "a_nested_resize_over_the_commuted_float_nv12_read": (
            T.resize(T.resize(T.fuse(T.read_yuv(nv12), T.convert_yuv_to_rgb(
                out_dtype=np.float32)), T.Size(30, 20)), T.Size(15, 10)),),
        "two_resizes_of_a_batched_image": (
            T.resize(T.resize(T.image(stack), T.Size(30, 20)), T.Size(15, 10)),),
        "a_batch_of_nested_planes_of_two_structures": (
            T.batch_read([T.resize(small, T.Size(8, 8)),
                          T.resize(T.warp(T.image(img), m, T.Size(30, 20)), T.Size(8, 8))]),
            T.split_tensor()),
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_what_stays_eager(name):
    ops = _refused()[name]
    with pytest.raises(kc.Unsupported):
        kc.build_plan(T.build_pipeline(*ops))
    assert _backend(ops) == "torch"
    with pytest.raises(ValueError, match="cuda:composed: "):
        _backend(ops, T.ParBackend.CUDA)


def _kept():
    img = _img((36, 48, 3), 6)
    ring = _img((4, 36, 48, 3), 7)
    nv12 = _img((36 * 3 // 2, 48), 8)
    m = cc.rotation((24, 18), 10.0)
    rects = np.array([[0, 0, 20, 10], [3, 4, 30, 20]], np.int32)
    return {
        "cuda:batch_resize": [(T.resize_batch(img, rects=rects, dsize=T.Size(16, 8)),
                               T.split_tensor())],
        "cuda:frame_resize": [
            (T.resize(T.image(img), T.Size(16, 8)), T.split_tensor()),
            (T.resize(T.fuse(T.read_yuv(nv12), T.convert_yuv_to_rgb(out_dtype=np.float32)),
                      T.Size(16, 8)), T.split_tensor())],
        "cuda:warp": [(T.warp(T.image(img), m, T.Size(16, 8)), T.split_tensor()),
                      (T.warp_batch([img, img], [m, m], T.Size(16, 8)), T.split_tensor())],
        "cuda:pointwise": [
            (T.image(img), T.multiply(2.0), T.write()),
            (T.crop(T.image(img), T.Rect(1, 2, 20, 10)), T.write()),
            (T.make_border(T.crop(T.image(img), T.Rect(1, 2, 20, 10)), 1, 1, 1, 1), T.write()),
            (T.fuse(T.crop(T.image(img), T.Rect(1, 2, 20, 10)), T.multiply(2.0)), T.write()),
            (T.read_yuv(nv12), T.convert_yuv_to_rgb(), T.write()),
            (T.circular_batch_read(ring, 1), T.split_tensor())],
    }


@pytest.mark.parametrize("kernel", list(_kept()))
def test_every_other_kernel_keeps_its_pipelines(kernel):
    for ops in _kept()[kernel]:
        assert _backend(ops) == kernel


def test_the_two_heads_the_pointwise_kernel_refused_are_one_launch():
    """The pointwise kernel runs every head that reads one source pixel per
    output pixel but two: crop_batch, and a FusedRead under a crop or a
    border. The composed kernel takes both, as its one-pixel core."""
    img = _img((36, 48, 3), 9)
    for ops in ((T.crop_batch(img, [T.Rect(0, 0, 8, 8), T.Rect(40, 30, 8, 8)]), T.split_tensor()),
                (T.crop(T.fuse(T.image(img), T.multiply(2.0)), T.Rect(1, 1, 8, 8)), T.write()),
                (T.make_border(T.fuse(T.image(img), T.cvt_color(C.COLOR_RGB2GRAY)), 1, 1, 1, 1,
                               T.BorderMode.CONSTANT, 3), T.write())):
        p = T.build_pipeline(*ops)
        with pytest.raises(kp.Unsupported):
            kp.build_plan(p)
        assert kc.build_plan(p).core == "none"
        assert _backend(ops) == "cuda:composed"


def test_the_plan_is_made_on_shapes_alone():
    """Meta tensors: the plan reads shapes and dtypes and nothing else."""
    big = torch.empty((2160, 3840, 3), dtype=torch.uint8, device="meta")
    ops = (T.resize(T.crop(T.image(big), T.Rect(960, 540, 1920, 1080)), T.Size(640, 360)),
           *cc.normalize(T), T.split_tensor())
    assert _backend(ops) == "cuda:composed"
    plan = kc.build_plan(T.build_pipeline(*ops))
    # 3:1 on both axes, one phase each: the strided-slice edge rule
    assert plan.dsize == T.Size(640, 360) and plan.out_ch == 3 and plan.word("keep_edge") == 1
    assert (plan.word("in_h"), plan.word("in_w")) == (1080, 1920)


# --- parity ----------------------------------------------------------------------


def _arrays(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out]


@pytest.mark.parametrize("size", [(90, 160), (108, 192)])
@pytest.mark.parametrize("name", cc.NAMES)
def test_plain_version_against_the_reference(name, size):
    """Bit for bit the reference's op-by-op lowering and the port's eager
    one; within 1e-4 of the reference's jitted XLA path, which contracts
    multiply-adds into FMAs on the CPU (ROADMAP §3): in C8 that moves the
    uint8 rounding of a converted tap by 1, so there the tolerance is 1."""
    jops = cc.cases(J, cc.frames(*size, 11))[name]
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    got = _arrays(kc.run(p, kc.build_plan(p), CPU))
    eager = _arrays(T.execute_operations(p.read, *p.compute, p.write, device="cpu"))
    lowered = _arrays(jp.lower())
    xla = _arrays(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    for g, e, l, x in zip(got, eager, lowered, xla, strict=True):
        assert g.shape == x.shape and g.dtype == x.dtype, (g.shape, g.dtype, x.shape, x.dtype)
        np.testing.assert_array_equal(g, e)
        np.testing.assert_array_equal(g, l)
        if name.startswith("c8"):
            tol = 1.0
        else:
            tol = F32_TOL * max(1.0, float(np.abs(x).max()) / 255) if g.dtype.kind == "f" else 0
        assert np.abs(g.astype(np.float64) - x.astype(np.float64)).max() <= tol


@pytest.mark.parametrize("name", list(cc.more_cases(J)))
def test_plain_version_of_the_other_compositions_against_the_reference(name):
    """As above; integer outputs bit for bit; an NV12 conversion into uint8
    within 1 of the XLA path (its FMAs move the conversion's rounding)."""
    jops = cc.more_cases(J)[name]
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    got = _arrays(kc.run(p, kc.build_plan(p), CPU))
    lowered = _arrays(jp.lower())
    xla = _arrays(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    for g, l, x in zip(got, lowered, xla, strict=True):
        assert g.shape == x.shape and g.dtype == x.dtype
        np.testing.assert_array_equal(g, l)
        if name == "resize_of_nv12_to_u8":
            tol = 1.0
        else:
            tol = F32_TOL * max(1.0, float(np.abs(x).max()) / 255) if g.dtype.kind == "f" else 0
        assert np.abs(g.astype(np.float64) - x.astype(np.float64)).max() <= tol


def _bits(a):
    if a.dtype.kind == "f":
        return a.view(np.int32 if a.itemsize == 4 else np.int16)
    return a


def _as_dtype(x, dtype):
    """A uint8 frame's values as ``dtype``: spread over its range, float16
    scaled into its own, subnormal float32 below 2^-126 in half the values."""
    v = torch.from_numpy(x).int()
    if dtype == "sub_f32":
        mask = torch.from_numpy(np.random.default_rng(12).random(x.shape) < 0.5)
        return torch.where(mask, v.float() * 1e-39, v.float())
    d = getattr(torch, dtype)
    if d == torch.float16:
        return (v.float() / 7).half()
    if d == torch.float64:
        return v.double() * 1.5 - 100.25
    return (v * {torch.uint8: 1, torch.int16: -97, torch.uint16: 251}.get(d, 65537) + 3).to(d)


@pytest.mark.parametrize("dtype", ["uint8", "int16", "uint16", "float16", "int32", "float64",
                                   "sub_f32"])
@pytest.mark.parametrize("name", cc.NAMES[:7])
def test_plain_version_equals_the_eager_lowering_bit_for_bit(name, dtype):
    f = cc.frames(H, W, 13)
    f = {k: _as_dtype(v, dtype) if k != "nv12" else v for k, v in f.items()}
    ops = cc.cases(T, f)[name]
    if dtype == "sub_f32":  # a chain whose products flush
        ops = (ops[0], T.multiply(1e-3), *ops[1:])
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    assert plan.src_dtype == f["hd"].dtype
    got = _arrays(kc.run(p, plan, CPU))
    eager = _arrays(T.execute_operations(*ops, device="cpu"))
    for g, e in zip(got, eager, strict=True):
        assert g.shape == e.shape and g.dtype == e.dtype
        np.testing.assert_array_equal(_bits(g), _bits(e))


def test_nv12_and_nv21_bit_for_bit():
    nv = _img((54 * 3 // 2, 96), 14)
    for fmt in (T.PixelFormat.NV12, T.PixelFormat.NV21):
        for conv in (T.convert_yuv_to_rgb(out_dtype=np.uint8, alpha=True),
                     T.convert_yuv_to_rgb(T.ColorRange.LIMITED, T.ColorStandard.BT709,
                                          out_dtype=np.int16)):
            ops = (T.resize(T.crop(T.fuse(T.read_yuv(nv, fmt), conv), T.Rect(6, 4, 60, 40)),
                            T.Size(34, 22)), T.convert_to(np.uint8), T.split_tensor())
            p = T.build_pipeline(*ops)
            got = _arrays(kc.run(p, kc.build_plan(p), CPU))
            np.testing.assert_array_equal(got[0], _arrays(T.execute_operations(*ops,
                                                                                device="cpu"))[0])


# --- runtime values ----------------------------------------------------------------


@pytest.mark.parametrize("name", cc.NAMES)
def test_new_values_build_no_plan(name):
    f = cc.frames(H, W, 15)
    p0, p1 = (T.build_pipeline(*cc.cases(T, f, v)[name]) for v in (0, 1))
    k0, k1 = flatten(p0)[0], flatten(p1)[0]
    assert k0 == k1
    builds = executor.PLAN_BUILDS
    plan = executor._plan(p0, k0, T.ParBackend.AUTO, CUDA)
    assert executor._plan(p1, k1, T.ParBackend.AUTO, CUDA) is plan
    assert plan.backend == "cuda:composed" and executor.PLAN_BUILDS <= builds + 1
    # the plan of the first values runs the second ones as the eager lowering
    got = _arrays(kc.run(p1, plan.kernel, CPU))
    want = _arrays(T.execute_operations(*cc.cases(T, f, 1)[name], device="cpu"))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    a0, a1 = (kc.prepare(p, plan.kernel, CPU) for p in (p0, p1))
    moved = name[:2] in ("c1", "c3", "c4", "c6", "c7")
    assert torch.equal(a0.block, a1.block) != moved


def test_a_batch_of_crops_of_two_frames_reads_each_plane_s_own():
    a, b = _img((30, 40, 3), 16), _img((30, 40, 3), 17)
    ops = (T.batch_read([T.crop(T.image(a), T.Rect(1, 2, 10, 8)),
                         T.crop(T.image(b), T.Rect(5, 6, 10, 8)),
                         T.crop(T.image(a), T.Rect(-2, 25, 10, 8))]),
           T.convert_to(np.float32, alpha=0.5), T.split_tensor())
    p = T.build_pipeline(*ops)
    args = kc.prepare(p, kc.build_plan(p), CPU)
    assert len(args.srcs) == 2 and args.plane_src == (0, 1, 0)
    np.testing.assert_array_equal(_arrays(kc.composed(args))[0],
                                  _arrays(T.execute_operations(*ops, device="cpu"))[0])


def test_out_on_the_cpu_and_the_work_of_a_launch():
    f = cc.frames(H, W, 18)
    p = T.build_pipeline(*cc.cases(T, f)["c1_roi_crop_resize"])
    a = kc.prepare(p, kc.build_plan(p), CPU)
    want = kc.composed_reference(a)
    out = torch.zeros((2, *want.shape))[1]
    assert kc.composed(a, out=out) is out and torch.equal(out, want)
    out_bytes, src_bytes, flops = kc.work(a)
    assert out_bytes == want.numel() * 4
    assert 0 < src_bytes <= f["big"].nbytes
    # the lerps, then the chain's rows: a scale, a subtract, a divide
    assert a.plan.word("out_n_ops") == 3 and flops == want.numel() * (12 + 3)


@pytest.mark.parametrize("dsize", [(64, 36), (80, 45), (67, 31)])
def test_work_counts_the_sectors_of_the_taps_the_result_uses(dsize):
    """A crop of the large frame resized: the source bytes of a launch are
    the 32-byte sectors of the rows and columns whose taps a result uses,
    from the tap tables. At 3:1 (64x36) the edge rule keeps the first tap
    alone where the weight is 0, so the second tap is never read: half the
    rows. At 80x45 it keeps them too, at 67x31 it gathers, and a tap of
    weight 0 is still read."""
    from cvgpuspeedup_tpu_torch.ops.resize import axis_taps, keeps_edge_weight

    big = cc.frames(H, W, 19)["big"]
    roi = T.Rect(W // 2 - 5, H // 2 + 3, W, H)
    size = T.Size(*dsize)
    p = T.build_pipeline(T.resize(T.crop(T.image(big), roi), size), T.split_tensor())
    a = kc.prepare(p, kc.build_plan(p), CPU)
    keep = keeps_edge_weight(H, W, size)
    assert keep == (dsize != (67, 31))

    def used(n, m):
        i0, i1, w = axis_taps(n, m, keep)
        return np.unique(np.concatenate([i0, i1[(w != 0) | (not keep)]]))

    rows, cols = used(H, size.height) + roi.y, used(W, size.width) + roi.x
    first = ((rows[:, None] * big.shape[1] + cols[None, :]) * 3).reshape(-1)
    want = np.unique(np.concatenate([first // 32, (first + 2) // 32])).size * 32
    out_bytes, src_bytes, _ = kc.work(a)
    assert out_bytes == 3 * size.width * size.height * 4
    assert src_bytes == want
    if dsize == (64, 36):
        assert rows.size == H // 3 and cols.size == W // 3


# --- the kernel's host logic: per-axis walks, instances, pixels, taps read ----


def _all_cases():
    """C1-C8 at two sizes and two sets of values, and the other compositions."""
    out = {}
    for size in ((90, 160), (108, 192)):
        f = cc.frames(*size, 7)
        for values in (0, 1):
            for name, ops in cc.cases(T, f, values).items():
                out[f"{name}_{size[0]}_{values}"] = ops
    out.update(cc.more_cases(T))
    return out


@pytest.mark.parametrize("name", list(_all_cases()))
def test_each_axis_walked_alone_reads_the_sectors_the_taps_read(name):
    """``csrc/composed.cuh`` walks a tap's column and its row through the
    stages on their own (``walk_axis``) and takes as its fill the outer of
    the two axes' first CONSTANT borders; ``work()`` counts a resize's or a
    one-pixel read's sectors the same way, from the tap tables, the weights
    and the block (``_read_sectors``). Both read exactly the base positions
    the plain version's 2-D walk of every tap reads (``_walked_sectors``):
    the same 32-byte sectors."""
    p = T.build_pipeline(*_all_cases()[name])
    a = kc.prepare(p, kc.build_plan(p), CPU)
    if a.plan.core == "warp":  # counted from the plain version's walk itself
        assert kc.work(a)[1] == kc._walked_sectors(a) > 0
        return
    assert kc._read_sectors(a) == kc._walked_sectors(a) > 0
    assert kc.work(a)[1] == kc._read_sectors(a)


def test_each_source_dtype_has_its_instance():
    """uint8 images, float32 and int32 images (int32 read as float32's
    words) and NV12 buffers have instances of their own, the six other
    dtypes share one (``cc.INSTANCES``); each instance's file is compiled
    into the library, and every source dtype's plan carries the type code
    from which the C entry chooses the instance, in the lower stage list's
    ``PwHead::src_type`` word. A resample takes 4 taps a pixel, a one-pixel
    read 1."""
    from cvgpuspeedup_tpu_torch.exec import _build
    from cvgpuspeedup_tpu_torch.exec.cuda_batch_resize import SRC_CODES, SRC_DTYPES

    csrc = _build.PACKAGE_DIR / "csrc"
    assert set(cc.INSTANCES) == {str(d)[6:] for d in SRC_DTYPES.values()}
    for src in {*cc.INSTANCES.values(), "composed_nv12.cu"}:
        assert csrc / src in _build.SOURCES, src
    f = cc.frames(H, W, 8)
    for name, want in (("c1_roi_crop_resize", ("composed.cu", 4)),
                       ("c6_crop_batch", ("composed.cu", 1)),
                       ("c8_nv12_to_u8_resize", ("composed_nv12.cu", 4))):
        assert cc.instance(kc.build_plan(T.build_pipeline(*cc.cases(T, f)[name]))) == want
    for dtype in SRC_DTYPES.values():
        g = {**f, "big": torch.from_numpy(f["big"]).to(dtype)}
        plan = kc.build_plan(T.build_pipeline(*cc.cases(T, g)["c4_warp_of_a_crop"]))
        assert plan.src_dtype == dtype
        assert plan.head[4] == SRC_CODES[dtype]
        assert cc.instance(plan) == (cc.INSTANCES[str(dtype)[6:]], 4)


def test_pixels_per_thread_follows_the_warp_kernel_s_rule():
    """A one-pixel read takes 4 adjacent pixels a thread where a thread per
    4 pixels still fills half of the card's resident threads (an H100: 132
    SMs x 2048), else 1; a resample (4 taps) takes 1 at every size: of
    chip_smoke's C1-C8, C6's 16 crops and C7's gray crop take 4, the
    resizes and the warp 1. The card's tests launch at sizes on both sides
    of the rule (``test_torch_cuda_composed.py::LARGE``)."""
    import sys

    from cvgpuspeedup_tpu_torch.exec import _build

    h100 = 132 * 2048
    assert cc.pixels_per_thread(2 * h100, h100) == 4
    assert cc.pixels_per_thread(2 * h100 - 1, h100) == 1
    assert cc.pixels_per_thread(20 * h100, h100, taps=4) == 1
    sys.path.insert(0, str(_build.PACKAGE_DIR.parent))
    import chip_smoke as cs

    frame = np.zeros((cs.SRC_H, cs.SRC_W, 3), np.uint8)
    hd = np.zeros((cs.FRAME_H, cs.FRAME_W, 3), np.uint8)
    nv12 = np.zeros((cs.NV12_H * 3 // 2, cs.NV12_W), np.uint8)
    got = {}
    for name, ops in cs.composed_cases(T, frame, hd, nv12).items():
        plan = kc.build_plan(T.build_pipeline(*ops))
        got[name[:2]] = cc.pixels_per_thread(plan.n_planes * plan.dsize[0] * plan.dsize[1], h100,
                                             cc.instance(plan)[1])
    assert got == {"c1": 1, "c2": 1, "c3": 1, "c4": 1, "c5": 1, "c6": 4, "c7": 4, "c8": 1}


@pytest.mark.parametrize("dsize", [(64, 36), (80, 45), (67, 31)])
def test_the_taps_a_resize_loads_follow_its_weights(dsize):
    """``tap_need``: a resize loads its first tap always; under the edge
    rule a weight of 0 takes the first tap alone, so the second column's
    taps (bits 1, 3) drop where the column's weight is 0 and the second
    row's (bits 2, 3) where the row's is; without the rule it loads all
    four. At 3:1 every output loads one tap, at 67 x 31 all four."""
    from cvgpuspeedup_tpu_torch.ops.resize import axis_taps, keeps_edge_weight

    keep = keeps_edge_weight(H, W, T.Size(*dsize))
    wx = torch.from_numpy(axis_taps(W, dsize[0], keep)[2].astype(np.float32))[None, :]
    wy = torch.from_numpy(axis_taps(H, dsize[1], keep)[2].astype(np.float32))[:, None]
    need = kc.tap_need(wx, wy, keep)
    ux, uy = ~(keep & (wx == 0)), ~(keep & (wy == 0))
    assert torch.equal(need & 1, torch.ones_like(need))
    assert torch.equal((need >> 1 & 1).bool(), ux.expand_as(need))
    assert torch.equal((need >> 2 & 1).bool(), uy.expand_as(need))
    assert torch.equal((need >> 3 & 1).bool(), (ux & uy).expand_as(need))
    if dsize == (64, 36):
        assert bool((need == 1).all())
    if dsize == (67, 31):
        assert not keep and bool((need == 15).all())
