"""The pointwise slice: every pipeline whose head reads one source pixel per
output pixel, the port against the JAX package and OpenCV.

Each case is built with the JAX factories from one numpy input and carried
across with ``from_jax``. The port (``execute_operations(device="cpu")`` and
the kernel's plain version through its wrapper, ``cuda_pointwise.run``) must
equal the reference's op-by-op lowering (``Pipeline.lower()`` outside jit)
bit for bit, and its jitted XLA path within 1e-4 (integers within 1): XLA
contracts multiply-adds into FMAs on the CPU (ROADMAP §3). The 200-op
multiply-add chain amplifies such an ulp, so it is held against the
op-by-op lowering only. Crops and borders move values without arithmetic:
they equal cv2 and the jitted path bit for bit.
"""

import cv2
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # only named: the routing tests decide on shapes
F32_TOL = 1e-4               # against the jitted XLA path, on values up to a few hundred
DTYPES = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16, "i16": np.int16, "f32": np.float32}
CV_MODE = {"CONSTANT": cv2.BORDER_CONSTANT, "REPLICATE": cv2.BORDER_REPLICATE,
           "REFLECT": cv2.BORDER_REFLECT, "REFLECT_101": cv2.BORDER_REFLECT_101,
           "WRAP": cv2.BORDER_WRAP}


def _src(shape, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.integers(-300, 600, shape) / np.float32(3)).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _arrays(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out]


def _hold(*jops, xla_tol=F32_TOL, xla=True):
    """Run the reference pipeline ``jops`` op by op and jitted, and its
    counterpart through the port's executor and the kernel's wrapper; hold
    them together. Returns the port's first output."""
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    plan = kp.build_plan(p)
    lowered = _arrays(jp.lower())
    eager = _arrays(T.execute_operations(p.read, *p.compute, p.write, device="cpu"))
    assert T.last_backend() == "torch"
    plain = _arrays(kp.run(p, plan, CPU))
    for e, w, l in zip(eager, plain, lowered, strict=True):
        assert e.shape == l.shape and e.dtype == l.dtype, (e.shape, e.dtype, l.shape, l.dtype)
        np.testing.assert_array_equal(e, l)
        np.testing.assert_array_equal(w, l)
    if xla:
        jitted = _arrays(J.execute_operations(*jops, backend=J.ParBackend.XLA))
        for e, x in zip(eager, jitted, strict=True):
            # the float contract is 1e-4 on values of 0..255; larger values scale it
            tol = xla_tol * max(1.0, float(np.abs(x).max()) / 255) if e.dtype.kind == "f" else 1
            assert np.abs(e.astype(np.float64) - x.astype(np.float64)).max() <= tol
    return eager[0], plan


CHAINS = {
    "scale_shift": lambda M: (M.multiply(1.5), M.add(-3.25)),
    "to_f32_normalize": lambda M: (M.convert_to(np.float32, alpha=1 / 255.0),
                                   M.subtract((0.485, 0.456, 0.406)),
                                   M.divide((0.229, 0.224, 0.225))),
    "gray": lambda M: (M.cvt_color(M.ColorConversionCode.COLOR_RGB2GRAY),),
}


@pytest.mark.parametrize("chain", CHAINS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head", ["image", "stack", "packed_rows"])
def test_image_heads(head, dtype, chain):
    dt_ = DTYPES[dtype]
    if head == "image":
        read, write = J.image(_src((9, 14, 3), dt_, 1)), J.split_tensor()
    elif head == "stack":
        read, write = J.image(_src((3, 6, 10, 3), dt_, 2)), J.split_tensor()
    else:
        read, write = J.image(_src((9, 14 * 3), dt_, 3), channels=3), J.write()
    out, plan = _hold(read, *CHAINS[chain](J), write)
    assert plan.base == "image" and plan.batch == (head == "stack")
    assert plan.src_dtype == T._dt.to_torch_dtype(dt_)


@pytest.mark.parametrize("write", ["write_tensor", "split_tensor", "split_tensor_transposed",
                                   "split_tensor_packed", "split"])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_every_batched_write_layout(dtype, write):
    stack = _src((3, 8, 12, 3), DTYPES[dtype], 4)
    _, plan = _hold(J.image(stack), J.cvt_color(J.ColorConversionCode.COLOR_RGB2BGRA),
                    J.convert_to(np.float32, alpha=0.5), getattr(J, write)())
    assert plan.out_ch == 4 and plan.out_dtype == torch.float32


@pytest.mark.parametrize("write", ["write", "split_tensor", "split"])
def test_every_single_write_layout(write):
    _hold(J.image(_src((7, 9, 4), np.uint8, 5)), J.vector_reorder(3, 1, 2, 0),
          J.convert_to(np.int16, alpha=-2.0, beta=7.0), getattr(J, write)())


@pytest.mark.parametrize("dst", DTYPES)
@pytest.mark.parametrize("src", DTYPES)
def test_convert_to_between_every_pair_of_dtypes(src, dst):
    """``convert_to`` saturates: round half to even, then clamp; with a scale
    it computes in float32."""
    img = _src((6, 8, 3), DTYPES[src], 6)
    _, plan = _hold(J.image(img), J.convert_to(DTYPES[dst]), J.write())
    assert plan.out_dtype == T._dt.to_torch_dtype(DTYPES[dst])
    _hold(J.image(img), J.convert_to(DTYPES[dst], alpha=0.37, beta=-4.5), J.multiply(1.25),
          J.write())


def test_int16_negative_saturate():
    """The reference's ``test_api_edges.py::test_int16_negative_saturate``."""
    img = (np.random.default_rng(7).standard_normal((16, 16, 3)) * 40000).astype(np.float32)
    out, plan = _hold(J.image(img), J.convert_to(np.int16), J.write())
    assert plan.out_dtype == torch.int16
    np.testing.assert_array_equal(out, np.clip(np.rint(img), -32768, 32767).astype(np.int16))


def test_mad_chain_of_200_ops_equals_the_op_by_op_lowering():
    """The reference's stress chain (``benchmarks/vertical_fusion.py``) on
    64x64: nested static loops of multiply and add, each rounded once."""
    mad = J.fuse(J.multiply(1.0009), J.add(0.0001))
    chain = J.static_loop(J.static_loop(mad, 10), 10)
    img = _src((64, 64, 1), np.float32, 8)
    out, plan = _hold(J.image(img), chain, J.write(), xla=False)
    assert plan.ops.shape == (200, 4) and plan.n_block == 2
    want = img.copy()
    for _ in range(100):
        want = want * np.float32(1.0009) + np.float32(0.0001)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("ascendent", [True, False])
@pytest.mark.parametrize("first", [-9, -1, 0, 3, 11])
def test_ring_reads_from_a_runtime_first(first, ascendent):
    ring = _src((4, 6, 8, 3), np.uint8, 9)
    out, plan = _hold(J.circular_batch_read(ring, first=first, ascendent=ascendent),
                      J.convert_to(np.float32, alpha=0.3), J.subtract((1.0, 2.0, 3.0)),
                      J.write_tensor())
    assert plan.base == "circ"
    for z in range(4):
        src = ring[((first + z) if ascendent else (first - z)) % 4].astype(np.float32)
        np.testing.assert_array_equal(
            out[z], src * np.float32(0.3) - np.array([1, 2, 3], np.float32))


@pytest.mark.parametrize("rect", [(0, 0, 5, 4), (3, 2, 5, 4), (-3, -2, 5, 4), (-100, 1, 5, 4),
                                  (100, 100, 5, 4), (7, 6, 5, 4), (-12, -10, 5, 4),
                                  (-1, -1, 12, 10)])
@pytest.mark.parametrize("batched", [False, True])
def test_crop_origins(batched, rect):
    """Negative origins count from the far edge, then the start clamps to
    ``[0, length - size]``, single and batched (``ops/crop.py::crop_start``)."""
    img = _src((3, 10, 12, 2) if batched else (10, 12, 2), np.uint8, 10)
    out, plan = _hold(J.crop(J.image(img), J.Rect(*rect)),
                      J.write_tensor() if batched else J.write(), xla_tol=0)
    assert plan.head[9] == 1 and plan.dsize == T.Size(rect[2], rect[3])


@pytest.mark.parametrize("mode", list(CV_MODE))
def test_borders_equal_cv2(mode):
    """``tests/test_border.py::test_make_border_vs_cv2``'s case, and a
    per-channel value."""
    img = _src((10, 14, 3), np.uint8, 11)
    out, _ = _hold(J.make_border(img, 3, 2, 4, 1, mode=J.BorderMode[mode], value=7), J.write(),
                   xla_tol=0)
    np.testing.assert_array_equal(
        out, cv2.copyMakeBorder(img, 3, 2, 4, 1, CV_MODE[mode], value=(7, 7, 7)))
    out, _ = _hold(J.make_border(img, 0, 5, 2, 0, mode=J.BorderMode[mode], value=(1, 20, 250)),
                   J.convert_to(np.float32, alpha=0.5), J.split_tensor())
    ref = cv2.copyMakeBorder(img, 0, 5, 2, 0, CV_MODE[mode], value=(1, 20, 250))
    np.testing.assert_array_equal(out, ref.astype(np.float32).transpose(2, 0, 1) * 0.5)


@pytest.mark.parametrize("mode", ["REPLICATE", "REFLECT", "REFLECT_101", "WRAP"])
def test_borders_wider_than_the_source_fold_as_numpy_pad(mode):
    img = _src((3, 4, 1), np.uint8, 12)
    out, _ = _hold(J.make_border(img, 7, 10, 9, 13, mode=J.BorderMode[mode]), J.write(), xla_tol=0)
    pad = {"REPLICATE": "edge", "REFLECT": "symmetric", "REFLECT_101": "reflect", "WRAP": "wrap"}
    np.testing.assert_array_equal(out, np.pad(img, ((7, 10), (9, 13), (0, 0)), mode=pad[mode]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_constant_border_value_is_cast_to_the_sources_dtype(dtype):
    img = _src((6, 9, 3), DTYPES[dtype], 13)
    _hold(J.make_border(img, 2, 3, 1, 4, mode=J.BorderMode.CONSTANT, value=(1.0, 2.9, 120.0)),
          J.convert_to(np.float32, alpha=0.5), J.write())


def test_border_over_crop_over_ring_nests_as_lower_does():
    ring = _src((4, 10, 12, 3), np.uint8, 14)
    head = J.make_border(J.crop(J.circular_batch_read(ring, first=2), J.Rect(3, -4, 6, 5)),
                         2, 1, 3, 2, mode=J.BorderMode.REFLECT_101)
    out, plan = _hold(head, J.convert_to(np.float32, alpha=1 / 255.0), J.split_tensor())
    assert plan.head[9] == 2 and out.shape == (4, 3, 8, 11)
    inner = J.make_border(_src((7, 9, 3), np.uint8, 15), 2, 2, 2, 2, mode=J.BorderMode.REFLECT)
    outer = J.make_border(inner, 3, 3, 3, 3, mode=J.BorderMode.CONSTANT, value=(9.0, 8.0, 7.0))
    _hold(J.crop(outer, J.Rect(1, 2, 15, 12)), J.write(), xla_tol=0)


@pytest.mark.parametrize("fmt", ["NV12", "NV21"])
@pytest.mark.parametrize("color_range", ["FULL", "LIMITED"])
@pytest.mark.parametrize("standard", ["BT601", "BT709"])
@pytest.mark.parametrize("out_dtype,alpha", [(np.uint8, True), (np.uint8, False),
                                             (np.float32, True)])
def test_bare_nv12_conversion(out_dtype, alpha, standard, color_range, fmt):
    """The camera preset without a resize: ``read_yuv`` and
    ``convert_yuv_to_rgb`` alone, the conversion in the reference's op order."""
    buf = _src((12, 10), np.uint8, 16)
    out, plan = _hold(
        J.read_yuv(buf, pixel_format=J.PixelFormat[fmt]),
        J.convert_yuv_to_rgb(color_range=J.ColorRange[color_range],
                             standard=J.ColorStandard[standard], alpha=alpha,
                             out_dtype=out_dtype), J.write())
    assert plan.base == "yuv" and plan.head[10] == 1 and out.shape == (8, 10, 4 if alpha else 3)


def test_a_fused_read_at_the_top_is_its_read_and_the_head_of_the_chain():
    buf = _src((12, 10), np.uint8, 17)
    fused = J.fuse(J.read_yuv(buf), J.convert_yuv_to_rgb(out_dtype=np.float32))
    _, plan = _hold(fused, J.multiply(1 / 255.0), J.split_tensor())
    assert plan.base == "yuv" and plan.ops.shape[0] == 1
    img = _src((6, 8, 3), np.uint8, 18)
    _, plan = _hold(J.fuse(J.image(img), J.convert_to(np.float32, alpha=2.0)), J.add(1.0),
                    J.write())
    assert plan.ops.shape[0] == 2


@pytest.mark.parametrize("case,reason", [
    ("int32_source", "source dtype int32"), ("float64_source", "source dtype float64"),
    ("int32_cast", "cast to torch.int32"), ("float64_scalar", "scalar is float64"),
    ("resize", "more than one source pixel"), ("five_channels", "5 channels"),
    ("fused_read_under_a_crop", "FusedRead"), ("five_stages", "nests 4"),
    ("tensor_write_of_one_frame", "write TensorWrite"), ("yuv_mid_chain", "no op code"),
])
def test_build_plan_refuses_with_a_reason(case, reason):
    img = _src((8, 10, 3), np.uint8, 19)
    nested = T.image(img)
    for _ in range(5):
        nested = T.make_border(nested, 1, 1, 1, 1)
    ops = {
        "int32_source": (T.image(img.astype(np.int32)), T.multiply(2.0)),
        "float64_source": (T.image(img.astype(np.float64)), T.multiply(2.0)),
        "int32_cast": (T.image(img), T.convert_to(np.int32)),
        "float64_scalar": (T.image(img), T.Mul(value=np.float64(2.0))),
        "resize": (T.resize(T.image(img), T.Size(4, 4)),),
        "five_channels": (T.image(_src((4, 4, 5), np.uint8)),),
        "fused_read_under_a_crop": (T.crop(T.fuse(T.image(img), T.multiply(2.0)),
                                           T.Rect(0, 0, 4, 4)),),
        "five_stages": (nested,),
        "tensor_write_of_one_frame": (T.image(img), T.write_tensor()),
        "yuv_mid_chain": (T.image(img), T.multiply(1.0), T.convert_yuv_to_rgb()),
    }[case]
    pipeline = T.build_pipeline(*ops)
    assert not kp.supports(pipeline)
    with pytest.raises(kp.Unsupported, match=reason):
        kp.build_plan(pipeline)


HEADS = {
    "image": lambda a: T.image(a((9, 14, 3))),
    "stack": lambda a: T.image(a((3, 6, 10, 3))),
    "ring": lambda a: T.circular_batch_read(a((3, 6, 10, 3)), first=1),
    "crop": lambda a: T.crop(T.image(a((9, 14, 3))), T.Rect(1, 2, 5, 4)),
    **{f"border_{m.name.lower()}": (lambda a, m=m: T.make_border(T.image(a((9, 14, 3))),
                                                                 1, 2, 3, 4, m))
       for m in T.BorderMode},
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head", HEADS)
def test_describe_backend_on_the_meta_path(head, dtype):
    """Leaves on the meta device have shapes and dtypes and nothing else: the
    backend is decided from the structure, so ``describe_backend`` answers
    for the card without one."""
    def on_meta(shape):
        return torch.empty(shape, dtype=T._dt.to_torch_dtype(DTYPES[dtype]), device="meta")

    ops = (HEADS[head](on_meta), T.multiply(1.5), T.add(-3.25))
    pipeline = T.build_pipeline(*ops)
    assert executor._select(pipeline, T.ParBackend.AUTO, CUDA).backend == "cuda:pointwise"
    assert executor._select(pipeline, T.ParBackend.CUDA, CUDA).backend == "cuda:pointwise"
    assert executor._select(pipeline, T.ParBackend.AUTO, CPU).backend == "torch"


def test_bare_nv12_and_what_stays_eager_on_the_meta_path():
    buf = torch.empty((12, 10), dtype=torch.uint8, device="meta")
    nv12 = T.build_pipeline(T.read_yuv(buf), T.convert_yuv_to_rgb())
    assert executor._select(nv12, T.ParBackend.AUTO, CUDA).backend == "cuda:pointwise"
    for dtype in (torch.int32, torch.int64, torch.float16, torch.float64):
        p = T.build_pipeline(T.image(torch.empty((4, 4, 3), dtype=dtype, device="meta")),
                             T.multiply(2.0))
        assert executor._select(p, T.ParBackend.AUTO, CUDA).backend == "torch"
        with pytest.raises(ValueError, match="cuda:pointwise: source dtype"):
            executor._select(p, T.ParBackend.CUDA, CUDA)


def test_new_values_build_no_plan_and_prepare_packs_them_in_order():
    """``first``, crop origins, border values and scalars are leaves: the
    block holds them in the head's order."""
    ring = torch.from_numpy(_src((4, 10, 12, 3), np.uint8, 20))

    def ops(first, x, y, value, scale):
        head = T.make_border(T.crop(T.circular_batch_read(ring, first=first), T.Rect(x, y, 6, 5)),
                             1, 1, 1, 1, T.BorderMode.CONSTANT, value=value)
        return (head, T.convert_to(np.float32, alpha=scale), T.write_tensor())

    p = T.build_pipeline(*ops(2, 3, -4, (1.0, 2.0, 3.0), 0.5))
    plan = kp.build_plan(p)
    a = kp.prepare(p, plan, CPU)
    assert a.block.dtype == torch.int32 and a.block.numel() == plan.n_block == 7
    blk = a.block.numpy()  # first, then the border (outermost), then the crop
    np.testing.assert_array_equal(blk[1:4].view(np.float32), [1.0, 2.0, 3.0])
    assert (int(blk[0]), int(blk[4]), int(blk[5])) == (2, 3, -4)
    assert float(blk[6:7].view(np.float32)[0]) == 0.5 and plan.fp_off == 6
    T.execute_operations(*ops(2, 3, -4, (1.0, 2.0, 3.0), 0.5), device="cpu")
    builds = executor.PLAN_BUILDS
    out = T.execute_operations(*ops(-1, 0, 9, (7.0, 8.0, 9.0), 2.0), device="cpu")
    assert executor.PLAN_BUILDS == builds
    assert out.shape == (4, 7, 8, 3) and float(out[0, 0, 0, 2]) == 18.0
    assert flattened_keys_equal(ops(2, 3, -4, (1.0, 2.0, 3.0), 0.5),
                                ops(-1, 0, 9, (7.0, 8.0, 9.0), 2.0))


def flattened_keys_equal(a, b):
    from cvgpuspeedup_tpu_torch.graph import flatten

    return flatten(T.build_pipeline(*a))[0] == flatten(T.build_pipeline(*b))[0]


@pytest.mark.parametrize("kernel", ["pointwise", "frame_resize", "batch_resize", "warp"])
def test_out_views_on_the_cpu(kernel):
    """``out=`` on a CPU tensor: the plain version's result lands in the
    caller's strided view, cast as ``astype`` casts; a wrong shape raises."""
    from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
    from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
    from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw

    img = _src((24, 32, 3), np.uint8, 21)
    rects = np.array([[i, i, 10, 12] for i in range(3)], np.int32)
    module, ops = {
        "pointwise": (kp, (T.image(img), T.convert_to(np.float32, alpha=1.7), T.add(-70.25))),
        "frame_resize": (kfr, (T.resize(T.image(img), T.Size(8, 6)), T.add(-70.25))),
        "batch_resize": (kbr, (T.resize_batch(img, rects=rects, dsize=T.Size(8, 6)),
                               T.add(-70.25))),
        "warp": (kw, (T.warp(T.image(img), np.array([[0.5, 0, 1.0], [0, 0.5, 2.0]]), T.Size(8, 6)),
                      T.add(-70.25))),
    }[kernel]
    pipeline = T.build_pipeline(*ops, T.split_tensor())
    plan = module.build_plan(pipeline)
    want = module.run(pipeline, plan, CPU)
    for dtype in (torch.float32, torch.uint8, torch.int16):
        host = torch.full(tuple(want.shape[:-1]) + (want.shape[-1] + 3,), 77, dtype=dtype)
        view = host[..., 1:-2]
        assert module.run(pipeline, plan, CPU, out=view) is view
        assert torch.equal(view, T._dt.astype(want, dtype))
        assert bool((host[..., 0] == 77).all()) and bool((host[..., -2:] == 77).all())
    with pytest.raises(ValueError, match="out holds"):
        module.run(pipeline, plan, CPU, out=torch.empty(want.shape[1:]))
    assert module.can_store(plan, torch.float32) and not module.can_store(plan, torch.int32)
    # a float32 chain into an integer buffer is one store in every kernel:
    # clamped, then truncated; a uint8 chain into another integer wraps, which
    # no store does
    ints = (torch.uint8, torch.int8, torch.uint16, torch.int16)
    assert all(module.can_store(plan, dtype) for dtype in ints)
    u8_plan = module.build_plan(T.build_pipeline(*ops, T.convert_to(np.uint8), T.split_tensor()))
    assert u8_plan.out_dtype == torch.uint8
    assert [module.can_store(u8_plan, dtype) for dtype in ints] == [True, False, False, False]
