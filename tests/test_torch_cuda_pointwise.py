"""The pointwise kernel on the card, at small sizes, and the wrappers'
``out=``: what ``chip_smoke.py`` phases 3 and 4 check at full sizes. Needs a
CUDA device and skips without one. On a machine with a card and without jax,
run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_pointwise.py

Every output must equal the plain version bit for bit, whatever its dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
from cvgpuspeedup_tpu_torch.exec import executor

pytestmark = pytest.mark.gpu

DTYPES = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16, "i16": np.int16, "f32": np.float32}
C = T.ColorConversionCode


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _source(cuda, shape, dtype=np.uint8, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        a = (rng.integers(-300, 600, shape) / np.float32(3)).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max + 1, shape).astype(dtype)
    return torch.from_numpy(a).to(cuda)


def _odd(t):
    """``t``'s values in a view one element past an aligned address."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def _same(got, want):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        if g.dtype.is_floating_point:
            assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w), f"{int((g != w).sum())} values differ"


def _check(*ops, cuda):
    pipeline = T.build_pipeline(*ops)
    a = kp.prepare(pipeline, kp.build_plan(pipeline), cuda)
    _same(kp.pointwise(a), kp.pointwise_reference(a))
    return a


def _head(kind, cuda, dtype=np.uint8, seed=1):
    """One read of each head, small; launches of 360,448 outputs and more
    take 4 pixels per thread on an H100, these take 1."""
    if kind == "image":
        return T.image(_source(cuda, (37, 61, 3), dtype, seed))
    if kind == "stack":
        return T.image(_source(cuda, (5, 24, 36, 3), dtype, seed))
    if kind == "circ":
        return T.circular_batch_read(_source(cuda, (5, 24, 36, 3), dtype, seed), first=seed - 4,
                                     ascendent=False)
    if kind == "crop":
        return T.crop(T.image(_source(cuda, (37, 61, 3), dtype, seed)),
                      T.Rect(7 * seed - 20, 90 - 50 * seed, 33, 20))
    if kind in T.BorderMode.__members__:
        return T.make_border(T.image(_source(cuda, (37, 61, 3), dtype, seed)), 3, 40, 70, 5,
                             T.BorderMode[kind], value=(seed, 20.0, 100.0))
    raise KeyError(kind)


HEADS = ["image", "stack", "circ", "crop", *T.BorderMode.__members__]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", HEADS)
def test_every_head_in_every_dtype_is_one_launch(kind, dtype, cuda):
    """AUTO takes the pointwise kernel for an image chain, a stack, a ring, a
    crop and each border mode in uint8, int8, uint16, int16 and float32: one
    launch per call, no plan for new values, equal to the eager version."""
    batched = kind in ("stack", "circ")
    chain = (T.multiply(1.5), T.add(-3.25), T.split_tensor() if batched else T.write())

    def call(seed):
        return T.execute_operations(_head(kind, cuda, DTYPES[dtype], seed), *chain)

    first = call(1)
    assert T.last_backend() == "cuda:pointwise"
    launches, builds = kp.LAUNCHES, executor.PLAN_BUILDS
    out = call(2)
    assert T.last_backend() == "cuda:pointwise"
    assert kp.LAUNCHES == launches + 1 and executor.PLAN_BUILDS == builds
    assert not torch.equal(first, out)
    _same(out, T.execute_operations(_head(kind, cuda, DTYPES[dtype], 2), *chain,
                                    backend=T.ParBackend.TORCH))
    assert T.describe_backend(_head(kind, cuda, DTYPES[dtype], 2), *chain,
                              backend=T.ParBackend.CUDA) == "cuda:pointwise"


def _cases(cuda):
    big = _source(cuda, (540, 961, 3), seed=3)            # 519,000 outputs: 4 pixels per thread
    ring = _source(cuda, (16, 128, 253, 3), seed=4)
    nv12 = _source(cuda, (720 * 3 // 2, 1280), seed=5)
    small_nv12 = _source(cuda, (36, 40), seed=6)
    f4 = _source(cuda, (300, 500, 4), np.float32, seed=7)
    normalize = (T.convert_to(np.float32, alpha=1 / 255.0), T.subtract((0.485, 0.456, 0.406)),
                 T.divide((0.229, 0.224, 0.225)))
    mad = T.static_loop(T.fuse(T.multiply(1.0009765625), T.add(0.001)), 100)
    long_mad = T.static_loop(T.fuse(T.multiply(1.0009765625), T.add(0.001)), 150)
    return {
        "p4_mad_200_ops": (T.image(_source(cuda, (640, 641, 1), np.float32, 8)), mad, T.write()),
        "p1_mad_200_ops": (T.image(_source(cuda, (64, 64, 1), np.float32, 9)), mad, T.write()),
        "p4_odd_address_planar": (T.image(_odd(big)), *normalize, T.split_tensor()),
        "p4_packed_out_gray": (T.image(big), T.cvt_color(C.COLOR_BGR2GRAY), T.write()),
        "p4_ring_rows_of_253_two_op_chain": (
            T.circular_batch_read(_odd(ring), first=3), T.convert_to(np.float32, alpha=0.3),
            T.subtract((1.0, 2.0, 3.0)), T.split_tensor()),
        "p4_ring_descending_tsplit": (
            T.circular_batch_read(ring, first=-5, ascendent=False), T.multiply(1.7),
            T.split_tensor_transposed()),
        "p4_ring_split_packed": (T.circular_batch_read(ring, first=7),
                                 T.convert_to(np.float32), T.split_tensor_packed()),
        "p4_ring_split_write": (T.circular_batch_read(ring, first=1), T.split()),
        "p4_f32_rgba_to_u8_planar": (T.image(f4), T.convert_to(np.uint8, alpha=0.9),
                                     T.split_tensor()),
        "p4_border_wider_than_the_source": (
            T.make_border(T.image(_source(cuda, (37, 61, 3), seed=10)), 200, 300, 400, 500,
                          T.BorderMode.REFLECT_101), T.write()),
        "p4_wrap_wider_than_the_source": (
            T.make_border(T.image(_source(cuda, (37, 61, 3), seed=10)), 200, 300, 400, 500,
                          T.BorderMode.WRAP), T.split_tensor()),
        "p4_nv12_rgba_u8": (T.read_yuv(nv12), T.convert_yuv_to_rgb(alpha=True)),
        "p4_nv21_limited_bt709_f32_planar": (
            T.read_yuv(_odd(nv12), T.PixelFormat.NV21),
            T.convert_yuv_to_rgb(T.ColorRange.LIMITED, T.ColorStandard.BT709, out_dtype=np.float32),
            T.multiply(1 / 255.0), T.split_tensor()),
        "nv12_fused_read_small": (T.fuse(T.read_yuv(small_nv12),
                                         T.convert_yuv_to_rgb(T.ColorRange.LIMITED)), T.split()),
        "nv12_crop_then_convert_i16": (
            T.crop(T.read_yuv(small_nv12), T.Rect(-7, 3, 10, 9)),
            T.convert_yuv_to_rgb(out_dtype=np.int16, alpha=True), T.multiply(-3.0), T.write()),
        "border_over_crop_over_ring": (
            T.make_border(T.crop(T.circular_batch_read(ring, first=2), T.Rect(30, -40, 60, 50)),
                          2, 1, 3, 2, T.BorderMode.REFLECT), *normalize, T.split_tensor()),
        "crop_over_constant_over_reflect": (
            T.crop(T.make_border(T.make_border(T.image(_source(cuda, (37, 61, 3), seed=11)), 2, 2,
                                               2, 2, T.BorderMode.REFLECT),
                                 3, 3, 3, 3, T.BorderMode.CONSTANT, value=(9.0, 8.0, 7.0)),
                   T.Rect(1, 2, 60, 40)), T.write()),
        "int16_negative_saturate": (T.image(_source(cuda, (16, 16, 3), np.float32, 12) * 200),
                                    T.convert_to(np.int16), T.write()),
        "u16_to_i8_saturate_then_scale": (T.image(_source(cuda, (33, 21, 4), np.uint16, 13)),
                                          T.convert_to(np.int8, alpha=1 / 300.0, beta=-90.0),
                                          T.multiply(1.5), T.split_tensor()),
        "i16_gray_alpha": (T.image(_source(cuda, (33, 21, 3), np.int16, 14)),
                           T.cvt_color(C.COLOR_RGB2RGBA), T.cvt_color(C.COLOR_BGRA2GRAY),
                           T.write()),
        "truncating_cast_u16": (T.image(_source(cuda, (20, 31, 3), np.float32, 15).abs() * 100),
                                T.Cast(dst=torch.uint16), T.write()),
        "packed_rows_image": (T.image(_source(cuda, (37, 61 * 3), seed=16), channels=3),
                              T.vector_reorder(2, 0, 1), T.split()),
        "gray_2d_image": (T.image(_source(cuda, (12, 20), seed=17)), T.multiply(2.0), T.write()),
        # the staged chain: 300 rows in two chunks, four lanes and one; the
        # chain's width changing part way; one-lane groups of 16 with a
        # row's tail (1,444,803 outputs) in uint8, int16 and at an odd address
        "long_chain_300_rows_rgb": (T.image(big), T.convert_to(np.float32), long_mad,
                                    T.split_tensor()),
        "long_chain_300_rows_1ch": (T.image(_source(cuda, (300, 301, 1), np.float32, 18)),
                                    long_mad, T.write()),
        "rgb_rgba_multiply_rgb": (T.image(big), T.cvt_color(C.COLOR_RGB2RGBA),
                                  T.convert_to(np.float32, alpha=0.5),
                                  T.multiply((1.0, 2.0, 0.5, 3.0)), T.cvt_color(C.COLOR_RGBA2RGB),
                                  T.split_tensor()),
        "rgba_gray_long_tail": (T.image(f4), T.cvt_color(C.COLOR_RGBA2GRAY), long_mad, T.write()),
        "groups_of_16_u8_tail": (T.image(_source(cuda, (1201, 1203, 1), seed=19)),
                                 T.multiply(1.5), T.add(-20.25), T.write()),
        "groups_of_16_i16_tail_planar": (T.image(_source(cuda, (1201, 1203, 1), np.int16, 20)),
                                         T.convert_to(np.float32, alpha=0.5), T.split_tensor()),
        "groups_of_16_odd_address": (T.image(_odd(_source(cuda, (1201, 1203, 1), np.float32, 21))),
                                     T.multiply(0.25), T.write()),
        "nv12_rgb_u8_words": (T.read_yuv(nv12), T.convert_yuv_to_rgb()),
    }


CASE_NAMES = [
    "p4_mad_200_ops", "p1_mad_200_ops", "p4_odd_address_planar", "p4_packed_out_gray",
    "p4_ring_rows_of_253_two_op_chain", "p4_ring_descending_tsplit", "p4_ring_split_packed",
    "p4_ring_split_write", "p4_f32_rgba_to_u8_planar", "p4_border_wider_than_the_source",
    "p4_wrap_wider_than_the_source", "p4_nv12_rgba_u8", "p4_nv21_limited_bt709_f32_planar",
    "nv12_fused_read_small", "nv12_crop_then_convert_i16", "border_over_crop_over_ring",
    "crop_over_constant_over_reflect", "int16_negative_saturate",
    "u16_to_i8_saturate_then_scale", "i16_gray_alpha", "truncating_cast_u16",
    "packed_rows_image", "gray_2d_image", "long_chain_300_rows_rgb", "long_chain_300_rows_1ch",
    "rgb_rgba_multiply_rgb", "rgba_gray_long_tail", "groups_of_16_u8_tail",
    "groups_of_16_i16_tail_planar", "groups_of_16_odd_address", "nv12_rgb_u8_words"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_kernel_matches_plain_version(case, cuda):
    _check(*_cases(cuda)[case], cuda=cuda)


def test_cases_are_all_listed(cuda):
    assert sorted(_cases(cuda)) == sorted(CASE_NAMES)


@pytest.mark.parametrize("origin", [(0, 0), (-3, -2), (-100, 1), (100, 100), (56, 17), (-61, -37)])
def test_crop_origins_on_the_device_build_no_plan(origin, cuda):
    """The origin rides the block as a device tensor: never read back, no
    plan for a new one."""
    img = _source(cuda, (37, 61, 3), seed=20)

    def ops(x, y):
        rect = T.Rect(torch.tensor(x, dtype=torch.int32, device=cuda),
                      torch.tensor(y, dtype=torch.int32, device=cuda), 5, 20)
        return (T.crop(T.image(img), rect), T.convert_to(np.float32, alpha=0.5), T.write())

    T.execute_operations(*ops(1, 1))
    builds = executor.PLAN_BUILDS
    got = T.execute_operations(*ops(*origin))
    assert T.last_backend() == "cuda:pointwise" and executor.PLAN_BUILDS == builds
    _same(got, T.execute_operations(*ops(*origin), backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("what", ["int32", "float64", "int32_cast", "float64_scalar"])
def test_what_an_f32_register_cannot_hold_runs_eagerly(what, cuda):
    img = _source(cuda, (20, 30, 3), seed=21)
    ops = {
        "int32": (T.image(img.to(torch.int32)), T.multiply(2.0), T.write()),
        "float64": (T.image(img.to(torch.float64)), T.multiply(2.0), T.write()),
        "int32_cast": (T.image(img), T.convert_to(np.int32, alpha=1000.0), T.write()),
        "float64_scalar": (T.image(img.float()), T.Mul(value=np.float64(1.1)), T.write()),
    }[what]
    assert T.describe_backend(*ops) == "torch"
    T.execute_operations(*ops)
    assert T.last_backend() == "torch"
    with pytest.raises(ValueError, match="cuda:pointwise: "):
        T.execute_operations(*ops, backend=T.ParBackend.CUDA)


ORDERS = list(T.CircularTensorOrder)
LAYOUTS = list(T.ColorPlanes)


@pytest.mark.parametrize("order", ORDERS, ids=lambda o: o.name)
@pytest.mark.parametrize("planes", LAYOUTS, ids=lambda p: p.name)
@pytest.mark.parametrize("ring_dtype,head", [("f32", "resize"), ("f32", "plain"), ("f32", "crop"),
                                             ("u8", "plain"), ("u8", "crop")])
def test_ring_update_is_one_launch_into_the_slot(ring_dtype, head, planes, order, cuda):
    """One launch per update, for a resize head (the frame kernel) and for a
    plain or cropped frame (the pointwise kernel, also into a uint8 ring:
    clamped, then truncated in the store), in every layout and order; the
    ring equals a ring on the CPU. (A float32 resize into an integer ring
    keeps its two steps: the frame kernel's store does not clamp.)"""
    dtype = DTYPES[ring_dtype]
    ring = T.CircularTensor(16, 12, 3, 3, order=order, planes=planes, dtype=dtype, device=cuda)
    twin = T.CircularTensor(16, 12, 3, 3, order=order, planes=planes, dtype=dtype, device="cpu")

    def ops(frame, k):
        if head == "resize":
            return (T.resize(T.image(frame), T.Size(16, 12)),
                    T.convert_to(np.float32, alpha=1 / 255.0))
        read = T.image(frame) if head == "plain" else T.crop(T.image(frame), T.Rect(k, 2 * k, 16, 12))
        return (read, T.convert_to(np.float32, alpha=1.7), T.add(-70.25))

    shape = (12, 16, 3) if head == "plain" else (48, 64, 3)
    module = kfr if head == "resize" else kp
    frames = [_source(cuda, shape, seed=30 + k) for k in range(5)]
    ring.update(*ops(frames[0], 0))
    torch.cuda.synchronize()
    for k in range(5):
        if k:
            launches, builds = module.LAUNCHES, executor.PLAN_BUILDS
            ring.update(*ops(frames[k], k))
            assert module.LAUNCHES == launches + 1 and executor.PLAN_BUILDS == builds
            assert T.last_backend() == ("cuda:frame_resize" if head == "resize"
                                        else "cuda:pointwise")
        twin.update(*ops(frames[k].cpu(), k))
    torch.cuda.synchronize()
    assert torch.equal(ring.tensor.cpu(), twin.tensor)


def test_ring_update_allocates_no_temporary(cuda):
    """Device memory allocated by one update stays under the bytes of one
    plane: nothing of the frame's size is allocated."""
    ring = T.CircularTensor(256, 256, 3, 4, device=cuda)
    frame = _source(cuda, (256, 256, 3), seed=40)
    ops = (T.image(frame), T.convert_to(np.float32, alpha=1 / 255.0))
    ring.update(*ops)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(cuda)["allocated_bytes.all.allocated"]
    ring.update(*ops)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_stats(cuda)["allocated_bytes.all.allocated"] - before
    assert grown < 256 * 256 * 3, grown


@pytest.mark.parametrize("kernel", ["batch_resize", "frame_resize", "warp", "pointwise"])
def test_out_views_of_any_strides(kernel, cuda):
    """``out=`` a strided view: the result lands there and nowhere else, in
    the plan's dtype or float32."""
    img = _source(cuda, (96, 128, 3), seed=50)
    rects = np.array([[i, i, 30, 40] for i in range(4)], np.int32)
    to_u8 = T.convert_to(np.uint8, alpha=0.5, beta=3.0)
    module, call, ops = {
        "batch_resize": (kbr, kbr.batch_resize,
                         (T.resize_batch(img, rects=rects, dsize=T.Size(16, 24)), to_u8,
                          T.split_tensor())),
        "frame_resize": (kfr, kfr.frame_resize,
                         (T.resize(T.image(img), T.Size(32, 24)), to_u8, T.split_tensor())),
        "warp": (kw, kw.warp, (T.warp(T.image(img), np.array([[0.5, 0.0, 3.0], [0.0, 0.5, 2.0]]),
                                      T.Size(32, 24)), to_u8, T.split_tensor())),
        "pointwise": (kp, kp.pointwise, (T.image(img), to_u8, T.split_tensor())),
    }[kernel]
    pipeline = T.build_pipeline(*ops)
    a = module.prepare(pipeline, module.build_plan(pipeline), cuda)
    want = call(a)
    for dtype in (torch.uint8, torch.float32):
        host = torch.full((2,) + tuple(want.shape[:-1]) + (want.shape[-1] + 3,), 77, dtype=dtype,
                          device=cuda)
        view = host[1, ..., 1:-2]
        assert not view.is_contiguous()
        launches = module.LAUNCHES
        assert call(a, out=view) is view and module.LAUNCHES == launches + 1
        torch.cuda.synchronize()
        assert torch.equal(view, want.to(dtype))
        host[1, ..., 1:-2] = 77
        assert bool((host == 77).all())
    with pytest.raises(ValueError, match="out holds"):
        call(a, out=torch.empty(want.shape[1:], dtype=torch.uint8, device=cuda))
    with pytest.raises(TypeError):
        call(a, out=torch.empty(want.shape, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("ring_dtype", [torch.uint8, torch.int8, torch.uint16, torch.int16])
@pytest.mark.parametrize("head", ["resize", "warp"])
def test_float_chain_into_an_integer_ring_is_one_launch(head, ring_dtype, cuda):
    """A resize or warp head whose float32 chain goes into an integer ring:
    one launch of its kernel, the cast (clamp, then truncate) in the store,
    no temporary of the plane's size, every slot equal to the eager value
    cast by ``utils.dtypes.astype``."""
    module = kfr if head == "resize" else kw
    ring = T.CircularTensor(64, 48, 3, 4, dtype=ring_dtype, device=cuda)

    frames = [_source(cuda, (96, 128, 3), seed=60 + k) for k in range(4)]

    def ops(k):
        frame = frames[k]
        read = (T.resize(T.image(frame), T.Size(64, 48)) if head == "resize" else
                T.warp(T.image(frame), np.array([[0.5, 0.1, 3.0 + k], [-0.1, 0.5, 2.0]]),
                       T.Size(64, 48)))
        return read, T.multiply(600.0), T.subtract(70000.25)

    ring.update(*ops(0))
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(cuda)["allocated_bytes.all.allocated"]
    launches = module.LAUNCHES
    for k in range(1, 4):
        ring.update(*ops(k))
        assert T.last_backend() == f"cuda:{head if head == 'warp' else 'frame_resize'}"
    torch.cuda.synchronize()
    grown = torch.cuda.memory_stats(cuda)["allocated_bytes.all.allocated"] - before
    assert module.LAUNCHES == launches + 3
    assert grown < 64 * 48 * 3, grown
    for k in range(4):
        eager = T.execute_operations(*ops(k), T.split_tensor(), backend=T.ParBackend.TORCH)
        assert torch.equal(ring._ring[k], T._dt.astype(eager, ring_dtype)), k


@pytest.mark.parametrize("kernel", ["batch_resize", "frame_resize", "warp"])
def test_clamp_store_into_every_integer_dtype(kernel, cuda):
    """K1, K2 and the warp kernel store a float32 chain into uint8, int8,
    uint16 and int16 views: clamped, then truncated, equal to the plain
    version cast by ``astype``; a uint8 chain into int16 is refused."""
    img = _source(cuda, (96, 128, 3), seed=70)
    rects = np.array([[i, i, 30, 40] for i in range(4)], np.int32)
    chain = (T.multiply(600.0), T.subtract(70000.25))
    module, call, read = {
        "batch_resize": (kbr, kbr.batch_resize, T.resize_batch(img, rects=rects,
                                                               dsize=T.Size(16, 24))),
        "frame_resize": (kfr, kfr.frame_resize, T.resize(T.image(img), T.Size(32, 24))),
        "warp": (kw, kw.warp, T.warp(T.image(img), np.array([[0.5, 0.0, 3.0], [0.0, 0.5, 2.0]]),
                                     T.Size(32, 24))),
    }[kernel]
    pipeline = T.build_pipeline(read, *chain, T.split_tensor())
    a = module.prepare(pipeline, module.build_plan(pipeline), cuda)
    want = call(a)
    for dtype in (torch.uint8, torch.int8, torch.uint16, torch.int16):
        host = torch.full((2,) + tuple(want.shape[:-1]) + (want.shape[-1] + 3,), 77, dtype=dtype,
                          device=cuda)
        view = host[1, ..., 1:-2]
        launches = module.LAUNCHES
        assert call(a, out=view) is view and module.LAUNCHES == launches + 1
        torch.cuda.synchronize()
        assert torch.equal(view, T._dt.astype(want, dtype)), dtype
        host[1, ..., 1:-2] = 77
        assert bool((host == 77).all())
    u8 = T.build_pipeline(read, T.convert_to(np.uint8), T.split_tensor())
    a8 = module.prepare(u8, module.build_plan(u8), cuda)
    with pytest.raises(TypeError):
        call(a8, out=torch.empty(want.shape, dtype=torch.int16, device=cuda))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a = _check(*_cases(cuda)["gray_2d_image"], cuda=cuda)
    with pytest.raises(TypeError):
        kp.pointwise(dataclasses.replace(a, block=a.block.float()))
    with pytest.raises(ValueError):
        kp.pointwise(dataclasses.replace(a, src=a.src[:6]))
