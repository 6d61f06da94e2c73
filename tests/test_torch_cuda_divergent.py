"""The divergent kernel on the card: what ``chip_smoke.py`` phases 3 and 4
check at the reference's row sizes, here at reduced sizes for each group
kind, the seven D cases, the floor modulo of ``first``, negative rect
origins, every write layout, batches large enough for 4 pixels per thread
and groups of different output dtypes. Needs a CUDA device and skips without one.
On a machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_divergent.py

The kernel must equal its plain version bit for bit, uint8 and float32.
Groups of int8, uint16, int16, float16, int32 and int64 sources (the
general instance, ``divergent_any.cu``) are compared as their bits, float32
as int32: copies of int32 values within 200 of its bounds, every kind over
each dtype, and a batch of groups of five source dtypes large enough for 4
pixels per thread.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import _build, executor
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def rotation(center, angle, scale):
    """``cv2.getRotationMatrix2D``."""
    a = math.radians(angle)
    al, be = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])


def _u8(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


def _seq(*ops):
    return T.build_operation_sequence(*ops)


def d1_circular(first=3, ascendent=True, n=16, h=32, w=64):
    """The reference's divergent row over one ring, at a reduced plane size."""
    ring = _u8(np.random.default_rng(4), (n, h, w, 3))
    read = T.circular_batch_read(ring, first=first, ascendent=ascendent)
    s1 = _seq(read, T.convert_to(np.float32, alpha=0.3), T.subtract((1.0, 2.0, 3.0)),
              T.write_tensor())
    s2 = _seq(read, T.convert_to(np.float32, alpha=0.5), T.multiply((2.0, 1.0, 0.5)),
              T.write_tensor())
    return [1 if z % 2 == 0 else 2 for z in range(n)], (s1, s2)


def d2_nv12(fmt=T.PixelFormat.NV12, crange=T.ColorRange.FULL, n=8, sh=32, sw=128):
    rng = np.random.default_rng(6)
    h2, w2 = sh // 2, sw // 2
    cams = [T.resize(T.fuse(T.read_yuv(_u8(rng, (sh * 3 // 2, sw)), pixel_format=fmt),
                            T.convert_yuv_to_rgb(standard=T.ColorStandard.BT709,
                                                 color_range=crange, out_dtype=np.float32)),
                     T.Size(w2, h2)) for _ in range(n)]
    flat = rng.integers(0, 200, (n, h2, w2, 3)).astype(np.float32)
    s1 = _seq(T.batch_read(cams), T.multiply(0.5), T.write_tensor())
    s2 = _seq(T.image(flat), T.write_tensor())
    return [1 if z % 2 == 0 else 2 for z in range(n)], (s1, s2)


def _crops(rng, n, frame_hw, rects=None, write=T.write_tensor):
    frame = _u8(rng, frame_hw + (3,))
    if rects is None:
        rects = np.array([[13 * z, 9 * z, 60, 120] for z in range(n)], np.int32)
    return _seq(T.resize_batch(frame, rects=rects, dsize=T.Size(64, 128)),
                T.convert_to(np.float32, alpha=0.5), T.subtract((1.0, 2.0, 3.0)), write())


def d3_crop_resize(n=8, rects=None):
    rng = np.random.default_rng(7)
    s1 = _crops(rng, n, (270, 480), rects)
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    s2 = _seq(T.image(flat), T.multiply(2.0), T.write_tensor())
    return [1 if z % 3 else 2 for z in range(n)], (s1, s2)


def d4_warp_crop_pass(angle0=-14.0, write=T.write_tensor, n=8):
    rng = np.random.default_rng(9)
    imgs = [_u8(rng, (128, 192, 3)) for _ in range(n)]
    mats = [rotation((96, 64), 4.0 * z + angle0, 1.0) for z in range(n)]
    frame = _u8(rng, (270, 480, 3))
    rects = np.array([[13 * z, 9 * z, 60, 120] for z in range(n)], np.int32)
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    s1 = _seq(T.warp_batch([T.image(im) for im in imgs], mats, T.Size(64, 128)),
              T.multiply(0.5), write())
    s2 = _seq(T.resize_batch(frame, rects=rects, dsize=T.Size(64, 128)),
              T.convert_to(np.float32, alpha=0.5), write())
    s3 = _seq(T.image(flat), T.multiply(2.0), write())
    return ([1, 2, 3, 1, 2, 3, 1, 2] * (n // 8 + 1))[:n], (s1, s2, s3)


def d5_stack_resize_and_image(n=6):
    rng = np.random.default_rng(10)
    sizes = [(40, 30), (64, 48), (17, 90), (128, 64), (9, 7), (50, 50)][:n]
    stack = [_u8(rng, (h, w, 3)) for h, w in sizes]
    batch = _u8(rng, (n, 32, 64, 3))
    s1 = _seq(T.resize_batch(stack, dsize=T.Size(64, 32)), T.convert_to(np.float32, alpha=0.5))
    s2 = _seq(T.image(batch), T.convert_to(np.float32), T.add(1.0))
    return [1, 2, 2, 1, 1, 2][:n], (s1, s2)


def d6_uint8_chain(n=6):
    rng = np.random.default_rng(11)
    a = _u8(rng, (n, 24, 40, 3))
    b = _u8(rng, (n, 24, 40, 3))
    s1 = _seq(T.image(a), T.multiply(1.7), T.add(-20.5), T.write_tensor())
    s2 = _seq(T.circular_batch_read(b, first=-1, ascendent=False),
              T.convert_to(np.uint8, alpha=0.5, beta=3.0))
    return [2, 1, 1, 2, 1, 2], (s1, s2)


def six_kinds(n=6, h=16, w=32):
    """One group of each kind, including a ragged crop group with origins
    left of and above the frame and a perspective warp."""
    rng = np.random.default_rng(13)
    stack = _u8(rng, (n, h, w, 3))
    frame = _u8(rng, (60, 80, 3))
    rects = np.array([[-7, 3, 30, 20], [5, -9, 20, 30], [-90, -2, 24, 24], [70, 50, 24, 24],
                      [-1, -1, 10, 10], [3, 3, 40, 40]][:n], np.int32)
    imgs = [_u8(rng, (40, 48, 3)) for _ in range(n)]
    persp = np.array([[0.6, 0.02, 2.0], [0.01, 0.7, 1.0], [1e-3, 2e-3, 1.0]])
    to_f32 = T.convert_to(np.float32)
    return [
        _seq(T.image(stack), to_f32, T.multiply((1.0, 2.0, 3.0))),
        _seq(T.circular_batch_read(stack, first=-2, ascendent=False), to_f32),
        _seq(T.resize_batch(frame, rects=rects, dsize=T.Size(w, h), used_planes=4,
                            background=(5.0, 6.0, 7.0), aspect_ratio=T.AspectRatio.PRESERVE_AR)),
        _seq(T.resize_batch(list(stack[:, :12, :20]), dsize=T.Size(w, h)), T.add(1.0)),
        _seq(T.batch_read([T.resize(T.fuse(T.read_yuv(_u8(rng, (24, 32))),
                                           T.convert_yuv_to_rgb(out_dtype=np.float32)),
                                    T.Size(w, h)) for _ in range(n)])),
        _seq(T.warp_batch(imgs, [persp] * n, T.Size(w, h), warp_type=T.WarpType.PERSPECTIVE,
                          border_value=2.0)),
    ]


def mixed_dtypes(first="uint8", n=16, h=96, w=256):
    """A uint8 chain and a float32 chain in one batch, large enough for 4
    pixels per thread; the batch takes the dtype of plane 0's group."""
    ring = _u8(np.random.default_rng(15), (n, h, w, 3))
    s_u8 = _seq(T.circular_batch_read(ring, first=5), T.convert_to(np.uint8, alpha=0.5, beta=3.0),
                T.write_tensor())
    s_f32 = _seq(T.image(ring), T.convert_to(np.float32, alpha=1.7), T.add(-70.25),
                 T.write_tensor())
    seqs = (s_u8, s_f32) if first == "uint8" else (s_f32, s_u8)
    return [1 + z % 2 for z in range(n)], seqs


def ring_off_the_vector(dtype, nch, write, dev, n=16, h=96, w=253):
    """A ring view on the card one element past an aligned address, rows of
    253 pixels: a tail in every row, under 4 pixels per thread."""
    flat = np.random.default_rng(16).integers(0, 256, n * h * w * nch + 1).astype(dtype)
    ring = torch.from_numpy(flat).to(dev)[1:].view(n, h, w, nch)
    to_out = T.convert_to(np.float32, alpha=0.5) if dtype == np.uint8 else T.convert_to(np.uint8)
    return [1 + z % 2 for z in range(n)], (
        _seq(T.circular_batch_read(ring, first=-3), to_out, write()),
        _seq(T.image(ring), to_out, T.add(1.0), write()))


#: the source dtypes of the general instance; "int64" is a tensor, read at load
NEW_DTYPES = ("int8", "uint16", "int16", "float16", "int32", "int64")


def _values(dtype, shape, seed):
    """Values of ``dtype`` over its range: int32 and int64 (whose low 32
    bits the kernel reads) within 200 of int32's bounds, past 2^24 and
    small, as a float32 conversion would round them."""
    rng = np.random.default_rng(seed)
    if dtype in ("int32", "int64"):
        i32 = np.iinfo(np.int32)
        kinds = rng.integers(0, 3, shape)
        v = np.where(kinds == 0, rng.integers(i32.min, i32.min + 200, shape),
                     np.where(kinds == 1, rng.integers(i32.max - 200, i32.max, shape),
                              rng.integers(2 ** 24, 2 ** 30, shape) * rng.choice([-1, 1], shape)))
        return v + rng.integers(-3, 4, shape) * 2 ** 32 if dtype == "int64" else v.astype(np.int32)
    if dtype == "float16":
        return (rng.integers(-2000, 2000, shape) / 4).astype(np.float16)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


def _src(dtype, shape, seed, dev):
    return torch.from_numpy(_values(dtype, shape, seed)).to(dev)


#: a scale that brings each dtype's values to a few hundred
ALPHA = {"int8": 1.5, "uint16": 1 / 128.0, "int16": 1 / 96.0, "float16": 0.25, "int32": 2.0 ** -23,
         "int64": 2.0 ** -23, "uint8": 0.5, "float32": 0.5}


def typed_copies(dtype, dev, first=3, n=8, h=24, w=40):
    """Copy groups of one source dtype into a batch of it: a ring copied
    (plane 0's group), an image stack through float32 and back, a ragged
    ``BatchRead`` of images with a default past the dtype's range."""
    back = np.int32 if dtype == "int64" else np.dtype(dtype)
    stack = _src(dtype, (n, h, w, 3), 1, dev)
    imgs = [_src(dtype, (h, w, 3), 10 + z, dev) for z in range(n)]
    return [1, 2, 3, 1, 3, 2, 1, 3], (
        _seq(T.circular_batch_read(stack, first=first), T.write_tensor()),
        _seq(T.image(stack), T.convert_to(np.float32, alpha=ALPHA[dtype]), T.multiply(3.0),
             T.convert_to(back), T.write_tensor()),
        _seq(T.batch_read([T.image(im) for im in imgs], used_planes=5, default=3e9),
             T.write_tensor()))


def typed_sampled(dtype, dev, shift=0, angle0=-20.0, n=8, h=24, w=40):
    """Resampling groups of one source dtype into float32: crops of one
    frame (plane 0's group), a stack resize, affine and perspective warps
    (the affine ragged), and a ring copied into float32."""
    frame = _src(dtype, (90, 120, 3), 2, dev)
    rects = np.array([[9 * z - 5 + shift, 4 * z + shift, 30, 20] for z in range(n)], np.int32)
    sizes = [(17, 30), (40, 50), (12, 9), (24, 40), (30, 30), (8, 70), (50, 20), (24, 41)]
    stack = [_src(dtype, (sh, sw, 3), 20 + z, dev) for z, (sh, sw) in enumerate(sizes[:n])]
    imgs = [_src(dtype, (40, 48, 3), 30 + z, dev) for z in range(n)]
    mats = [rotation((24, 20), 9.0 * z + angle0, 0.9) for z in range(n)]
    persp = np.array([[0.9, 0.05, 1.0 + shift], [0.02, 0.85, 0.5], [1e-2, 2e-2, 1.0]])
    to_f32 = T.convert_to(np.float32, alpha=ALPHA[dtype])
    dsize = T.Size(w, h)
    return [1, 2, 3, 4, 5, 1, 3, 2], (
        _seq(T.resize_batch(frame, rects=rects, dsize=dsize, used_planes=7, background=1.5,
                            aspect_ratio=T.AspectRatio.PRESERVE_AR), to_f32, T.write_tensor()),
        _seq(T.resize_batch(stack, dsize=dsize), to_f32, T.write_tensor()),
        _seq(T.warp_batch([T.image(im) for im in imgs], mats, dsize, used_planes=6,
                          default=-7.5, border_value=2.0), to_f32, T.write_tensor()),
        _seq(T.warp_batch([T.image(im) for im in imgs], [persp] * n, dsize,
                          warp_type=T.WarpType.PERSPECTIVE), to_f32, T.write_tensor()),
        _seq(T.circular_batch_read(_src(dtype, (n, h, w, 3), 3, dev), first=-5), to_f32,
             T.write_tensor()))


def mixed_sources(dev, first=5, shift=0, n=16, h=96, w=256):
    """Groups of five source dtypes in one batch of uint16, large enough
    for 4 pixels per thread: a uint16 ring (plane 0's group), uint8 crops,
    an int32 ring copied and wrapped into uint16, float16 images, and
    warps of int64 tensors."""
    frame = _src("uint8", (300, 400, 3), 4, dev)
    rects = np.array([[7 * z + shift, 5 * z + shift, 120, 50] for z in range(n)], np.int32)
    imgs = [_src("int64", (120, 300, 3), 40 + z, dev) for z in range(n)]
    to_u16 = T.convert_to(np.uint16, alpha=100.0)
    return [1 + z % 5 for z in range(n)], (
        _seq(T.circular_batch_read(_src("uint16", (n, h, w, 3), 5, dev), first=first),
             T.write_tensor()),
        _seq(T.resize_batch(frame, rects=rects, dsize=T.Size(w, h)), to_u16, T.write_tensor()),
        _seq(T.circular_batch_read(_src("int32", (n, h, w, 3), 6, dev), first=-first,
                                   ascendent=False), T.convert_to(np.uint16), T.write_tensor()),
        _seq(T.image(_src("float16", (n, h, w, 3), 7, dev)), to_u16, T.write_tensor()),
        _seq(T.warp_batch([T.image(im) for im in imgs],
                          [rotation((150, 60), 3.0 * z + shift, 1.0) for z in range(n)],
                          T.Size(w, h)), T.convert_to(np.float32, alpha=2.0 ** -20), to_u16,
             T.write_tensor()))


CASES = {
    "d1_circular_first3": lambda dev: d1_circular(3),
    "d1_circular_first_minus5": lambda dev: d1_circular(-5),
    "d2_nv12_bt709": lambda dev: d2_nv12(),
    "d2_nv21_limited": lambda dev: d2_nv12(T.PixelFormat.NV21, T.ColorRange.LIMITED),
    "d3_crop_resize": lambda dev: d3_crop_resize(),
    "d4_warp_crop_pass": lambda dev: d4_warp_crop_pass(),
    "d5_stack_resize_and_image": lambda dev: d5_stack_resize_and_image(),
    "d6_uint8_chain": lambda dev: d6_uint8_chain(),
    "d7_warp_crop_pass_planar": lambda dev: d4_warp_crop_pass(write=T.split_tensor),
    "six_kinds": lambda dev: ([1, 2, 3, 4, 5, 6], tuple(six_kinds())),
    "six_kinds_shuffled": lambda dev: ([3, 3, 6, 1, 5, 2], tuple(six_kinds())),
    "crop_negative_origins": lambda dev: d3_crop_resize(
        rects=np.array([[-5 - 7 * z, -3 - 5 * z, 60, 120] for z in range(8)], np.int32)),
    "crop_bottom_of_frame": lambda dev: d3_crop_resize(
        rects=np.array([[8 * z, 150 + z, 60, 120] for z in range(8)], np.int32)),
    # 4 pixels per thread: launches of 360,448 outputs and more on an H100
    "d1_circular_16x128x256": lambda dev: d1_circular(3, h=128, w=256),
    "d4_warp_crop_pass_48_planes": lambda dev: d4_warp_crop_pass(n=48),
    "d2_nv21_limited_24_planes": lambda dev: d2_nv12(T.PixelFormat.NV21, T.ColorRange.LIMITED,
                                                 n=24, sh=128, sw=512),
    "mixed_dtypes_uint8_first": lambda dev: mixed_dtypes("uint8"),
    "mixed_dtypes_float32_first": lambda dev: mixed_dtypes("float32"),
    "mixed_dtypes_small": lambda dev: mixed_dtypes("uint8", n=4, h=8, w=16),
    "u8_ring_off_the_vector_packed": lambda dev: ring_off_the_vector(np.uint8, 3, T.write_tensor, dev),
    "u8_ring_off_the_vector_planar": lambda dev: ring_off_the_vector(np.uint8, 4, T.split_tensor, dev),
    "f32_ring_off_the_vector_to_u8": lambda dev: ring_off_the_vector(np.float32, 3, T.split_tensor, dev),
    "f32_ring_off_the_vector_to_u8_packed": lambda dev: ring_off_the_vector(
        np.float32, 4, T.write_tensor, dev),
    **{f"{d}_copies": (lambda dev, d=d: typed_copies(d, dev)) for d in NEW_DTYPES},
    **{f"{d}_sampled": (lambda dev, d=d: typed_sampled(d, dev)) for d in NEW_DTYPES},
    # 4 pixels per thread: 393,216 outputs
    "mixed_sources_16x96x256": lambda dev: mixed_sources(dev),
    "mixed_sources_small": lambda dev: mixed_sources(dev, n=5, h=8, w=12),
}


def _bits(x):
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()])


def _check(ids, seqs, device):
    plan = kd.build_plan(seqs, ids)
    a = kd.prepare(seqs, plan, device)
    launches = kd.LAUNCHES
    got = kd.divergent(a)
    assert kd.LAUNCHES == launches + 1
    want = kd.divergent_reference(a)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.device.type == "cuda"
        bad = int((_bits(g) != _bits(w)).sum())
        assert bad == 0, f"{bad} values differ in their bits"
    return plan


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_version(case, cuda):
    ids, seqs = CASES[case](cuda)
    _check(ids, seqs, cuda)


@pytest.mark.parametrize("kind", ["copies", "sampled"])
@pytest.mark.parametrize("dtype", NEW_DTYPES)
def test_every_source_dtype_runs_the_general_instance(dtype, kind, cuda):
    """Each dtype's groups take the general instance; an int32 copy keeps
    values past 2^24 and within 200 of int32's bounds."""
    ids, seqs = (typed_copies if kind == "copies" else typed_sampled)(dtype, cuda)
    plan = _check(ids, seqs, cuda)
    assert plan.general and {g.src_dtype for g in plan.groups} == {getattr(torch, dtype)}
    if kind == "copies" and dtype in ("int32", "int64"):
        out = kd.run(seqs, plan, cuda)
        ring = seqs[0].read.data.to(torch.int32)
        want = ring[[(3 + z) % 8 for z in (0, 3, 6)]]
        assert torch.equal(out[[0, 3, 6]], want) and int(want.abs().max()) > 2 ** 31 - 200


@pytest.mark.parametrize("case", ["int16_copies", "float16_sampled", "int64_sampled", "mixed"])
def test_new_values_build_no_plan_on_every_source_dtype(case, cuda):
    """Through ``launch_divergent_batch`` under AUTO and CUDA: one launch of
    the general instance a call, a new ``first``, new rects and new
    matrices building no plan, equal to the eager merge bit for bit."""
    dtype = case.split("_")[0]
    for backend in (T.ParBackend.AUTO, T.ParBackend.CUDA):
        outs = []
        for k in range(2):
            if case == "mixed":
                ids, seqs = mixed_sources(cuda, first=(5, -3)[k], shift=3 * k, n=5, h=8, w=12)
            elif case.endswith("copies"):
                ids, seqs = typed_copies(dtype, cuda, first=(3, -2)[k])
            else:
                ids, seqs = typed_sampled(dtype, cuda, shift=2 * k, angle0=(-20.0, 15.0)[k])
            launches, builds = kd.LAUNCHES, executor.PLAN_BUILDS
            outs.append(T.launch_divergent_batch(ids, *seqs, backend=backend))
            assert T.last_backend() == "cuda:divergent" and kd.LAUNCHES == launches + 1
            if k:
                assert executor.PLAN_BUILDS == builds
        eager = T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.TORCH)
        torch.cuda.synchronize()
        assert torch.equal(_bits(outs[1]), _bits(eager))
        assert not torch.equal(_bits(outs[0]), _bits(outs[1]))


@pytest.mark.parametrize("ascendent", [True, False])
@pytest.mark.parametrize("first", [-5, -1, 0, 3, 18])
def test_first_is_taken_floor_modulo(first, ascendent, cuda):
    ids, seqs = d1_circular(first, ascendent, h=8, w=16)
    plan = _check(ids, seqs, cuda)
    assert [g.kind for g in plan.groups] == ["circ", "circ"]


@pytest.mark.parametrize("write", ["split_tensor", "split_tensor_transposed", "split",
                                   "split_tensor_packed", "write_tensor", "write"])
def test_every_write_layout(write, cuda):
    ids, seqs = d4_warp_crop_pass(write=getattr(T, write), n=4)
    _check(ids, seqs, cuda)


def test_main_path_launches_the_kernel_once_per_call(cuda):
    ring = torch.from_numpy(_u8(np.random.default_rng(3), (16, 32, 64, 3))).to(cuda)

    def call(first):
        read = T.circular_batch_read(ring, first=first)
        return T.launch_divergent_batch(
            lambda z: 1 + z % 2,
            _seq(read, T.convert_to(np.float32, alpha=0.3), T.write_tensor()),
            _seq(read, T.convert_to(np.float32, alpha=0.5), T.write_tensor()))

    first = call(3)
    launches, builds = kd.LAUNCHES, executor.PLAN_BUILDS
    second = call(-5)
    torch.cuda.synchronize()
    assert T.last_backend() == "cuda:divergent"
    assert kd.LAUNCHES == launches + 1 and executor.PLAN_BUILDS == builds
    assert not torch.equal(first, second)
    plain = T.launch_divergent_batch(
        lambda z: 1 + z % 2,
        _seq(T.circular_batch_read(ring, first=-5), T.convert_to(np.float32, alpha=0.3),
             T.write_tensor()),
        _seq(T.circular_batch_read(ring, first=-5), T.convert_to(np.float32, alpha=0.5),
             T.write_tensor()), backend=T.ParBackend.TORCH)
    assert T.last_backend() == "torch:divergent" and torch.equal(plain, second)


def test_explicit_cuda_raises_on_a_refused_batch(cuda):
    """A ragged ``BatchRead`` group (which the reference's TPU kernel
    refuses) runs in one launch of the kernel under AUTO and an explicit
    CUDA, equal to the plain version; a batch whose groups differ in plane
    shape is refused: an explicit CUDA raises."""
    imgs = [_u8(np.random.default_rng(17), (12, 16, 1)) for _ in range(2)]
    ragged = _seq(T.warp_batch(imgs, [rotation((8, 6), 5.0, 1.0)] * 2, T.Size(4, 4),
                               used_planes=1, default=9.5), T.multiply(2.0))
    f32 = _seq(T.image(np.zeros((2, 4, 4, 1), np.float32)))
    for backend in (T.ParBackend.AUTO, T.ParBackend.CUDA):
        launches = kd.LAUNCHES
        out = T.launch_divergent_batch([1, 2], ragged, f32, backend=backend, device=cuda)
        assert T.last_backend() == "cuda:divergent" and out.dtype == torch.float32
        assert kd.LAUNCHES == launches + 1
    plain = T.launch_divergent_batch([1, 2], ragged, f32, backend=T.ParBackend.TORCH, device=cuda)
    assert torch.equal(out, plain) and bool((out[1] == 0).all())
    for used, want in ((0, 19.0), (2, None)):  # used_planes at runtime: no new plan
        builds = executor.PLAN_BUILDS
        r = _seq(T.warp_batch(imgs, [rotation((8, 6), 5.0, 1.0)] * 2, T.Size(4, 4),
                              used_planes=used, default=9.5), T.multiply(2.0))
        got = T.launch_divergent_batch([1, 2], r, f32, device=cuda)
        assert executor.PLAN_BUILDS == builds
        assert torch.equal(got, T.launch_divergent_batch([1, 2], r, f32,
                                                         backend=T.ParBackend.TORCH))
        if want is not None:
            assert bool((got[0] == want).all())
    narrow = _seq(T.image(np.zeros((2, 4, 5, 1), np.float32)))
    with pytest.raises(ValueError, match="cannot run"):
        T.launch_divergent_batch([1, 2], ragged, narrow, backend=T.ParBackend.CUDA, device=cuda)


def test_groups_of_different_output_dtypes_take_the_kernel(cuda):
    u8 = _seq(T.image(np.full((2, 4, 4, 1), 7, np.uint8)))
    f = np.zeros((2, 4, 4, 1), np.float32)
    f[1, 0, :, 0] = (3.7, 297.5, -0.5, 255.6)
    out = T.launch_divergent_batch([1, 2], u8, _seq(T.image(f)), device=cuda)
    assert T.last_backend() == "cuda:divergent" and out.dtype == torch.uint8
    assert out[1, 0, :, 0].tolist() == [3, 255, 0, 255] and out[0, 0, 0, 0] == 7


def test_a_cpu_tensor_never_reaches_the_library(cuda, monkeypatch):
    ids, seqs = d6_uint8_chain()
    plan = kd.build_plan(seqs, ids)
    a = kd.prepare(seqs, plan, torch.device("cpu"))

    def refuse():
        raise AssertionError("the library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    launches = kd.LAUNCHES
    out = kd.divergent(a)
    assert out.device.type == "cpu" and kd.LAUNCHES == launches


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    ids, seqs = d4_warp_crop_pass(n=4)
    a = kd.prepare(seqs, kd.build_plan(seqs, ids), cuda)
    with pytest.raises(ValueError):
        kd.divergent(dataclasses.replace(a, block=a.block.float()))
    with pytest.raises(ValueError):
        kd.divergent(dataclasses.replace(a, consts=a.consts[:-1]))
    with pytest.raises(ValueError):
        kd.divergent(dataclasses.replace(a, desc_off=a.block.numel()))
    with pytest.raises(ValueError):
        kd.divergent(dataclasses.replace(a, srcs=(a.srcs[0].double(),) + a.srcs[1:]))


def test_circular_tensor_update_runs_the_frame_kernel(cuda):
    frame = torch.from_numpy(_u8(np.random.default_rng(5), (270, 480, 3))).to(cuda)
    ring = T.CircularTensor(64, 128, 3, 8, device=cuda)
    eager = T.CircularTensor(64, 128, 3, 8, device=cuda)
    new_plans = 0
    for k in range(10):
        f = torch.roll(frame, k, dims=1)
        builds = executor.PLAN_BUILDS
        ring.update(T.resize(T.image(f), T.Size(64, 128)),
                    T.convert_to(np.float32, alpha=1 / 255.0))
        assert T.last_backend() == "cuda:frame_resize"
        new_plans += (executor.PLAN_BUILDS - builds) if k else 0
        pipe = (T.resize(T.image(f), T.Size(64, 128)), T.convert_to(np.float32, alpha=1 / 255.0))
        x = T.execute_operations(*pipe, backend=T.ParBackend.TORCH)
        eager._ring[eager._count % eager.batch].copy_(x.permute(2, 0, 1))
        eager._count += 1
    assert new_plans == 0  # only the first update builds a plan
    torch.cuda.synchronize()
    assert torch.equal(ring.tensor, eager.tensor)
    # a PACKED ring feeds a divergent batch through its read head
    packed = T.CircularTensor(64, 128, 3, 8, planes=T.ColorPlanes.PACKED, device=cuda)
    for k in range(11):
        packed.update(T.resize(T.image(torch.roll(frame, k, dims=0)), T.Size(64, 128)),
                      T.convert_to(np.float32, alpha=1 / 255.0))
    out = T.launch_divergent_batch(lambda z: 1 + z % 2,
                                   _seq(packed.read_batch(), T.write_tensor()),
                                   _seq(packed.read_batch(), T.multiply(2.0), T.write_tensor()))
    assert T.last_backend() == "cuda:divergent"
    logical = packed.tensor
    assert torch.equal(out[0], logical[0]) and torch.equal(out[1], logical[1] * 2.0)
