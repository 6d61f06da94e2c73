"""The composed-read kernel on the card, at a quarter of the full width:
what ``chip_smoke.py`` phases 3 and 4 check at full width. Needs a CUDA
device and skips without one. On a machine with a card and without jax,
run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_composed.py

Every output must equal the plain version bit for bit (float32 as int32
bits), in one launch; on other source dtypes and subnormal float32 ones
also the eager path on the card (``ParBackend.TORCH``), which shares no
plan with the kernel.
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import executor
import torch_composed_cases as cc

pytestmark = pytest.mark.gpu

H, W = 270, 480  # a quarter of 1080p on each side


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _on(cuda, f):
    return {k: torch.from_numpy(v).to(cuda) for k, v in f.items()}


def _bits(t):
    if t.dtype.is_floating_point:
        return t.view(torch.int32 if t.element_size() == 4 else torch.int16)
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _same(got, want):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        bad = int((_bits(g) != _bits(w)).sum())
        assert bad == 0, f"{bad} of {g.numel()} values differ"


def _launch(cuda, ops):
    p = T.build_pipeline(*ops)
    a = kc.prepare(p, kc.build_plan(p), cuda)
    before = kc.LAUNCHES
    got = kc.composed(a)
    assert kc.LAUNCHES == before + 1
    return a, got


@pytest.mark.parametrize("name", cc.NAMES)
def test_kernel_equals_its_plain_version(cuda, name):
    f = _on(cuda, cc.frames(H, W, 1))
    a, got = _launch(cuda, cc.cases(T, f)[name])
    _same(got, kc.composed_reference(a))


@pytest.mark.parametrize("name", list(cc.more_cases(T)))
def test_the_other_compositions(cuda, name):
    """Host leaves: the base and every value reach the card in prepare."""
    a, got = _launch(cuda, cc.more_cases(T)[name])
    assert a.srcs[0].device == cuda
    _same(got, kc.composed_reference(a))


def test_a_batch_of_crops_of_two_frames(cuda):
    f1, f2 = (torch.from_numpy(cc.frames(H, W, s)["hd"]).to(cuda) for s in (8, 9))
    ops = (T.batch_read([T.crop(T.image(f1), T.Rect(1, 2, 100, 80)),
                         T.crop(T.image(f2), T.Rect(300, 150, 100, 80)),
                         T.crop(T.image(f1), T.Rect(-20, 250, 100, 80))]),
           T.convert_to(np.float32, alpha=0.5), T.split_tensor())
    a, got = _launch(cuda, ops)
    assert len(a.srcs) == 2 and a.plane_src == (0, 1, 0)
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int16, torch.float16, torch.int32,
                                   torch.float64, torch.int64, torch.int8, torch.float32])
@pytest.mark.parametrize("name", ["c1_roi_crop_resize", "c4_warp_of_a_crop", "c6_crop_batch",
                                  "c7_crop_of_fused_gray", "c3_letterbox"])
def test_source_dtypes(cuda, name, dtype):
    f = _on(cuda, cc.frames(H, W, 2))
    for k in ("hd", "big"):
        f[k] = ((f[k].int() * 3 + 100).to(dtype) if dtype not in (torch.float16, torch.int8)
                else (f[k].float() / 7).half() if dtype == torch.float16 else (f[k].int() - 128).to(dtype))
    ops = cc.cases(T, f)[name]
    a, got = _launch(cuda, ops)
    assert a.srcs[0].dtype == dtype
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


def test_subnormal_float32_source(cuda):
    """Subnormal values flushed as operands and results, kept by copies: the
    kernel equals its plain version as int32 bits."""
    f = _on(cuda, cc.frames(H, W, 3))
    rng = np.random.default_rng(4)
    for k in ("hd", "big"):
        x = f[k].float() * 1e-39
        mask = torch.from_numpy(rng.random(tuple(x.shape)) < 0.5).to(cuda)
        f[k] = torch.where(mask, x, x * 1e-6)
    for name in ("c1_roi_crop_resize", "c4_warp_of_a_crop", "c7_crop_of_fused_gray"):
        ops = cc.cases(T, f)[name]
        ops = (*ops[:-1][:1], T.multiply(1e20), ops[-1])
        a, got = _launch(cuda, ops)
        _same(got, kc.composed_reference(a))
        _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


def test_main_path_is_one_launch_and_new_values_build_no_plan(cuda):
    f = _on(cuda, cc.frames(H, W, 5))
    for name in cc.NAMES:
        outs = []
        for values in (0, 1):
            builds, launches = executor.PLAN_BUILDS, kc.LAUNCHES
            outs.append(T.execute_operations(*cc.cases(T, f, values)[name]))
            assert T.last_backend() == "cuda:composed", name
            assert kc.LAUNCHES == launches + 1
            if values:
                assert executor.PLAN_BUILDS == builds, name
        eager = T.execute_operations(*cc.cases(T, f, 1)[name], backend=T.ParBackend.TORCH)
        _same(outs[1], eager)
        moved = name[:2] in ("c1", "c3", "c4", "c6", "c7")  # the cases whose values move
        assert torch.equal(outs[0], outs[1]) != moved, name


@pytest.mark.parametrize("shift", [0, 4])
def test_out_view_on_and_off_16_bytes(cuda, shift):
    f = _on(cuda, cc.frames(H, W, 6))
    p = T.build_pipeline(*cc.cases(T, f)["c1_roi_crop_resize"])
    a = kc.prepare(p, kc.build_plan(p), cuda)
    want = kc.composed_reference(a)
    storage = torch.full((want.numel() + 16,), 7.0, device=cuda)
    start = shift // 4
    view = storage[start:start + want.numel()].view(want.shape)
    assert view.data_ptr() % 16 == shift
    assert kc.composed(a, out=view) is view
    _same(view, want)
    assert bool((storage[:start] == 7).all() and (storage[start + want.numel():] == 7).all())


def test_out_into_a_strided_slot_of_another_dtype(cuda):
    f = _on(cuda, cc.frames(H, W, 7))
    ops = cc.cases(T, f)["c7_crop_of_fused_gray"]
    p = T.build_pipeline(*ops[:-2], T.split_tensor())
    a = kc.prepare(p, kc.build_plan(p), cuda)
    want = kc.composed_reference(a)  # uint8 gray, planar (1, h, w)
    slots = torch.full((1, 3, *want.shape[1:]), -1, dtype=torch.int16, device=cuda)
    view = slots[:, 1]
    assert kc.composed(a, out=view) is view
    _same(view, want.to(torch.int16))
    assert bool((slots[:, [0, 2]] == -1).all())


# --- the large launches: 4 pixels a thread for a one-pixel read ---------------

C = T.ColorConversionCode


def _resident(cuda):
    props = torch.cuda.get_device_properties(cuda)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def _large(f, width, height, dx=0, angle=10.0):
    """Compositions of width x height outputs, each read tree of C1-C8, at
    least twice the card's resident threads: a one-pixel read takes 4
    pixels a thread there, a resample 1. ``dx`` and ``angle`` move runtime
    values (a crop origin, the warp's angle)."""
    hd, big, nv12 = f["hd"], f["big"], f["nv12"]
    h, w = hd.shape[:2]
    size = T.Size(width, height)
    roi = T.Rect(w // 2 + dx, h // 2, w, h)
    norm = cc.normalize(T)
    cases = {
        "resize_of_a_crop": (T.resize(T.crop(T.image(big), roi), size), *norm, T.split_tensor()),
        "resize_of_a_fused_read": (
            T.resize(T.fuse(T.image(hd), T.vector_reorder(2, 1, 0),
                            T.convert_to(np.float32, alpha=1 / 255.0)), size), T.split_tensor()),
        "warp_of_a_crop": (T.warp(T.crop(T.image(big), roi), cc.rotation((w / 2, h / 2), angle),
                                  size), *norm, T.split_tensor()),
        "resize_of_a_border": (
            T.resize(T.make_border(T.image(hd), 8, 8, 8, 8, T.BorderMode.REFLECT_101), size),
            *norm, T.split_tensor()),
        "nv12_to_u8_resize": (
            T.resize(T.fuse(T.read_yuv(nv12), T.convert_yuv_to_rgb(out_dtype=np.uint8)), size),
            T.split_tensor()),
    }
    if height + 40 <= 2 * h and width <= 2 * w:  # trees whose output lies inside a frame
        cases["letterbox"] = (
            T.make_border(T.resize(T.image(hd), T.Size(width, height - 40)), 20, 20, 0, 0,
                          T.BorderMode.CONSTANT, 114), T.convert_to(np.float32, alpha=1 / 255.0),
            T.split_tensor())
        cases["crop_of_fused_gray"] = (
            T.crop(T.fuse(T.image(big), T.cvt_color(C.COLOR_RGB2GRAY)),
                   T.Rect(3 + dx, 5, width, height)), T.convert_to(np.float32), T.write())
    return cases


#: (name, width) of the large launches: a width that is a multiple of 4, a
#: ragged one (every row of a 4-pixel read ends in a partial group) and,
#: for the trees whose output may be any size, one narrower than a group
LARGE = [(name, width) for width in (1024, 1021) for name in (
    "resize_of_a_crop", "resize_of_a_fused_read", "warp_of_a_crop", "resize_of_a_border",
    "nv12_to_u8_resize", "letterbox", "crop_of_fused_gray")] + [
    (name, 3) for name in ("resize_of_a_crop", "warp_of_a_crop", "nv12_to_u8_resize")]


def _large_launch(cuda, name, width, **moved):
    resident = _resident(cuda)
    height = -(-2 * resident // width)  # outputs >= 2 x resident
    f = _on(cuda, cc.frames(540, 960, 11))
    ops = _large(f, width, height, **moved)[name]
    a, got = _launch(cuda, ops)
    w, h = a.plan.dsize
    taps = cc.instance(a.plan)[1]
    assert cc.pixels_per_thread(a.plan.n_planes * w * h, resident, taps) == (4 if taps == 1 else 1)
    return ops, a, got


@pytest.mark.parametrize("name,width", LARGE)
def test_large_launches(cuda, name, width):
    _, a, got = _large_launch(cuda, name, width)
    _same(got, kc.composed_reference(a))


@pytest.mark.parametrize("side", [190, 189])
def test_a_large_crop_batch(cuda, side):
    """16 crops of side x side: 577,600 (571,536) outputs, 4 pixels a thread
    on an H100; 189 leaves every row a partial group."""
    f = _on(cuda, cc.frames(540, 960, 12))
    rects = [T.Rect(k * 47 - 20, (k * 31) % 400, side, side) for k in range(16)]
    ops = (T.crop_batch(f["hd"], rects), *cc.normalize(T), T.split_tensor())
    a, got = _launch(cuda, ops)
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


def test_a_crop_batch_narrower_than_a_group(cuda):
    """Crops 3 pixels wide, enough of them for 4 pixels a thread: each
    thread's group holds 3 pixels of a row."""
    f = _on(cuda, cc.frames(540, 960, 14))
    rows = 1000
    n = -(-2 * _resident(cuda) // (3 * rows))
    rects = [T.Rect((k * 37) % 1900, k % 70, 3, rows) for k in range(n)]
    ops = (T.crop_batch(f["big"], rects), T.convert_to(np.float32, alpha=0.5), T.split_tensor())
    a, got = _launch(cuda, ops)
    assert cc.pixels_per_thread(n * 3 * rows, _resident(cuda)) == 4
    _same(got, kc.composed_reference(a))


@pytest.mark.parametrize("name", ["resize_of_a_crop", "warp_of_a_crop", "crop_of_fused_gray"])
def test_large_launches_new_values_build_no_plan(cuda, name):
    """Moved runtime values (a crop origin, the warp's angle) in a large
    launch: no plan, one launch, the eager path's values bit for bit."""
    resident = _resident(cuda)
    height = -(-2 * resident // 1021)
    f = _on(cuda, cc.frames(540, 960, 13))
    outs = []
    for moved in ({}, {"dx": -7, "angle": 14.0}):
        ops = _large(f, 1021, height, **moved)[name]
        builds, launches = executor.PLAN_BUILDS, kc.LAUNCHES
        outs.append(T.execute_operations(*ops))
        assert T.last_backend() == "cuda:composed" and kc.LAUNCHES == launches + 1
        if moved:
            assert executor.PLAN_BUILDS == builds
        _same(outs[-1], T.execute_operations(*ops, backend=T.ParBackend.TORCH))
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("name", ["resize_of_a_crop", "warp_of_a_crop", "crop_of_fused_gray"])
def test_large_launches_into_a_strided_unaligned_view(cuda, name):
    """An output whose rows lie 5 elements apart past the row and whose
    first element lies 4 bytes off 16: the scalar stores of store_any, and
    nothing written outside the view."""
    _, a, want = _large_launch(cuda, name, 1021)
    storage = torch.full((*want.shape[:-1], want.shape[-1] + 5), 7.0, device=cuda)
    view = storage[..., 1:1 + want.shape[-1]]
    assert view.data_ptr() % 16 == 4
    assert kc.composed(a, out=view) is view
    _same(view, want)
    assert bool((storage[..., :1] == 7).all() and (storage[..., 1 + want.shape[-1]:] == 7).all())


# --- a BatchRead of per-plane read trees: B1-B7 --------------------------------


def _cameras(cuda, seed, h, w):
    f = cc.cameras(seed, h, w)
    return {"cams": [torch.from_numpy(c).to(cuda) for c in f["cams"]],
            "big": torch.from_numpy(f["big"]).to(cuda)}


@pytest.mark.parametrize("size", [(36, 48), (270, 480)])
@pytest.mark.parametrize("name", cc.BATCH_NAMES)
def test_a_batch_equals_its_plain_version(cuda, name, size):
    """B1-B7 in one launch, each plane from its own address (the two
    cameras read in place), bit for bit the plain version and the eager
    path on the card."""
    f = _cameras(cuda, 21, *size)
    ops = cc.batch_cases(T, f)[name]
    a, got = _launch(cuda, ops)
    assert [s.data_ptr() for s in a.srcs] == [c.data_ptr() for c in f["cams"]] or name[:2] == "b6"
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("default", [-1.5, 300.7, float("nan"), (7.0, 260.0, -3.0)])
@pytest.mark.parametrize("used", [0, 2, 5, 8, -1])
def test_a_ragged_batch_holds_the_default(cuda, used, default):
    """B6's crops stored as read (uint8) and B2's resizes through the chain
    (float32): planes from used_planes on hold the default, cast to the read
    value's dtype, bit for bit the plain version and the eager path."""
    f = _cameras(cuda, 22, 36, 48)
    cases = cc.batch_cases(T, f, used=used, default=default)
    for ops in ((cases["b6_crops_of_a_frame_ragged"][0], T.write_tensor()),
                cases["b2_cameras_resized_ragged"]):
        a, got = _launch(cuda, ops)
        _same(got, kc.composed_reference(a))
        _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


def test_a_batch_is_one_launch_and_new_values_build_no_plan(cuda):
    """Each of B1-B7 twice through execute_operations, the second call with
    new frames, origins, angles, border value and used_planes: one launch
    each, no plan on the second, the eager path's values bit for bit."""
    for name in cc.BATCH_NAMES:
        for values in (0, 1):
            f = _cameras(cuda, 23 + values, 270, 480)
            ops = cc.batch_cases(T, f, values)[name]
            builds, launches = executor.PLAN_BUILDS, kc.LAUNCHES
            got = T.execute_operations(*ops)
            assert T.last_backend() == "cuda:composed", name
            assert kc.LAUNCHES == launches + 1
            if values:
                assert executor.PLAN_BUILDS == builds, name
            _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("name", ["b2_cameras_resized_ragged", "b5_warps_of_crops",
                                  "b6_crops_of_a_frame_ragged"])
def test_a_batch_into_a_strided_unaligned_view(cuda, name):
    f = _cameras(cuda, 25, 270, 480)
    p = T.build_pipeline(*cc.batch_cases(T, f)[name])
    a = kc.prepare(p, kc.build_plan(p), cuda)
    want = kc.composed_reference(a)
    storage = torch.full((*want.shape[:-1], want.shape[-1] + 5), 7.0, device=cuda)
    view = storage[..., 1:1 + want.shape[-1]]
    assert kc.composed(a, out=view) is view
    _same(view, want)
    assert bool((storage[..., :1] == 7).all() and (storage[..., 1 + want.shape[-1]:] == 7).all())


def test_a_large_ragged_batch_of_crops(cuda):
    """50 crops of 224x224 of a 4K frame, 37 used: 4 pixels a thread, the
    held planes' groups storing the default through the chain."""
    frame = torch.from_numpy(cc.frames(1080, 1920, 26)["big"]).to(cuda)
    rects = [(k * 71 - 40, (k * 43) % 2000) for k in range(50)]
    ops = (T.batch_read([T.crop(T.image(frame), T.Rect(x, y, 224, 224)) for x, y in rects],
                        used_planes=37, default=(0.0, 255.0, 128.0)),
           *cc.normalize(T), T.split_tensor())
    a, got = _launch(cuda, ops)
    assert len(a.srcs) == 1
    assert cc.pixels_per_thread(50 * 224 * 224, _resident(cuda)) == 4
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))
