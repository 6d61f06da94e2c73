"""The CUDA kernel on the card, at small sizes: what ``chip_smoke.py`` phase 3
and 4 check at the flagship shapes. Needs a CUDA device and skips without
one. On a machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_batch_resize.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.ops.arithmetic import Mul, StaticLoop
from cvgpuspeedup_tpu_torch.ops.color import VectorReorder

pytestmark = pytest.mark.gpu

UP = T.Size(64, 128)
CHAIN = (T.convert_to(np.float32, alpha=0.3), T.subtract((3.2, 0.6, 11.8)),
         T.divide((128.0, 128.0, 128.0)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def frame(cuda):
    rng = np.random.default_rng(42)
    return torch.from_numpy(rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)).to(cuda)


def _rects(cw=60, ch=120, n=12):
    return np.array([[i * 7, i * 5, cw, ch] for i in range(n)], np.int32)


def _cases(frame):
    rng = np.random.default_rng(7)
    images = [torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(frame.device)
              for h, w in ((100, 50), (80, 120), (37, 61), (9, 5))]
    edge = np.array([[300 - 40 - i, 200 - 100 - i, 60, 120] for i in range(6)], np.int32)
    cases = {
        "ignore_ar": (T.resize_batch(frame, rects=_rects(), dsize=UP), *CHAIN, T.split_tensor()),
        # a device background beside host chain scalars
        "tensor_background": (T.resize_batch(frame, rects=_rects(cw=30), dsize=UP,
                                             background=torch.tensor([128.0, 7.0, 250.0],
                                                                     device=frame.device),
                                             aspect_ratio=T.AspectRatio.PRESERVE_AR),
                              *CHAIN, T.split_tensor()),
        "used_planes": (T.resize_batch(frame, rects=_rects(), dsize=UP, used_planes=7,
                                       background=128.0), *CHAIN, T.split_tensor()),
        "stack": (T.resize_batch(images, dsize=UP, background=3.0), *CHAIN, T.split_tensor()),
        "u8_chain": (T.resize_batch(frame, rects=_rects(), dsize=UP),
                     T.convert_to(np.uint8, alpha=0.5, beta=3), T.split_tensor()),
        "u8_hwc": (T.resize_batch(frame, rects=_rects(), dsize=UP),
                   T.convert_to(np.uint8, alpha=1.7, beta=-20), T.write_tensor()),
        "tsplit": (T.resize_batch(frame, rects=_rects(), dsize=UP), *CHAIN,
                   T.split_tensor_transposed()),
        "split_write": (T.resize_batch(frame, rects=_rects(), dsize=UP), *CHAIN, T.split()),
        "split_packed": (T.resize_batch(frame, rects=_rects(), dsize=UP), *CHAIN,
                         T.split_tensor_packed()),
        "f32_edge_reorder_loop": (T.resize_batch(frame.float(), rects=edge, dsize=UP),
                                  VectorReorder(indices=(2, 1, 0)),
                                  StaticLoop(body=Mul(value=np.float32(1.01)), n=3), *CHAIN,
                                  T.split_tensor()),
    }
    # origins left of and above the frame, one past -width, with a colour chain
    negative = np.array([[-5, -3, 60, 120], [-370, 2, 60, 120], [250, 150, 60, 120],
                         [-30, -140, 60, 120]], np.int32)
    cases["negative_origin_gray"] = (
        T.resize_batch(frame, rects=negative, dsize=UP),
        T.cvt_color(T.ColorConversionCode.COLOR_BGR2GRAY), T.multiply(1 / 255.0), T.split_tensor())
    cases["bgr2rgba_u8"] = (T.resize_batch(frame, rects=_rects(), dsize=UP), T.convert_to(np.uint8),
                            T.cvt_color(T.ColorConversionCode.COLOR_BGR2RGBA), T.write_tensor())
    for mode in (T.AspectRatio.PRESERVE_AR, T.AspectRatio.PRESERVE_AR_RN_EVEN,
                 T.AspectRatio.PRESERVE_AR_LEFT):
        cases[mode.name] = (T.resize_batch(frame, rects=_rects(cw=30), dsize=UP, background=128.0,
                                           aspect_ratio=mode), *CHAIN, T.split_tensor())
    return cases


CASE_NAMES = ["ignore_ar", "tensor_background", "used_planes", "stack", "u8_chain", "u8_hwc", "tsplit", "split_write",
              "split_packed", "f32_edge_reorder_loop", "negative_origin_gray", "bgr2rgba_u8",
              "PRESERVE_AR", "PRESERVE_AR_RN_EVEN", "PRESERVE_AR_LEFT"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_kernel_matches_plain_version(case, frame, cuda):
    pipeline = T.build_pipeline(*_cases(frame)[case])
    a = kbr.prepare(pipeline, kbr.build_plan(pipeline), cuda)
    got = kbr.batch_resize(a)
    want = kbr.batch_resize_reference(a)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.uint8:
            assert torch.equal(g, w)
        else:
            assert float((g - w).abs().max()) <= 1e-6


def _odd_view(device, h, w, c, seed):
    """A contiguous (h, w, c) uint8 view that starts at an odd address."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.integers(0, 256, h * w * c + 1, dtype=np.uint8)).to(device)
    view = flat[1:].view(h, w, c)
    assert view.data_ptr() % 2 == 1 and view.is_contiguous()
    return view


def _tiled_cases(device):
    """The tiled kernel's own paths: sources at any address and row pitch,
    tiles of every shape, and what may cut through a thread's 4 pixels."""
    rng = np.random.default_rng(11)

    def img(h, w, c=3, dtype=torch.uint8):
        return torch.from_numpy(rng.integers(0, 256, (h, w, c), dtype=np.uint8)).to(device, dtype)

    wide = img(200, 304)       # 912-byte rows, a multiple of 16
    ends = np.array([[0, 0, 60, 120], [244, 80, 60, 120], [3, 5, 60, 120]], np.int32)
    big = [img(1080, 1920), img(40, 30), img(700, 900)]
    return {
        # (a) crops that hold the buffer's first and last bytes; a view at an odd address
        "first_and_last_bytes": (T.resize_batch(wide, rects=ends, dsize=UP), *CHAIN,
                                 T.split_tensor()),
        "view_at_byte_offset_1": (T.resize_batch(_odd_view(device, 200, 304, 3, 12), rects=ends,
                                                 dsize=UP), *CHAIN, T.split_tensor()),
        "view_at_byte_offset_1_four_channels": (
            T.resize_batch(_odd_view(device, 200, 304, 4, 13), rects=ends, dsize=UP),
            T.convert_to(np.float32, alpha=0.5), T.split_tensor()),
        "row_pitch_multiple_of_4_only": (T.resize_batch(img(200, 300), rects=_rects(), dsize=UP),
                                         *CHAIN, T.split_tensor()),
        "row_pitch_odd": (T.resize_batch(img(200, 301), rects=_rects(), dsize=UP), *CHAIN,
                          T.split_tensor()),
        "f32_source": (T.resize_batch(img(200, 304, dtype=torch.float32), rects=_rects(),
                                             dsize=UP), *CHAIN, T.split_tensor()),
        "one_channel": (T.resize_batch(img(200, 304, 1), rects=_rects(), dsize=UP),
                        T.convert_to(np.float32, alpha=0.5), T.split_tensor()),
        # (b) rows off the vector's alignment, widths off the pixel group
        "dst_62x126": (T.resize_batch(wide, rects=_rects(), dsize=T.Size(62, 126)), *CHAIN,
                       T.split_tensor()),
        "dst_61_u8_out": (T.resize_batch(wide, rects=_rects(), dsize=T.Size(61, 128)),
                          T.convert_to(np.uint8, alpha=0.5, beta=3), T.split_tensor()),
        "dst_3x5": (T.resize_batch(wide, rects=_rects(), dsize=T.Size(3, 5)), *CHAIN,
                    T.split_tensor()),
        "dst_300x20_several_tiles_across": (
            T.resize_batch(wide, rects=_rects(), dsize=T.Size(300, 20)), *CHAIN, T.split_tensor()),
        # (c) letterbox borders through a group of 4 pixels
        "letterbox_cuts_a_group": (T.resize_batch(wide, rects=_rects(cw=27), dsize=UP,
                                                  background=128.0,
                                                  aspect_ratio=T.AspectRatio.PRESERVE_AR),
                                   *CHAIN, T.split_tensor()),
        "letterbox_rows": (T.resize_batch(wide, rects=_rects(cw=120, ch=50), dsize=UP,
                                          background=(1.0, 2.0, 3.0),
                                          aspect_ratio=T.AspectRatio.PRESERVE_AR_RN_EVEN),
                           *CHAIN, T.split_tensor()),
        # (d) a ragged count read from device memory
        "used_planes_on_the_device": (
            T.resize_batch(wide, rects=_rects(), dsize=UP, background=9.0,
                           used_planes=torch.tensor(5, dtype=torch.int32, device=device)),
            *CHAIN, T.split_tensor()),
        # large sources: stack mode with a 1080p plane, a crop of most of a frame
        "stack_with_a_1080p_plane": (T.resize_batch(big, dsize=UP, background=3.0), *CHAIN,
                                         T.split_tensor()),
        "crop_of_most_of_a_frame": (
            T.resize_batch(big[0], rects=np.array([[5, 7, 1800, 1000], [9, 9, 64, 128]], np.int32),
                           dsize=UP), *CHAIN, T.split_tensor()),
    }


TILED_CASES = ["first_and_last_bytes", "view_at_byte_offset_1",
               "view_at_byte_offset_1_four_channels", "row_pitch_multiple_of_4_only",
               "row_pitch_odd", "f32_source", "one_channel", "dst_62x126", "dst_61_u8_out",
               "dst_3x5", "dst_300x20_several_tiles_across", "letterbox_cuts_a_group",
               "letterbox_rows", "used_planes_on_the_device", "stack_with_a_1080p_plane",
               "crop_of_most_of_a_frame"]


@pytest.mark.parametrize("case", TILED_CASES)
def test_tiled_paths_match_plain_version_bit_for_bit(case, cuda):
    pipeline = T.build_pipeline(*_tiled_cases(cuda)[case])
    a = kbr.prepare(pipeline, kbr.build_plan(pipeline), cuda)
    got = kbr.batch_resize(a)
    want = kbr.batch_resize_reference(a)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), f"max |diff| {float((got.double() - want.double()).abs().max())}"


def test_main_path_launches_the_kernel_once_per_call(frame):
    def call(rects):
        return T.execute_operations(T.resize_batch(frame, rects=rects, dsize=UP), *CHAIN,
                                    T.split_tensor())

    rects = _rects()
    call(rects)
    launches, builds = kbr.LAUNCHES, executor.PLAN_BUILDS
    shifted = rects.copy()
    shifted[:, :2] += 7
    out = call(shifted)
    torch.cuda.synchronize()
    assert T.last_backend() == "cuda:batch_resize"
    assert kbr.LAUNCHES == launches + 1 and executor.PLAN_BUILDS == builds
    assert tuple(out.shape) == (12, 3, 128, 64) and bool(torch.isfinite(out).all())


def test_explicit_cuda_on_unsupported_pipeline_raises(frame):
    mask = frame > 127  # no kernel reads bool
    with pytest.raises(ValueError, match="cannot run"):
        T.execute_operations(T.image(mask), T.multiply(2.0), backend=T.ParBackend.CUDA)
    out = T.execute_operations(T.image(mask), T.multiply(2.0))
    assert T.last_backend() == "torch" and out.device == frame.device
    # int64 is int32 where it enters, as in the reference: a kernel reads it
    out = T.execute_operations(T.image(frame.to(torch.int64)), T.multiply(2.0))
    assert T.last_backend() == "cuda:pointwise" and out.dtype == torch.int32
    out = T.execute_operations(T.image(frame), T.multiply(2.0))
    assert T.last_backend() == "cuda:pointwise" and out.device == frame.device


def test_wrapper_rejects_what_the_kernel_does_not_take(frame, cuda):
    pipeline = T.build_pipeline(*_cases(frame)["ignore_ar"])
    a = kbr.prepare(pipeline, kbr.build_plan(pipeline), cuda)
    with pytest.raises(TypeError):
        kbr.batch_resize(dataclasses.replace(a, fparams=a.fparams.double()))
    with pytest.raises(ValueError):
        kbr.batch_resize(dataclasses.replace(a, rects=a.rects[:3]))
