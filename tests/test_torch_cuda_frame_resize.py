"""The full-frame resize kernel on the card, at small sizes: what
``chip_smoke.py`` phases 3 and 4 check at the frame paths' full sizes. Needs
a CUDA device and skips without one. On a machine with a card and without
jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_frame_resize.py

uint8 outputs must equal the plain version bit for bit, float32 within 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.exec import executor

pytestmark = pytest.mark.gpu

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
NORMALIZE = (T.convert_to(np.float32, alpha=1 / 255.0), T.subtract(MEAN), T.divide(STD))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _image(cuda, h=96, w=384, c=3, seed=1, dtype=torch.uint8):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (h, w, c)).astype(np.uint8)).to(cuda, dtype)


def _nv12(cuda, h=144, w=384, seed=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (h * 3 // 2, w)).astype(np.uint8)).to(cuda)


def _yuv(buf, size, fmt=T.PixelFormat.NV12, **conv):
    return T.resize(T.fuse(T.read_yuv(buf, pixel_format=fmt),
                           T.convert_yuv_to_rgb(out_dtype=np.float32, **conv)), T.Size(*size))


def _odd(t):
    """``t``'s values in a view one byte past an aligned address."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    view = flat[1:].view(t.shape)
    assert view.data_ptr() % 2 == 1
    return view


def _cases(cuda):
    img, buf = _image(cuda), _nv12(cuda)
    C = T.ColorConversionCode
    # launches of 473,088 outputs and more (an NV12 source: 540,672) take 4 pixels per
    # thread on an H100
    big, big_buf = _image(cuda, h=720, w=1283, seed=5), _nv12(cuda, h=1080, w=1920, seed=6)
    return {
        "p4_odd_pitch_packed_out": (T.resize(T.image(big), T.Size(1023, 540)), *NORMALIZE,
                                    T.write()),
        "p4_odd_address_planar": (T.resize(T.image(_odd(big)), T.Size(1024, 540)), *NORMALIZE,
                                  T.split_tensor()),
        "p4_u8_planar": (T.resize(T.image(big), T.Size(1024, 540)),
                         T.convert_to(np.uint8, alpha=0.5, beta=3.0), T.split_tensor()),
        "p4_f32_rgba_source": (T.resize(T.image(_image(cuda, h=720, w=1283, c=4, seed=7,
                                                       dtype=torch.float32)), T.Size(1024, 540)),
                               T.multiply(1 / 255.0), T.split_tensor()),
        "p4_nv12": (_yuv(big_buf, (1278, 718)), T.multiply(1 / 255.0), T.split_tensor()),
        "p4_nv21_odd_address": (_yuv(_odd(big_buf), (1280, 720), T.PixelFormat.NV21, alpha=True),
                                T.write()),
        "odd_address_small": (T.resize(T.image(_odd(img)), T.Size(128, 32)), *NORMALIZE,
                              T.split_tensor()),
        "nv12_odd_address_small": (_yuv(_odd(buf), (128, 48)), T.multiply(1 / 255.0),
                                   T.split_tensor()),
        "3to1_normalize": (T.resize(T.image(img), T.Size(128, 32)), *NORMALIZE, T.split_tensor()),
        "1.5to1_packed_out": (T.resize(T.image(img), T.Size(256, 64)), *NORMALIZE, T.write()),
        "over_32_phases": (T.resize(T.image(img), T.Size(97, 41)), *NORMALIZE, T.split_tensor()),
        "upscale": (T.resize(T.image(_image(cuda, h=36, w=64)), T.Size(128, 72)), *NORMALIZE,
                    T.split_tensor()),
        "odd_sizes_gray": (T.resize(T.image(_image(cuda, h=37, w=61, c=1)), T.Size(13, 7)),
                           T.multiply(3.0), T.split_tensor()),
        "f32_source": (T.resize(T.image(_image(cuda, dtype=torch.float32)), T.Size(256, 64)),
                       T.multiply(1 / 255.0), T.split_tensor()),
        "u8_split": (T.resize(T.image(img), T.Size(256, 64)),
                     T.convert_to(np.uint8, alpha=0.5, beta=3.0), T.split()),
        "bgr2rgba": (T.resize(T.image(img), T.Size(128, 32)), T.cvt_color(C.COLOR_BGR2RGBA),
                     T.convert_to(np.float32, alpha=1 / 255.0), T.subtract((*MEAN, 0.0)),
                     T.split_tensor()),
        "nv12_bt709": (_yuv(buf, (128, 48), standard=T.ColorStandard.BT709),
                       T.multiply(1 / 255.0), T.split_tensor()),
        "nv21_limited_alpha": (_yuv(buf, (256, 96), T.PixelFormat.NV21, alpha=True,
                                    color_range=T.ColorRange.LIMITED), T.split_tensor()),
        "nv12_over_32_phases": (_yuv(buf, (97, 41)), T.convert_to(np.uint8), T.split_tensor()),
    }


CASE_NAMES = ["p4_odd_pitch_packed_out", "p4_odd_address_planar", "p4_u8_planar",
              "p4_f32_rgba_source", "p4_nv12", "p4_nv21_odd_address", "odd_address_small",
              "nv12_odd_address_small", "3to1_normalize", "1.5to1_packed_out", "over_32_phases", "upscale",
              "odd_sizes_gray", "f32_source", "u8_split", "bgr2rgba", "nv12_bt709",
              "nv21_limited_alpha", "nv12_over_32_phases"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_kernel_matches_plain_version(case, cuda):
    pipeline = T.build_pipeline(*_cases(cuda)[case])
    a = kfr.prepare(pipeline, kfr.build_plan(pipeline), cuda)
    got = kfr.frame_resize(a)
    want = kfr.frame_resize_reference(a)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.uint8:
            assert torch.equal(g, w)
        else:
            assert bool(torch.isfinite(g).all())
            assert float((g - w).abs().max()) <= 1e-6


@pytest.mark.parametrize("path", ["rgb", "nv12"])
def test_main_path_launches_the_kernel_once_per_call(path, cuda):
    def call(seed):
        if path == "rgb":
            return T.execute_operations(T.resize(T.image(_image(cuda, seed=seed)), T.Size(128, 32)),
                                        *NORMALIZE, T.split_tensor())
        return T.execute_operations(_yuv(_nv12(cuda, seed=seed), (128, 48)),
                                    T.multiply(1 / 255.0), T.split_tensor())

    first = call(3)
    launches, builds = kfr.LAUNCHES, executor.PLAN_BUILDS
    out = call(4)
    torch.cuda.synchronize()
    assert T.last_backend() == "cuda:frame_resize"
    assert kfr.LAUNCHES == launches + 1 and executor.PLAN_BUILDS == builds
    assert bool(torch.isfinite(out).all()) and not torch.equal(first, out)


def test_explicit_cuda_selects_the_frame_kernel(cuda):
    ops = (T.resize(T.image(_image(cuda)), T.Size(128, 32)), T.split_tensor())
    assert T.describe_backend(*ops, backend=T.ParBackend.CUDA) == "cuda:frame_resize"
    with pytest.raises(ValueError, match="cannot run"):
        T.execute_operations(T.resize(T.image(_image(cuda)), T.Size(128, 32)), T.write_tensor(),
                             backend=T.ParBackend.CUDA)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    pipeline = T.build_pipeline(*_cases(cuda)["3to1_normalize"])
    a = kfr.prepare(pipeline, kfr.build_plan(pipeline), cuda)
    with pytest.raises(TypeError):
        kfr.frame_resize(dataclasses.replace(a, weights=a.weights.double()))
    with pytest.raises(ValueError):
        kfr.frame_resize(dataclasses.replace(a, src=a.src[:48]))
