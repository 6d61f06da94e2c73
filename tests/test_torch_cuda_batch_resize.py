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
    with pytest.raises(ValueError, match="cannot run"):
        T.execute_operations(T.image(frame), T.multiply(2.0), backend=T.ParBackend.CUDA)
    out = T.execute_operations(T.image(frame), T.multiply(2.0))
    assert T.last_backend() == "torch" and out.device == frame.device


def test_wrapper_rejects_what_the_kernel_does_not_take(frame, cuda):
    pipeline = T.build_pipeline(*_cases(frame)["ignore_ar"])
    a = kbr.prepare(pipeline, kbr.build_plan(pipeline), cuda)
    with pytest.raises(TypeError):
        kbr.batch_resize(dataclasses.replace(a, fparams=a.fparams.double()))
    with pytest.raises(ValueError):
        kbr.batch_resize(dataclasses.replace(a, rects=a.rects[:3]))
