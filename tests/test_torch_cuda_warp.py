"""The warp kernel on the card: what ``chip_smoke.py`` phases 3 and 4 check
at full size, here for each class of the reference's warp kernels at a
small size and at 1080p. Needs a CUDA device and skips without one. On a
machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_warp.py

The kernel must equal its plain version bit for bit, uint8 and float32.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import _build, executor
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def rotation(center, angle, scale, to=None):
    """``cv2.getRotationMatrix2D``; with ``to``, shifted so that ``center``
    lands on ``to`` in the output."""
    a = math.radians(angle)
    al, be = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    m = np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])
    if to is not None:
        m[:, 2] += (to[0] - cx, to[1] - cy)
    return m


PERSPECTIVE = np.array([[0.3, 0.01, 2.0], [0.005, 0.33, 1.0], [1e-5, 2e-5, 1.0]])


def _image(device, h, w, c=3, seed=1, dtype=torch.uint8):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c is None else (h, w, c)
    return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)).to(device, dtype)


def _cases(device, h, w):
    """One pipeline per class of the reference's warp kernels, on an h x w
    source, and the layouts, chains and sources the kernel takes."""
    img = _image(device, h, w)
    s = h / 1080.0  # keeps the maps' geometry at every source size
    dst = T.Size(max(8, round(640 * s)), max(8, round(360 * s)))
    to_f32 = T.convert_to(np.float32, alpha=1 / 255.0)
    persp = PERSPECTIVE.copy()
    persp[2, :2] /= s
    mid = (dst.width / 2, dst.height / 2)
    rotations = [rotation((w / 2, h / 2), 3 * i - 10, (1 + 0.04 * i) / 3, to=mid)
                 for i in range(8)]
    return {
        "k3_separable": (T.warp(img, np.array([[0.55, 0, 23 * s], [0, 0.62, 11 * s]]), dst),
                         to_f32, T.split_tensor()),
        "k4_rotation": (T.warp(img, rotation((w / 2, h / 2), 10.0, 1 / 3, to=mid), dst), to_f32,
                        T.split_tensor()),
        "k5a_flip": (T.warp(img, np.array([[-0.5, 0, w / 2], [0, 0.5, 2 * s]]), dst), T.split()),
        "k5a_upscale_rotation": (T.warp(img, rotation((w / 2, h / 2), 10.0, 1.2), dst),
                                 T.write()),
        "k5a_perspective": (T.warp(img, persp, dst, warp_type=T.WarpType.PERSPECTIVE),
                            to_f32, T.split_tensor()),
        "k5b_batch_ragged": (T.warp_batch([img] * 8, rotations, dst, used_planes=7, default=3.0),
                             to_f32, T.split_tensor()),
        "u8_chain_four_channels": (T.warp(_image(device, h, w, c=4, seed=2),
                                          rotation((w / 3, h / 3), -25.0, 0.8), dst,
                                          default=(10.0, 20.0, 30.0, 250.0)),
                                   T.convert_to(np.uint8, alpha=0.9, beta=3.0), T.split_tensor()),
        "f32_source": (T.warp(_image(device, h, w, dtype=torch.float32),
                              rotation((w / 2, h / 2), 30.0, 1 / 3, to=mid), dst),
                       T.multiply(1 / 255.0),
                       T.split_tensor()),
        "gray_far_off": (T.warp(_image(device, h, w, c=None),
                                np.array([[1.0, 0, 3e9], [0, 1.0, -1e6]]), dst, default=9.0),
                         T.split_tensor()),
        "batch_perspective_tsplit": (T.warp_batch([_image(device, h, w, seed=3 + i)
                                                   for i in range(3)], [persp] * 3, dst,
                                                  warp_type=T.WarpType.PERSPECTIVE,
                                                  border_value=(1.0, 2.0, 3.0)),
                                     T.subtract((1.0, 2.0, 3.0)), T.split_tensor_transposed()),
        "batch_u8_packed": (T.warp_batch([img] * 3, rotations[:3], dst, used_planes=1,
                                         default=(5.0, 6.0, 7.0)),
                            T.convert_to(np.uint8), T.write_tensor()),
    }


CASES = ["k3_separable", "k4_rotation", "k5a_flip", "k5a_upscale_rotation", "k5a_perspective",
         "k5b_batch_ragged", "u8_chain_four_channels", "f32_source", "gray_far_off",
         "batch_perspective_tsplit", "batch_u8_packed"]


@pytest.mark.parametrize("size", [(96, 384), (1080, 1920)], ids=["small", "1080p"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version(case, size, cuda):
    pipeline = T.build_pipeline(*_cases(cuda, *size)[case])
    a = kw.prepare(pipeline, kw.build_plan(pipeline), cuda)
    got = kw.warp(a)
    want = kw.warp_reference(a)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w), f"max |diff| {float((g.double() - w.double()).abs().max())}"


def _packed_cases(device):
    """The packed tap fetch and its exits, on a 96 x 384 source."""
    h, w = 96, 384
    img = _image(device, h, w)
    flat = torch.from_numpy(np.random.default_rng(5).integers(0, 256, h * w * 3 + 1)
                            .astype(np.uint8)).to(device)
    odd = flat[1:].view(h, w, 3)
    assert odd.data_ptr() % 2 == 1
    ident = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    half = np.array([[1.0, 0.0, 1.5], [0.0, 1.0, 1.5]])
    to_f32 = T.convert_to(np.float32, alpha=1 / 255.0)
    full = T.Size(w, h)
    return {
        # (a) runs in the first and last words of a buffer at an odd address
        "identity_of_a_view_at_byte_offset_1": (T.warp(odd, ident, full), T.split_tensor()),
        "rotation_of_a_view_at_byte_offset_1": (
            T.warp(odd, rotation((w / 2, h / 2), 7.0, 1.0), full, default=(1.0, 2.0, 3.0)), to_f32,
            T.split_tensor()),
        # (e) one valid tap of two on the first and last columns and rows
        "half_pixel_shift": (T.warp(img, half, T.Size(w + 4, h + 4), default=(9.0, 8.0, 7.0)),
                             T.split_tensor()),
        # (b) output rows off the vector's alignment, widths off the pixel group
        "dst_width_61": (T.warp(img, rotation((w / 2, h / 2), -5.0, 0.5, to=(30, 20)),
                                T.Size(61, 40)), to_f32, T.split_tensor()),
        "dst_width_61_u8_out": (T.warp(img, rotation((w / 2, h / 2), -5.0, 0.5, to=(30, 20)),
                                       T.Size(61, 40)), T.convert_to(np.uint8), T.split_tensor()),
        "one_channel_rotation": (T.warp(img[..., :1].contiguous(),
                                        rotation((w / 2, h / 2), 12.0, 0.9), full), to_f32,
                                 T.split_tensor()),
        "two_rows_source": (T.warp(img[:2].contiguous(), ident, T.Size(w, 2)), T.split_tensor()),
        # a perspective denominator that is 0 on the output's column 64; coordinates past int32
        "perspective_den_zero": (
            T.warp(img, np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1 / 64.0, 0.0, 1.0]]), full,
                   warp_type=T.WarpType.PERSPECTIVE, default=(1.0, 2.0, 3.0)), to_f32,
            T.split_tensor()),
        "perspective_beyond_int32": (
            T.warp(img, np.array([[1e-9, 0.0, 3.0], [0.0, 1e-9, 5.0], [0.0, 0.0, 1.0]]), full,
                   warp_type=T.WarpType.PERSPECTIVE, default=(1.0, 2.0, 3.0)), to_f32,
            T.split_tensor()),
        # (d) a ragged count read from device memory (a small launch: 1 pixel a thread); two
        # launches large enough for 4 pixels a thread, widths off the group
        "batch_used_planes_on_the_device": (
            T.warp_batch([img] * 4, [rotation((w / 2, h / 2), 4.0 * i, 1.0) for i in range(4)],
                         full, used_planes=torch.tensor(3, dtype=torch.int32, device=device),
                         default=3.0), to_f32, T.split_tensor()),
        "launch_just_past_the_four_pixel_threshold": (
            T.warp_batch([img] * 3, [rotation((w / 2, h / 2), 5.0 * i, 0.3, to=(320, 180))
                                     for i in range(3)], T.Size(642, 360), default=2.0), to_f32,
            T.split_tensor()),
        "large_launch_four_pixels_a_thread": (
            T.warp_batch([odd] * 6, [rotation((w / 2, h / 2), 5.0 * i - 9.0, 0.2 + 0.01 * i,
                                              to=(480, 270)) for i in range(6)],
                         T.Size(961, 540), used_planes=5, default=(4.0, 5.0, 6.0)), to_f32,
            T.split_tensor()),
    }


PACKED_CASES = ["identity_of_a_view_at_byte_offset_1", "rotation_of_a_view_at_byte_offset_1",
                "half_pixel_shift", "dst_width_61", "dst_width_61_u8_out", "one_channel_rotation",
                "two_rows_source", "perspective_den_zero", "perspective_beyond_int32",
                "batch_used_planes_on_the_device", "launch_just_past_the_four_pixel_threshold",
                "large_launch_four_pixels_a_thread"]


@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_fetch_and_its_exits_match_plain_version(case, cuda):
    pipeline = T.build_pipeline(*_packed_cases(cuda)[case])
    a = kw.prepare(pipeline, kw.build_plan(pipeline), cuda)
    got = kw.warp(a)
    want = kw.warp_reference(a)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), f"max |diff| {float((got.double() - want.double()).abs().max())}"


def test_main_path_launches_the_kernel_once_per_call(cuda):
    frame = _image(cuda, 96, 384)

    def call(angle, used):
        return T.execute_operations(
            T.warp_batch([frame] * 8,
                         [rotation((192, 48), angle + 3 * i, 0.4, to=(64, 32)) for i in range(8)],
                         T.Size(128, 64), used_planes=used, default=3.0),
            T.convert_to(np.float32, alpha=1 / 255.0), T.split_tensor())

    first = call(0.0, 7)
    launches, builds = kw.LAUNCHES, executor.PLAN_BUILDS
    second = call(5.0, 5)
    torch.cuda.synchronize()
    assert T.last_backend() == "cuda:warp"
    assert kw.LAUNCHES == launches + 1 and executor.PLAN_BUILDS == builds
    assert not torch.equal(first, second)
    assert bool((second[5:] == np.float32(3.0) * np.float32(1 / 255.0)).all())


def test_explicit_cuda_raises_on_a_refused_warp(cuda):
    img = _image(cuda, 96, 384)
    ok = (T.warp(img, rotation((192, 48), 10.0, 0.5), T.Size(64, 32)), T.split_tensor())
    assert T.describe_backend(*ok, backend=T.ParBackend.CUDA) == "cuda:warp"
    # a third resampling node: no kernel takes it (a warp of a resize is the
    # composed kernel's)
    inner = T.warp(T.image(img), rotation((192, 48), 5.0, 1.0), T.Size(384, 96))
    refused = (T.warp(T.resize(inner, T.Size(192, 48)), rotation((96, 24), 10.0, 0.5),
                      T.Size(64, 32)), T.split_tensor())
    assert T.describe_backend(*refused) == "torch"
    with pytest.raises(ValueError, match="cannot run"):
        T.execute_operations(*refused, backend=T.ParBackend.CUDA)


def test_a_cpu_tensor_never_reaches_the_library(cuda, monkeypatch):
    pipeline = T.build_pipeline(T.warp(_image("cpu", 96, 384), rotation((192, 48), 10.0, 0.5),
                                       T.Size(64, 32)), T.split_tensor())
    a = kw.prepare(pipeline, kw.build_plan(pipeline), torch.device("cpu"))

    def refuse():
        raise AssertionError("the library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    launches = kw.LAUNCHES
    out = kw.warp(a)
    assert out.device.type == "cpu" and kw.LAUNCHES == launches


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    pipeline = T.build_pipeline(*_cases(cuda, 96, 384)["k5b_batch_ragged"])
    a = kw.prepare(pipeline, kw.build_plan(pipeline), cuda)
    with pytest.raises(TypeError):
        kw.warp(dataclasses.replace(a, coeffs=a.coeffs.double()))
    with pytest.raises(ValueError):
        kw.warp(dataclasses.replace(a, srcs=(a.srcs[0][:48],)))
    with pytest.raises(ValueError):
        kw.warp(dataclasses.replace(a, border=a.border[:4]))
