"""The flagship slice end to end: one pipeline through the JAX package
(``ParBackend.XLA`` on the CPU) and through the port, at a reduced size
(a 256x512 frame, 10 crops, 64x128 output). float32 within 1e-5."""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax

ALPHA, SUB, DIV = 0.3, (3.2, 0.6, 11.8), (128.0, 128.0, 128.0)


def _inputs(seed=20260817):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (256, 512, 3)).astype(np.uint8)
    xy = rng.integers(0, 256 - 120, (10, 2))
    rects = np.concatenate([xy, np.tile([[60, 120]], (10, 1))], axis=1).astype(np.int32)
    return frame, rects


def _ops(m, frame, rects, **kw):
    return (
        m.resize_batch(frame, rects=rects, dsize=m.Size(64, 128), **kw),
        m.convert_to(np.float32, alpha=ALPHA),
        m.subtract(SUB),
        m.divide(DIV),
        m.split_tensor(),
    )


@pytest.mark.parametrize("kw", [
    {},
    {"used_planes": 6, "background": 128.0},
    {"aspect_ratio": "PRESERVE_AR", "background": 128.0},
], ids=["ignore_ar", "ragged", "preserve_ar"])
def test_flagship_slice_matches_reference(kw):
    frame, rects = _inputs()
    jkw = dict(kw)
    tkw = dict(kw)
    if "aspect_ratio" in kw:
        jkw["aspect_ratio"] = J.AspectRatio[kw["aspect_ratio"]]
        tkw["aspect_ratio"] = T.AspectRatio[kw["aspect_ratio"]]
    ref = np.asarray(J.execute_operations(*_ops(J, frame, rects, **jkw), backend=J.ParBackend.XLA))
    assert ref.shape == (10, 3, 128, 64)

    carried = from_jax(J.build_pipeline(*_ops(J, frame, rects, **jkw)))
    out = T.execute_operations(carried.read, *carried.compute, carried.write, device="cpu")
    assert tuple(out.shape) == ref.shape and out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-5

    # the same pipeline built with the port's own factories, frame as a tensor
    native = T.execute_operations(*_ops(T, torch.from_numpy(frame), rects, **tkw))
    assert np.abs(native.numpy() - ref).max() <= 1e-5
    assert T.last_backend() == "torch"


MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _frame_ops(m, frame):
    """Path (a) of the frame slice, at a fifth of 1080p: RGB u8 -> 3:1 resize,
    ImageNet normalization, planar write."""
    return (m.resize(m.image(frame), m.Size(128, 72)), m.convert_to(np.float32, alpha=1 / 255.0),
            m.subtract(MEAN), m.divide(STD), m.split_tensor())


def _nv12_ops(m, buf):
    """Path (b), at a fifteenth of 6K: NV12 fused with a bt709 float
    conversion under a 3:1 resize, x1/255, planar write."""
    return (m.resize(m.fuse(m.read_yuv(buf), m.convert_yuv_to_rgb(standard=m.ColorStandard.BT709,
                                                                  out_dtype=np.float32)),
                     m.Size(128, 72)),
            m.multiply(1 / 255.0), m.split_tensor())


@pytest.mark.parametrize("path", ["a_rgb_normalize", "b_nv12_bt709"])
def test_frame_slice_matches_reference(path):
    """Both frame paths through the JAX package (``ParBackend.XLA``) and,
    carried across with ``from_jax``, through the port. float32 within
    1e-5."""
    rng = np.random.default_rng(20261016)
    if path == "a_rgb_normalize":
        ops = _frame_ops
        src = rng.integers(0, 256, (216, 384, 3)).astype(np.uint8)
    else:
        ops = _nv12_ops
        src = rng.integers(0, 256, (216 * 3 // 2, 384)).astype(np.uint8)
    ref = np.asarray(J.execute_operations(*ops(J, src), backend=J.ParBackend.XLA))
    assert ref.shape == (3, 72, 128)
    carried = from_jax(J.build_pipeline(*ops(J, src)))
    out = T.execute_operations(carried.read, *carried.compute, carried.write, device="cpu")
    assert tuple(out.shape) == ref.shape and out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-5
    native = T.execute_operations(*ops(T, torch.from_numpy(src)), device="cpu")
    assert np.abs(native.numpy() - ref).max() <= 1e-5
    assert T.last_backend() == "torch"


def _warp_ops(m, frame, batch):
    """The warp path at a fifth of 1080p: eight rotations of one frame in
    one batch, ragged at 7, or one rotation; x1/255, planar write."""
    center = (frame.shape[1] / 2, frame.shape[0] / 2)
    rotations = [_rotation(center, 3.0 * i - 10, 1.0 + 0.04 * i) for i in range(8)]
    if batch:
        read = m.warp_batch([m.image(frame)] * 8, rotations, m.Size(128, 72), used_planes=7,
                            default=3.0)
    else:
        # the frame's center lands on the output's center
        shifted = _rotation(center, 10.0, 1 / 3.0) + np.array([[0, 0, 64 - center[0]],
                                                                [0, 0, 36 - center[1]]])
        read = m.warp(m.image(frame), shifted, m.Size(128, 72))
    return read, m.convert_to(np.float32, alpha=1 / 255.0), m.split_tensor()


def _rotation(center, angle, scale):
    a = np.deg2rad(angle)
    al, be = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])


@pytest.mark.parametrize("batch", [True, False], ids=["batch8_ragged", "single_rotation"])
def test_warp_slice_matches_reference(batch):
    """The warp path through the JAX package (``ParBackend.XLA``) and,
    carried across with ``from_jax``, through the port. float32 within
    1e-5."""
    frame = np.random.default_rng(20261017).integers(0, 256, (216, 384, 3)).astype(np.uint8)
    ref = np.asarray(J.execute_operations(*_warp_ops(J, frame, batch), backend=J.ParBackend.XLA))
    assert ref.shape == ((8, 3, 72, 128) if batch else (3, 72, 128))
    carried = from_jax(J.build_pipeline(*_warp_ops(J, frame, batch)))
    out = T.execute_operations(carried.read, *carried.compute, carried.write, device="cpu")
    assert tuple(out.shape) == ref.shape and out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-5
    native = T.execute_operations(*_warp_ops(T, torch.from_numpy(frame), batch), device="cpu")
    assert np.abs(native.numpy() - ref).max() <= 1e-5
    assert T.last_backend() == "torch"
