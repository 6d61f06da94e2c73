"""Crop and border reads (``crop``, ``crop_batch``, ``make_border``), and the
clamp-then-truncate cast of a stored value: the port against the JAX
package and OpenCV.

Each case is built with the same factories in both packages from one numpy
input. Crops and borders move values without arithmetic, so the port equals
the reference bit for bit; where a resize or a warp follows, the port
equals the reference's op-by-op lowering (``Pipeline.lower()`` outside jit)
bit for bit and its jitted XLA path within 1e-4, which contracts the lerps
into FMAs on the CPU (ROADMAP §3).
"""

import math

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.ops.border import BorderRead, border_index
from cvgpuspeedup_tpu_torch.ops.crop import CropRead
from cvgpuspeedup_tpu_torch.utils import dtypes as dt

F32_TOL = 1e-4
CUDA = torch.device("cuda")  # only named: the routing tests decide on shapes

CV_MODE = {
    "CONSTANT": cv2.BORDER_CONSTANT,
    "REPLICATE": cv2.BORDER_REPLICATE,
    "REFLECT": cv2.BORDER_REFLECT,
    "REFLECT_101": cv2.BORDER_REFLECT_101,
    "WRAP": cv2.BORDER_WRAP,
}
MODES = list(CV_MODE)


def _img(shape, seed=0, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(dtype)


def _port(*ops):
    return T.execute_operations(*ops, device="cpu").numpy()


def _ref(*ops):
    return np.asarray(J.execute_operations(*ops, backend=J.ParBackend.XLA))


def _op_by_op(*ops):
    return np.asarray(J.build_pipeline(*ops).lower())


def _both(build):
    """The same pipeline built with each package's factories."""
    return build(T), build(J)


# --- crop ----------------------------------------------------------------------


def test_crop_identity():
    frame = _img((64, 64, 3), 1)
    out = _port(T.crop(frame, T.Rect(5, 9, 20, 30)))
    np.testing.assert_array_equal(out, frame[9:39, 5:25])
    np.testing.assert_array_equal(out, _ref(J.crop(frame, J.Rect(5, 9, 20, 30))))


@pytest.mark.parametrize("rect,rows,cols", [
    ((-3, 0, 5, 4), (0, 4), (7, 12)),    # -3 counts from the far edge (9), then clamps to 7
    ((9, 8, 5, 4), (6, 10), (7, 12)),    # past the edge only clamps
    ((-12, -10, 5, 4), (0, 4), (0, 5)),  # -W reads from 0
    ((-1, -1, 12, 10), (0, 10), (0, 12)),  # a crop of the whole image
    ((2, 3, 5, 4), (3, 7), (2, 7)),
])
def test_crop_origin_follows_dynamic_slice(rect, rows, cols):
    """``jax.lax.dynamic_slice``'s rule: a negative start counts from the
    far edge, then the start is clamped to ``[0, dim - size]``."""
    img = np.arange(10 * 12, dtype=np.float32).reshape(10, 12, 1)
    out = _port(T.crop(T.image(img), T.Rect(*rect)))
    np.testing.assert_array_equal(out, img[rows[0]:rows[1], cols[0]:cols[1]])
    np.testing.assert_array_equal(out, _ref(J.crop(J.image(img), J.Rect(*rect))))
    np.testing.assert_array_equal(out, _op_by_op(J.crop(J.image(img), J.Rect(*rect))))


@pytest.mark.parametrize("x,y", [(-3, 2), (4, -20), (30, 30)])
def test_crop_of_a_batch_crops_every_plane_alike(x, y):
    batch = _img((3, 10, 12, 2), 2)
    out = _port(T.crop(T.image(batch), T.Rect(x, y, 5, 4)))
    assert out.shape == (3, 4, 5, 2)
    np.testing.assert_array_equal(out, _ref(J.crop(J.image(batch), J.Rect(x, y, 5, 4))))


def test_crop_that_does_not_fit_raises():
    with pytest.raises(ValueError, match="does not fit"):
        _port(T.crop(_img((8, 8, 3)), T.Rect(0, 0, 9, 4)))
    with pytest.raises(ValueError, match="needs a rect"):
        T.crop(_img((8, 8, 3)))


def test_crop_origin_is_a_runtime_value():
    frame = _img((40, 50, 3), 3)
    builds = None
    outs = []
    for x in (1, 6, 11):
        outs.append(_port(T.crop(frame, T.Rect(x, 2, 16, 12)),
                          T.convert_to(np.float32, alpha=2.0)))
        if builds is None:
            builds = executor.PLAN_BUILDS
    assert executor.PLAN_BUILDS == builds
    np.testing.assert_array_equal(outs[2], frame[2:14, 11:27].astype(np.float32) * 2.0)


def test_crop_then_resize_then_split():
    """crop -> resize -> normalize -> split, as the reference's
    ``tests/test_resize.py`` composes it."""
    frame = _img((216, 384, 3), 4)
    tp, jp = _both(lambda m: (m.resize(m.crop(frame, m.Rect(17, 23, 60, 120)), m.Size(64, 128)),
                              m.multiply(0.5), m.split_tensor()))
    out = _port(*tp)
    assert out.shape == (3, 128, 64)
    np.testing.assert_array_equal(out, _op_by_op(*jp))
    assert np.abs(out - _ref(*jp)).max() <= F32_TOL
    crop = frame[23:143, 17:77].astype(np.float32)
    cv = cv2.resize(crop, (64, 128), interpolation=cv2.INTER_LINEAR) * np.float32(0.5)
    assert np.abs(out - cv.transpose(2, 0, 1)).max() <= F32_TOL


def test_crop_as_a_pending_geometry_op():
    """``crop(rect)`` alone binds to the read before it."""
    frame = _img((30, 40, 3), 5)
    out = _port(T.image(frame), T.crop(T.Rect(4, 5, 10, 8)), T.convert_to(np.float32))
    np.testing.assert_array_equal(out, frame[5:13, 4:14].astype(np.float32))
    np.testing.assert_array_equal(
        out, _ref(J.image(frame), J.crop(J.Rect(4, 5, 10, 8)), J.convert_to(np.float32)))


def test_crop_batch_same_size():
    frame = _img((64, 64, 3), 6)
    rects = [(i, 2 * i, 16, 12) for i in range(4)]
    out = _port(T.crop_batch(frame, [T.Rect(*r) for r in rects]))
    assert out.shape == (4, 12, 16, 3)
    for i, (x, y, w, h) in enumerate(rects):
        np.testing.assert_array_equal(out[i], frame[y:y + h, x:x + w])
    np.testing.assert_array_equal(out, _ref(J.crop_batch(frame, [J.Rect(*r) for r in rects])))
    with pytest.raises(ValueError, match="equal crop sizes"):
        T.crop_batch(frame, [T.Rect(0, 0, 8, 8), T.Rect(0, 0, 9, 8)])


def test_from_jax_carries_crops_across():
    frame = _img((20, 24, 3), 7)
    jop = J.crop_batch(frame, [J.Rect(-2, 1, 8, 6), J.Rect(3, 30, 8, 6)])
    top = from_jax(jop)
    assert type(top.ops[0]).__name__ == "CropRead" and top.ops[0].width == 8
    np.testing.assert_array_equal(_port(top), np.asarray(jop.lower()))


# --- border --------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_make_border_vs_cv2_and_the_reference(mode):
    img = _img((10, 14, 3), 8)
    out = _port(T.make_border(img, 3, 2, 4, 1, mode=T.BorderMode[mode], value=7))
    ref = cv2.copyMakeBorder(img, 3, 2, 4, 1, CV_MODE[mode], value=(7, 7, 7))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, _ref(J.make_border(img, 3, 2, 4, 1, mode=J.BorderMode[mode], value=7)))


@pytest.mark.parametrize("mode", MODES)
def test_border_wider_than_the_source_repeats_as_numpy_pad(mode):
    """``torch.nn.functional.pad`` refuses a reflect pad of the side or more;
    the reference pads with ``numpy.pad``'s rule, which repeats."""
    img = _img((3, 4, 2), 9).astype(np.float32)
    args = (img, 7, 5, 9, 6)
    out = _port(T.make_border(*args, mode=T.BorderMode[mode], value=(1.5, -2.0)))
    assert out.shape == (15, 19, 2)
    np.testing.assert_array_equal(
        out, _ref(J.make_border(*args, mode=J.BorderMode[mode], value=(1.5, -2.0))))


def test_border_per_channel_constant_and_default_mode():
    img = _img((6, 5, 3), 10)
    out = _port(T.make_border(img, 1, 2, 3, 0, mode=T.BorderMode.CONSTANT, value=(9, 8, 7)))
    np.testing.assert_array_equal(out[0, 0], [9, 8, 7])
    np.testing.assert_array_equal(
        out, _ref(J.make_border(img, 1, 2, 3, 0, mode=J.BorderMode.CONSTANT, value=(9, 8, 7))))
    default = T.make_border(img, 1, 1, 1, 1)
    assert default.mode == T.BorderMode.REFLECT_101
    np.testing.assert_array_equal(_port(default), cv2.copyMakeBorder(img, 1, 1, 1, 1,
                                                                     cv2.BORDER_REFLECT_101))


def test_border_index_maps():
    assert border_index(4, 2, 2, T.BorderMode.REFLECT_101).tolist() == [2, 1, 0, 1, 2, 3, 2, 1]
    assert border_index(4, 2, 2, T.BorderMode.REFLECT).tolist() == [1, 0, 0, 1, 2, 3, 3, 2]
    assert border_index(4, 2, 2, T.BorderMode.WRAP).tolist() == [2, 3, 0, 1, 2, 3, 0, 1]
    assert border_index(4, 2, 2, T.BorderMode.REPLICATE).tolist() == [0, 0, 0, 1, 2, 3, 3, 3]


def test_border_of_a_batch():
    batch = _img((2, 5, 6, 3), 11)
    out = _port(T.make_border(T.image(batch), 2, 1, 0, 3, mode=T.BorderMode.WRAP))
    assert out.shape == (2, 8, 9, 3)
    np.testing.assert_array_equal(
        out, _ref(J.make_border(J.image(batch), 2, 1, 0, 3, mode=J.BorderMode.WRAP)))


def test_border_then_resize():
    img = _img((12, 16, 3), 12)
    tp, jp = _both(lambda m: (m.resize(m.make_border(img, 2, 2, 2, 2, mode=m.BorderMode.REPLICATE),
                                       m.Size(8, 8)),))
    out = _port(*tp)
    np.testing.assert_array_equal(out, _op_by_op(*jp))
    ref = cv2.resize(cv2.copyMakeBorder(img, 2, 2, 2, 2, cv2.BORDER_REPLICATE).astype(np.float32),
                     (8, 8), interpolation=cv2.INTER_LINEAR)
    assert np.abs(out - ref).max() <= F32_TOL


@pytest.mark.parametrize("mode", ["REPLICATE", "REFLECT_101", "CONSTANT"])
def test_border_under_warp(mode):
    """A border read as the warp's source: the port equals the reference's
    op-by-op lowering bit for bit and its XLA path within 1e-4."""
    img = _img((30, 40, 3), 13)
    a = math.radians(10.0)
    al, be = 0.8 * math.cos(a), 0.8 * math.sin(a)
    m = np.array([[al, be, (1 - al) * 20.0 - be * 15.0], [-be, al, be * 20.0 + (1 - al) * 15.0]])
    tp, jp = _both(lambda k: (k.warp(k.make_border(img, 4, 3, 5, 2, mode=k.BorderMode[mode],
                                                   value=9), m, k.Size(48, 40)),))
    out = _port(*tp)
    np.testing.assert_array_equal(out, _op_by_op(*jp))
    assert np.abs(out - _ref(*jp)).max() <= F32_TOL


def test_from_jax_carries_a_border_across():
    img = _img((5, 7, 3), 14)
    jop = J.make_border(img, 1, 2, 3, 4, mode=J.BorderMode.WRAP, value=(1, 2, 3))
    top = from_jax(jop)
    assert isinstance(top, BorderRead) and top.mode is T.BorderMode.WRAP
    assert (top.top, top.bottom, top.left, top.right) == (1, 2, 3, 4)
    np.testing.assert_array_equal(_port(top), np.asarray(jop.lower()))


def test_no_kernel_takes_a_border_or_a_crop_source():
    """No resampling kernel of the TPU reads a border or a crop source: on
    a CUDA device a resize or a warp of one is none of theirs and runs in the
    composed-read kernel, which walks the stage per tap (the decision is
    made on shapes)."""
    img = _img((20, 24, 3), 15)
    m = np.array([[0.9, 0.1, 1.0], [-0.1, 0.9, 2.0]])
    for read in (T.make_border(img, 2, 2, 2, 2), T.crop(img, T.Rect(1, 1, 16, 12))):
        for head in (T.resize(read, T.Size(8, 6)), T.warp(read, m, T.Size(8, 6))):
            pipe = T.build_pipeline(head, T.split_tensor())
            for module in (kbr, kfr, kw, kp):
                with pytest.raises(module.Unsupported):
                    module.build_plan(pipe)
            assert executor._select(pipe, T.ParBackend.AUTO, CUDA).backend == "cuda:composed"
            assert executor._select(pipe, T.ParBackend.CUDA, CUDA).backend == "cuda:composed"
    assert isinstance(T.crop(img, T.Rect(0, 0, 4, 4)), CropRead)
    with pytest.raises(kbr.Unsupported):
        kbr.build_plan(T.build_pipeline(T.crop(img, T.Rect(0, 0, 4, 4))))


# --- the cast of a stored value ------------------------------------------------


def test_astype_clamps_then_truncates_as_the_reference():
    """The divergent merge and a ring slot store a value of another dtype as
    the reference's ``astype`` does: clamp, then truncate; not
    ``saturate_cast``, which rounds half to even."""
    f = np.array([3.7, 200.9, -0.5, 255.6, 297.5, -300.0, 254.5, 0.5, 1e10, -1e10], np.float32)
    got = dt.astype(torch.from_numpy(f), np.uint8).numpy()
    np.testing.assert_array_equal(got[:8], [3, 200, 0, 255, 255, 0, 254, 0])
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(f).astype(jnp.uint8)))
    i16 = dt.astype(torch.from_numpy(np.array([40000.5, -40000.5, -1.5], np.float32)), np.int16)
    np.testing.assert_array_equal(i16.numpy(), [32767, -32768, -1])
    same = torch.arange(4, dtype=torch.float32)
    assert dt.astype(same, torch.float32) is same
