"""The factories ``static_loop``, ``vector_reorder``, ``set_to``, ``Point``
and ``saturate_cast_fn`` of the port against the reference package's, on the
CPU: the same numpy inputs through both, integer outputs bit for bit, float
outputs within 1e-4 (the reference's XLA path contracts multiply-adds).
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax

F32_TOL = 1e-4


def _img(seed, shape=(12, 20, 3), dtype=np.uint8):
    v = np.random.default_rng(seed).integers(0, 256, shape)
    return v.astype(dtype)


def _both(make, img):
    """``make(M)`` builds the ops after the read with package ``M``'s
    factories; returns (port output, reference output) as numpy."""
    got = T.execute_operations(T.image(torch.from_numpy(img)), *make(T), T.write(), device="cpu")
    want = J.execute_operations(J.image(img), *make(J), J.write(), backend=J.ParBackend.XLA)
    return got.numpy(), np.asarray(want)


def test_the_reference_surface_is_exported():
    for name in ("static_loop", "vector_reorder", "set_to", "Point", "saturate_cast_fn",
                 "StaticLoop", "VectorReorder"):
        assert name in T.__all__ and hasattr(T, name), name
    missing = [n for n in J.__all__ if n not in T.__all__]
    assert missing == [], missing


@pytest.mark.parametrize("indices", [(2, 1, 0), (1, 2, 0), (0, 0, 2)])
def test_vector_reorder_matches_the_reference(indices):
    got, want = _both(lambda m: (m.vector_reorder(*indices),), _img(1))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert T.vector_reorder(*indices) == T.VectorReorder(indices=indices)
    assert from_jax(J.vector_reorder(*indices)) == T.vector_reorder(*indices)


def test_vector_reorder_on_four_channels_in_a_float_chain():
    got, want = _both(lambda m: (m.vector_reorder(3, 0, 1, 2), m.convert_to(np.float32, alpha=0.25)),
                      _img(2, (9, 7, 4)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("n", [1, 3, 20])
def test_static_loop_matches_the_reference(n):
    def make(m):
        return (m.convert_to(np.float32), m.static_loop(m.fuse(m.multiply(1.01), m.add(0.5)), n))

    got, want = _both(make, _img(3))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * max(1.0, float(want.max()) / 255))
    loop = T.static_loop(T.multiply(2.0), n)
    assert isinstance(loop, T.StaticLoop) and loop.n == n
    again = from_jax(J.static_loop(J.multiply(2.0), n))
    assert isinstance(again, T.StaticLoop) and again.n == n


def test_static_loop_on_uint8_saturates_after_every_pass():
    """Seven passes of +40 on uint8 pin every value at 255, in both."""
    got, want = _both(lambda m: (m.static_loop(m.add(40.0), 7),), _img(4))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got == 255).all()


def test_static_loop_is_one_parameter_slot_in_the_kernel_chain():
    """The kernels' encoder repeats the body's rows over one set of
    parameters, so a loop of 200 passes costs one scalar."""
    loop = T.static_loop(T.fuse(T.multiply(1.01), T.add(0.5)), 200)
    ops, dtype, ch, n_params = kbr.encode_chain((loop,), 3)
    assert ops.shape == (400, 4) and n_params == 2 and ch == 3 and dtype == torch.float32
    assert set(ops[:, 1]) == {0, 1}


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int32])
def test_set_to_matches_the_reference(dtype):
    got = T.set_to(7, (2, 3, 4), dtype, device="cpu")
    want = np.asarray(J.set_to(7, (2, 3, 4), dtype))
    assert got.numpy().dtype == want.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_set_to_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        T.set_to(1.0, (2, 2))
    assert T.set_to(1.0, (2, 2), device="cpu").device.type == "cpu"


def test_point_matches_the_reference():
    assert T.Point._fields == J.Point._fields
    assert tuple(T.Point()) == tuple(J.Point()) == (0, 0, 0)
    assert tuple(T.Point(3, 4)) == tuple(J.Point(3, 4)) and T.Point(1, 2, 5).z == 5


@pytest.mark.parametrize("dst", [np.uint8, np.int8, np.int16, np.float32])
@pytest.mark.parametrize("src", [np.float32, np.int16, np.uint8])
def test_saturate_cast_fn_matches_the_reference(src, dst):
    """Half-way values round to even, out-of-range ones clamp, a signed
    source is widened before it meets an unsigned range."""
    if src == np.float32:
        x = np.array([-300.7, -128.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127.5, 254.5, 255.5, 40000.2,
                      -40000.0], np.float32)
    else:
        info = np.iinfo(src)
        x = np.array([info.min, info.min + 1, -1 if info.min < 0 else 0, 0, 1, 127, 128,
                      min(255, info.max), min(256, info.max), info.max], src)
    got = T.saturate_cast_fn(torch.from_numpy(x), dst).numpy()
    want = np.asarray(J.saturate_cast_fn(x, dst))
    assert got.dtype == want.dtype
    if np.issubdtype(np.dtype(dst), np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
