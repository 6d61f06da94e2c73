"""The port's executor: pipeline normalization, error paths, backend choice,
the plan cache and ``from_jax``."""

import dataclasses

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import flatten
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.ops.arithmetic import Mul, Sub
from cvgpuspeedup_tpu_torch.ops.cast import SaturateCast
from cvgpuspeedup_tpu_torch.ops.memory import ImageRead, TensorSplit, Write2D

UP = (64, 128)


def _on_cpu(m):
    """The port's entry points default to the card; the reference has no
    ``device`` argument."""
    return {"device": "cpu"} if m is T else {}


@pytest.fixture
def frame():
    return np.random.default_rng(11).integers(0, 256, (96, 160, 3)).astype(np.uint8)


@pytest.fixture
def rects():
    return np.array([[i * 3, i * 2, 60, 40] for i in range(5)], np.int32)


def _flagship(m, frame, rects, **kw):
    return (
        m.resize_batch(frame, rects=rects, dsize=m.Size(*UP), **kw),
        m.convert_to(np.float32, alpha=0.3),
        m.subtract((3.2, 0.6, 11.8)),
        m.divide((128.0, 128.0, 128.0)),
        m.split_tensor(),
    )


def test_build_pipeline_normalizes(frame):
    p = T.build_pipeline(T.image(frame), T.convert_to(np.float32, alpha=2.0), T.subtract(1.0))
    assert isinstance(p.read, ImageRead)
    assert isinstance(p.write, Write2D)
    assert [type(o) for o in p.compute] == [SaturateCast, Mul, Sub]
    p2 = T.build_pipeline(T.multiply(2.0), T.split_tensor(), input=torch.from_numpy(frame))
    assert isinstance(p2.read, ImageRead) and isinstance(p2.write, TensorSplit)
    out = T.execute_operations(T.multiply(2.0), input=torch.from_numpy(frame), device="cpu")
    assert out.dtype == torch.uint8 and int(out.max()) == 255


def _error_cases(m, frame, rects):
    return {
        "wrong_length_scalar": (ValueError, lambda: m.execute_operations(
            m.resize_batch(frame, rects=rects, dsize=m.Size(*UP)), m.subtract((1.0, 2.0)),
            **_on_cpu(m))),
        "compute_without_read": (ValueError, lambda: m.execute_operations(
            m.multiply(2.0), **_on_cpu(m))),
        "rects_wrong_shape": (ValueError, lambda: m.resize_batch(
            frame, rects=np.zeros((3, 3), np.int32), dsize=m.Size(*UP))),
        "rects_one_dim": (ValueError, lambda: m.resize_batch(
            frame, rects=np.zeros((4,), np.int32), dsize=m.Size(*UP))),
        "write_mid_pipeline": (TypeError, lambda: m.execute_operations(
            m.image(frame), m.split_tensor(), m.multiply(2.0), **_on_cpu(m))),
        "input_and_read": (ValueError, lambda: m.build_pipeline(m.image(frame), input=frame)),
        "background_wrong_length": (ValueError, lambda: m.resize_batch(
            frame, rects=rects, dsize=m.Size(*UP), background=(1.0, 2.0))),
        "scalar_of_rank_two": (ValueError, lambda: m.execute_operations(
            m.image(frame), m.multiply(np.ones((2, 3), np.float32)), **_on_cpu(m))),
    }


@pytest.mark.parametrize("case", sorted(_error_cases(T, None, None)))
def test_error_paths_raise_like_reference(case, frame, rects):
    jexc, jfn = _error_cases(J, frame, rects)[case]
    texc, tfn = _error_cases(T, frame, rects)[case]
    with pytest.raises(jexc):
        jfn()
    with pytest.raises(texc):
        tfn()
    assert jexc is texc


def test_backend_on_cpu_is_torch(frame, rects):
    ops = _flagship(T, frame, rects)
    assert T.describe_backend(*ops, device="cpu") == "torch"
    T.execute_operations(*ops, device="cpu")
    assert T.last_backend() == "torch"
    assert T.describe_backend(*ops, backend=T.ParBackend.TORCH, device="cpu") == "torch"


def test_explicit_cuda_on_cpu_tensor_raises(frame, rects):
    ops = _flagship(T, torch.from_numpy(frame), rects)
    with pytest.raises(ValueError, match="CUDA"):
        T.execute_operations(*ops, backend=T.ParBackend.CUDA, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        T.describe_backend(*ops, backend=T.ParBackend.CUDA, device="cpu")


def test_cuda_device_without_gpu_raises(frame, rects, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.execute_operations(*_flagship(T, frame, rects), device="cuda")


def _entry_points(frame, rects, tmp_path):
    """Every entry point that resolves a device, on host arrays only."""
    seq = T.build_operation_sequence(T.image(np.stack([frame, frame])), T.multiply(2.0))
    saved = T.CircularTensor(8, 4, 3, 2, device="cpu")
    saved.save(str(tmp_path / "ring"))
    return {
        "execute_operations": lambda **kw: T.execute_operations(*_flagship(T, frame, rects), **kw),
        "describe_backend": lambda **kw: T.describe_backend(*_flagship(T, frame, rects), **kw),
        "launch_divergent_batch": lambda **kw: T.launch_divergent_batch([1, 1], seq, **kw),
        "CircularTensor": lambda **kw: T.CircularTensor(8, 4, 3, 2, **kw),
        "CircularTensor.load": lambda **kw: T.CircularTensor.load(str(tmp_path / "ring"), **kw),
    }


@pytest.mark.parametrize("entry", ["execute_operations", "describe_backend",
                                   "launch_divergent_batch", "CircularTensor",
                                   "CircularTensor.load"])
def test_default_device_is_the_card_and_cpu_must_be_asked_for(entry, frame, rects, tmp_path,
                                                              monkeypatch):
    """With host arrays only and no ``device``, an entry point takes the
    current CUDA device and raises where there is none; ``device="cpu"``
    runs on the CPU."""
    call = _entry_points(frame, rects, tmp_path)[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = call(device="cpu")
    if isinstance(out, T.CircularTensor):
        assert out.tensor.device.type == "cpu"
    elif isinstance(out, torch.Tensor):
        assert out.device.type == "cpu"
    else:
        assert out == "torch"


def test_a_cpu_tensor_leaf_asks_for_the_cpu(frame, rects, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = T.execute_operations(*_flagship(T, torch.from_numpy(frame), rects))
    assert out.device.type == "cpu" and T.last_backend() == "torch"


def test_supports_refuses_what_the_kernel_cannot_encode(frame, rects):
    ok = T.build_pipeline(*_flagship(T, frame, rects))
    assert kbr.supports(ok)
    assert not kbr.supports(T.build_pipeline(T.image(frame), T.multiply(2.0)))
    int_scalar = T.build_pipeline(
        T.resize_batch(frame, rects=rects, dsize=T.Size(*UP)), Mul(value=np.int32(2)))
    assert not kbr.supports(int_scalar)
    to_int16 = T.build_pipeline(
        T.resize_batch(frame, rects=rects, dsize=T.Size(*UP)), T.convert_to(np.int16))
    assert kbr.supports(to_int16)  # exact in the chain's f32 registers
    to_int32 = T.build_pipeline(
        T.resize_batch(frame, rects=rects, dsize=T.Size(*UP)), T.convert_to(np.int32))
    assert kbr.supports(to_int32)  # held as its bits in the chain's registers
    # a cast to int64 is int32's, as in the reference (whose saturating one
    # raises, as the port's factory does); a cast to uint32 no chain holds
    to_int64 = T.build_pipeline(
        T.resize_batch(frame, rects=rects, dsize=T.Size(*UP)), T.Cast(dst=torch.int64))
    assert kbr.supports(to_int64) and kbr.build_plan(to_int64).out_dtype == torch.int32
    with pytest.raises(OverflowError):
        T.convert_to(np.int64)
    to_uint32 = T.build_pipeline(
        T.resize_batch(frame, rects=rects, dsize=T.Size(*UP)), T.Cast(dst=torch.uint32))
    assert not kbr.supports(to_uint32)
    five_ch = np.zeros((20, 30, 5), np.uint8)
    assert not kbr.supports(T.build_pipeline(
        T.resize_batch(five_ch, rects=rects, dsize=T.Size(*UP))))


def test_mixed_devices_raise(frame, rects):
    ops = _flagship(T, torch.from_numpy(frame), rects)
    with pytest.raises(ValueError, match="cannot run on"):
        T.execute_operations(*ops, device="meta")


def test_shifted_rects_build_no_new_plan(frame, rects):
    executor.clear_cache()
    before = executor.PLAN_BUILDS
    a = T.execute_operations(*_flagship(T, frame, rects), device="cpu")
    assert executor.PLAN_BUILDS == before + 1
    shifted = rects.copy()
    shifted[:, :2] += 7
    b = T.execute_operations(*_flagship(T, frame, shifted, background=(1.0, 2.0, 3.0)),
                             device="cpu")
    assert executor.PLAN_BUILDS == before + 1
    assert not torch.equal(a, b)
    # a new structure (another write layout) does build a plan
    T.execute_operations(*_flagship(T, frame, shifted)[:-1], T.split_tensor_transposed(),
                         device="cpu")
    assert executor.PLAN_BUILDS == before + 2


def test_structure_key_ignores_values_only(frame, rects):
    k1, leaves = flatten(T.build_pipeline(*_flagship(T, frame, rects)))
    k2, _ = flatten(T.build_pipeline(*_flagship(T, frame + 1, rects + 4)))
    k3, _ = flatten(T.build_pipeline(*_flagship(T, frame, rects[:3])))
    assert k1 == k2 and k1 != k3
    assert any(isinstance(v, np.ndarray) and v.shape == (5, 4) for v in leaves)


def test_from_jax_round_trip(frame, rects):
    jp = J.build_pipeline(*_flagship(J, frame, rects, used_planes=3, background=5.0))
    tp = from_jax(jp)
    assert type(tp).__name__ == "Pipeline" and type(tp.read).__name__ == "BatchResizeRead"
    assert tp.read.dsize == T.Size(*UP) and tp.read.aspect_ratio is T.AspectRatio.IGNORE_AR
    assert isinstance(tp.read.frame, np.ndarray) and tp.read.packed_channels == 3
    assert [type(o).__name__ for o in tp.compute] == [type(o).__name__ for o in jp.compute]
    assert tp.compute[0].dst == torch.float32
    np.testing.assert_array_equal(tp.read.rects, rects)
    out = T.execute_operations(tp.read, *tp.compute, tp.write, device="cpu")
    ref = np.asarray(J.execute_operations(*_flagship(J, frame, rects, used_planes=3, background=5.0),
                                          backend=J.ParBackend.XLA))
    assert np.abs(out.numpy() - ref).max() <= 1e-5


@dataclasses.dataclass(frozen=True)
class _Unported:
    """An op class with no counterpart in the port."""

    source: object


def test_from_jax_refuses_unported_ops(frame):
    with pytest.raises(TypeError, match="no counterpart"):
        from_jax(_Unported(source=J.image(frame)))
    with pytest.raises(TypeError, match="no counterpart"):
        from_jax((J.image(frame), _Unported(source=0)))
