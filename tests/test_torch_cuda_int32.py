"""int32 in every kernel, on the card: each kernel against its plain version
with an int32 source, an int32 chain, int32 stores and int32 rings, bit for
bit. The kernels hold an int32 value as its 32 bits, so values past 2^24
(which float32 does not hold) and within 200 of int32's bounds (where an op
saturates) must come through exact. What ``chip_smoke.py`` phases 3 and 4
check at full sizes. Needs a CUDA device and skips without one. On a machine
with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_int32.py
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import executor
from test_torch_cuda_dtypes import HEADS, STORE_KERNELS, _plain, _same

pytestmark = pytest.mark.gpu

INTS = (torch.uint8, torch.int8, torch.uint16, torch.int16, torch.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def int32_values(shape, seed):
    """int32 values of three kinds in equal shares: within 200 of -2^31 and
    of 2^31 - 1, past 2^24, and small."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    kinds = rng.integers(0, 4, n)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    v = np.where(kinds == 0, rng.integers(lo, lo + 200, n),
                 np.where(kinds == 1, rng.integers(hi - 200, hi, n),
                          np.where(kinds == 2, rng.integers(2 ** 24, 2 ** 30, n) *
                                   rng.choice([-1, 1], n), rng.integers(-300, 300, n))))
    return v.astype(np.int32).reshape(shape)


def _source(cuda, seed=1):
    return lambda shape: torch.from_numpy(int32_values(shape, seed)).to(cuda)


def _launch_once(module, a, **kw_):
    launches = module.LAUNCHES
    got = module.launch(a, **kw_)
    assert module.LAUNCHES == launches + 1
    return got


CHAINS = {
    # an int32 source read into float32 (a resampling head) or as its bits
    "to_f32": (T.convert_to(np.float32, alpha=1 / 1024.0), T.subtract(0.5)),
    # an op on int32: to float32, the op, the saturate back
    "i32_ops": (T.convert_to(np.int32), T.multiply(3.0), T.add(-7.0)),
    "wrap_u8": (T.convert_to(np.int32), T.Cast(dst=torch.uint8)),
    "sat_i16": (T.convert_to(np.int32), T.convert_to(np.int16)),
    "to_f16": (T.convert_to(np.int32), T.convert_to(np.float16)),
    "gray_alpha": (T.convert_to(np.int32), T.cvt_color(T.ColorConversionCode.COLOR_RGB2GRAY)),
    "bgra": (T.convert_to(np.int32), T.cvt_color(T.ColorConversionCode.COLOR_BGR2BGRA),
             T.vector_reorder(3, 2, 1, 0)),
}


@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("head", list(HEADS))
def test_every_head_of_an_int32_source_against_the_plain_version(head, chain, cuda):
    """Each kernel reads an int32 source (the resampling kernels into
    float32, the pointwise kernel as its bits) and runs a chain through
    int32, in one launch, bit for bit its plain version."""
    module, read = HEADS[head]
    pipeline = T.build_pipeline(read(_source(cuda, 3)), *CHAINS[chain], T.split_tensor())
    a = module.prepare(pipeline, module.build_plan(pipeline), cuda)
    assert a.plan.src_dtype == torch.int32
    _same(_launch_once(module, a), _plain(module, a))


@pytest.mark.parametrize("head", ["pointwise_image", "pointwise_ring", "pointwise_crop",
                                  "pointwise_border"])
def test_int32_copies_are_exact_at_every_value(head, cuda):
    """A copy, a ring read, a crop and a CONSTANT border of int32 (its value
    past int32's range saturates) move the bits: the output equals the
    source's values, above 2^24 too."""
    module, read = HEADS[head]
    pipeline = T.build_pipeline(read(_source(cuda, 4)), T.write_tensor()
                                if head == "pointwise_ring" else T.write())
    a = module.prepare(pipeline, module.build_plan(pipeline), cuda)
    got = _launch_once(module, a)
    _same(got, _plain(module, a))
    assert got.dtype == torch.int32 and int(got.abs().max()) > 2 ** 24


@pytest.mark.parametrize("kernel", list(STORE_KERNELS))
def test_a_uint8_head_through_int32_into_every_out_dtype(kernel, cuda):
    """A uint8 frame converted to int32, scaled past 2^24 and past int32's
    range (saturating), stored into an ``out=`` view of every dtype: int32
    as its bits, float32 and float16 converted, the narrower integers
    wrapped, one launch each."""
    module, read = STORE_KERNELS[kernel]
    img = torch.from_numpy(np.random.default_rng(70).integers(0, 256, (96, 128, 3))
                           .astype(np.uint8)).to(cuda)
    pipeline = T.build_pipeline(read(img), T.convert_to(np.int32, alpha=3e7), T.add(-2e9),
                                T.split_tensor())
    a = module.prepare(pipeline, module.build_plan(pipeline), cuda)
    want = _plain(module, a)
    assert want.dtype == torch.int32
    _same(_launch_once(module, a), want)
    for dtype in (*INTS, torch.float16, torch.float32):
        view = torch.full((2,) + tuple(want.shape), 77, dtype=dtype, device=cuda)[1]
        assert _launch_once(module, a, out=view) is view
        _same(view, T._dt.astype(want, dtype))


def test_divergent_groups_of_int32(cuda):
    """K6: an int32 chain on a uint8 ring, a float32 group and an int16
    group stored into the int32 batch (truncated and saturated, exact),
    then an int32 group stored into a float32 batch (converted)."""
    rng = np.random.default_rng(72)
    ring = torch.from_numpy(rng.integers(0, 256, (6, 17, 26, 3)).astype(np.uint8)).to(cuda)
    ringf = torch.from_numpy(rng.normal(0, 3e9, (6, 17, 26, 3)).astype(np.float32)).to(cuda)
    seq = T.build_operation_sequence
    i32 = seq(T.circular_batch_read(ring, first=2), T.convert_to(np.int32, alpha=1e7),
              T.multiply(0.75), T.add(-1e9), T.write_tensor())
    f32 = seq(T.circular_batch_read(ringf, first=-1, ascendent=False), T.multiply(1.5),
              T.write_tensor())
    i16 = seq(T.image(ring), T.convert_to(np.int16, alpha=300.0), T.write_tensor())
    for seqs, ids, dtype in (((i32, f32, i16), [1, 2, 3, 1, 3, 2], torch.int32),
                             ((f32, i32), [1, 2, 2, 1, 2, 1], torch.float32)):
        a = kd.prepare(seqs, kd.build_plan(seqs, ids), cuda)
        got = _launch_once(kd, a)
        assert got.dtype == dtype
        _same(got, kd.divergent_reference(a))


def test_int32_ring_update_is_one_launch_with_no_temporary(cuda):
    """``CircularTensor.update`` of int32 frames into an int32 ring through
    a crop (the pointwise kernel) and of a resize into it (the frame
    kernel): one launch each, no plan after the first update, every plane
    equal to a ring updated on the CPU."""
    frames = [torch.from_numpy(int32_values((160, 96, 3), 80 + k)).to(cuda) for k in range(6)]
    for head, module in (("plain", kp), ("resize", kfr)):
        def ops(k, dev):
            img = frames[k].to(dev)
            if head == "resize":
                return (T.resize(T.image(img), T.Size(64, 128)), T.convert_to(np.int32))
            return (T.crop(T.image(img), T.Rect(3 * k, 2 * k, 64, 128)),)

        rt = T.CircularTensor(64, 128, 3, 4, dtype=np.int32, device=cuda)
        twin = T.CircularTensor(64, 128, 3, 4, dtype=np.int32, device="cpu")
        rt.update(*ops(0, cuda))
        twin.update(*ops(0, "cpu"))
        torch.cuda.synchronize()
        launches, builds = module.LAUNCHES, executor.PLAN_BUILDS
        for k in range(1, 6):
            rt.update(*ops(k, cuda))
            twin.update(*ops(k, "cpu"))
        assert module.LAUNCHES == launches + 5 and executor.PLAN_BUILDS == builds
        _same(rt.tensor, twin.tensor.to(cuda))


def test_the_executor_runs_int32_in_one_launch_and_debug_mode_keeps_the_numbers(cuda):
    """``execute_operations`` picks a kernel for each int32 pipeline and
    ``ParBackend.CUDA`` takes it; under ``debug_mode`` each wrapper waits for
    its launch, with the same output."""
    img = _source(cuda, 5)((60, 90, 3))
    rects = np.array([[1, 2, 40, 30], [19, 5, 33, 47]], np.int32)
    for ops, name in (
            ((T.resize_batch(img, rects=rects, dsize=T.Size(24, 20)),
              T.convert_to(np.float32, alpha=0.5), T.split_tensor()), "cuda:batch_resize"),
            ((T.resize(T.image(img), T.Size(37, 29)), T.convert_to(np.int32), T.multiply(3.0),
              T.split()), "cuda:frame_resize"),
            ((T.warp(T.image(img), np.array([[0.5, 0.0, 3.0], [0.0, 0.5, 2.0]]), T.Size(32, 24)),
              T.convert_to(np.int32), T.split_tensor()), "cuda:warp"),
            ((T.image(img), T.multiply(2.0), T.write()), "cuda:pointwise")):
        assert T.describe_backend(*ops) == name
        got = T.execute_operations(*ops, backend=T.ParBackend.CUDA)
        with executor.debug_mode():
            again = T.execute_operations(*ops)
        assert T.last_backend() == name
        _same(again, got)
        _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))
