"""Every dtype a TPU kernel takes, on the card: each kernel against its plain
version for every source dtype it reads (uint8, int8, uint16, int16,
float16, float32; the divergent kernel uint8 and float32), chains through
every dtype, stores into every dtype, and an integer chain into a ring of
another integer dtype as one launch with no temporary. What ``chip_smoke.py``
phases 3 and 4 check at full sizes. Needs a CUDA device and skips without
one. On a machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_dtypes.py

Every output must equal the plain version bit for bit (float32 within 1e-6).
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
from cvgpuspeedup_tpu_torch.exec import executor

pytestmark = pytest.mark.gpu

D = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16, "i16": np.int16, "f16": np.float16,
     "f32": np.float32}
ALPHA = {"u8": 0.5, "i8": 1.5, "u16": 1 / 128.0, "i16": 1 / 96.0, "f16": 0.25, "f32": 0.5}
F32_TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _source(cuda, shape, name, seed=1):
    """Values over the whole range of an integer dtype; float values of a
    few hundred, both signs, exact in float16."""
    rng = np.random.default_rng(seed)
    if name in ("f16", "f32"):
        a = (rng.integers(-400, 2400, shape) / 8.0).astype(D[name])
    else:
        info = np.iinfo(D[name])
        a = rng.integers(info.min, int(info.max) + 1, shape).astype(D[name])
    return torch.from_numpy(a).to(cuda)


def _chain(src, dst):
    return (T.convert_to(D[dst], alpha=ALPHA[src]), T.multiply(0.3), T.subtract(0.51),
            T.divide(0.23))


def _same(got, want):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        if g.dtype == torch.float32:  # an infinity must be the same infinity
            assert float(torch.where(g == w, 0.0, (g - w).abs()).max()) <= F32_TOL
        else:  # every bit, inf and the sign of zero included (CUDA compares no uint16)
            bits = torch.int16 if g.element_size() == 2 else torch.uint8
            gb, wb = g.view(bits), w.view(bits)
            bad = (gb != wb).nonzero()[:4].tolist()
            assert not bad, f"{g.dtype} values differ at {bad}: " + ", ".join(
                f"{float(g[tuple(i)])} ({int(gb[tuple(i)])}) for {float(w[tuple(i)])} "
                f"({int(wb[tuple(i)])})" for i in bad)


HEADS = {
    "resize_batch": (kbr, lambda a: T.resize_batch(
        a((60, 90, 3)), rects=np.array([[1, 2, 40, 30], [19, 5, 33, 47], [-3, 4, 22, 20]],
                                       np.int32), dsize=T.Size(24, 20))),
    "resize": (kfr, lambda a: T.resize(T.image(a((61, 94, 3))), T.Size(37, 29))),
    "warp_separable": (kw, lambda a: T.warp(
        T.image(a((50, 70, 3))), np.array([[0.7, 0.0, 1.5], [0.0, 0.8, 0.5]]), T.Size(45, 33),
        default=(3.0, 2.0, 1.0))),
    "warp_general": (kw, lambda a: T.warp(
        T.image(a((50, 70, 3))), np.array([[0.8, 0.3, 1.0], [-0.3, 0.8, 8.0]]), T.Size(45, 33))),
    "warp_perspective": (kw, lambda a: T.warp(
        T.image(a((50, 70, 3))), np.array([[0.9, 0.02, 1.0], [0.03, 0.95, 2.0],
                                           [1e-3, 2e-3, 1.0]]), T.Size(45, 33),
        warp_type=T.WarpType.PERSPECTIVE)),
    "pointwise_image": (kp, lambda a: T.image(a((29, 43, 3)))),
    "pointwise_ring": (kp, lambda a: T.circular_batch_read(a((4, 16, 24, 3)), first=-3)),
    "pointwise_crop": (kp, lambda a: T.crop(T.image(a((32, 47, 3))), T.Rect(-4, 3, 29, 17))),
    # border values past the integer types' ranges: cast to the source's
    # dtype as utils.dtypes.cast casts (truncate, saturate)
    "pointwise_border": (kp, lambda a: T.make_border(
        T.image(a((18, 21, 3))), 2, 1, 3, 2, T.BorderMode.CONSTANT,
        value=(7.0, 300.5, -40000.0))),
}


@pytest.mark.parametrize("chain", list(D))
@pytest.mark.parametrize("src", list(D))
@pytest.mark.parametrize("head", list(HEADS))
def test_every_head_source_and_chain_dtype_against_the_plain_version(head, src, chain, cuda):
    """Each kernel reads every source dtype, runs its chain in every dtype
    and stores it planar in that dtype, in one launch, bit for bit its plain
    version."""
    module, read = HEADS[head]
    pipeline = T.build_pipeline(read(lambda shape: _source(cuda, shape, src, 3)),
                                *_chain(src, chain), T.split_tensor())
    a = module.prepare(pipeline, module.build_plan(pipeline), cuda)
    launches = module.LAUNCHES
    got = module.launch(a)
    assert module.LAUNCHES == launches + 1
    _same(got, _plain(module, a))


def _plain(module, a):
    return {kbr: kbr.batch_resize_reference, kfr: kfr.frame_resize_reference,
            kw: kw.warp_reference, kp: kp.pointwise_reference}[module](a)


@pytest.mark.parametrize("chain", list(D))
@pytest.mark.parametrize("src", ["u8", "f32"])
def test_divergent_groups_of_every_chain_dtype(src, chain, cuda):
    """K6 reads uint8 and float32 sources; its groups' chains run in every
    dtype, and a group of another dtype stores into the batch as the merge
    casts it (a float group clamps, an integer one wraps or widens)."""
    ring = _source(cuda, (6, 17, 26, 3), src, 4)
    frame = _source(cuda, (40, 50, 3), src, 5)
    rects = np.array([[2 * z, 3 * z, 20, 14] for z in range(6)], np.int32)
    seq = T.build_operation_sequence
    for ids, seqs in (
            ([1, 2] * 3, (seq(T.circular_batch_read(ring, first=2), *_chain(src, chain),
                              T.write_tensor()),
                          seq(T.circular_batch_read(ring, first=-1, ascendent=False),
                              T.convert_to(np.float32, alpha=0.5), T.multiply((2.0, 1.0, 0.5)),
                              T.write_tensor()))),
            ([1, 1, 2, 1, 2, 1], (seq(T.resize_batch(frame, rects=rects, dsize=T.Size(26, 17)),
                                      *_chain(src, chain), T.split_tensor()),
                                  seq(T.image(ring), T.convert_to(np.uint8, alpha=0.7),
                                      T.split_tensor())))):
        a = kd.prepare(seqs, kd.build_plan(seqs, ids), cuda)
        launches = kd.LAUNCHES
        got = kd.divergent(a)
        assert kd.LAUNCHES == launches + 1 and got.dtype == T._dt.to_torch_dtype(D[chain])
        _same(got, kd.divergent_reference(a))


STORE_KERNELS = {
    "batch_resize": (kbr, lambda img: T.resize_batch(
        img, rects=np.array([[i, i, 30, 40] for i in range(4)], np.int32), dsize=T.Size(16, 24))),
    "frame_resize": (kfr, lambda img: T.resize(T.image(img), T.Size(32, 24))),
    "warp": (kw, lambda img: T.warp(T.image(img), np.array([[0.5, 0.0, 3.0], [0.0, 0.5, 2.0]]),
                                    T.Size(32, 24))),
    "pointwise": (kp, lambda img: T.crop(T.image(img), T.Rect(7, 9, 32, 24))),
}


@pytest.mark.parametrize("chain", list(D))
@pytest.mark.parametrize("kernel", list(STORE_KERNELS))
def test_out_of_every_dtype_is_one_store(kernel, chain, cuda):
    """A chain of each dtype into an ``out=`` view of every dtype, of strides
    off the contiguous ones: one launch, equal to the plain version cast by
    ``astype``, and no byte around the view touched. Among them a uint16
    chain into uint8 (a narrowing wrap), uint8 into int16 (widening) and a
    float16 chain into uint8 (clamped, then truncated)."""
    module, read = STORE_KERNELS[kernel]
    img = _source(cuda, (96, 128, 3), "u8", 70)
    pipeline = T.build_pipeline(read(img), T.convert_to(D[chain], alpha=300.0),
                                T.subtract(20000.5), T.split_tensor())
    a = module.prepare(pipeline, module.build_plan(pipeline), cuda)
    want = _plain(module, a)
    for out in D.values():
        dtype = T._dt.to_torch_dtype(out)
        host = torch.full((2,) + tuple(want.shape[:-1]) + (want.shape[-1] + 3,), 77, dtype=dtype,
                          device=cuda)
        view = host[1, ..., 1:-2]
        launches = module.LAUNCHES
        assert module.launch(a, out=view) is view and module.LAUNCHES == launches + 1
        _same(view, T._dt.astype(want, dtype))
        host[1, ..., 1:-2] = 77
        assert bool((host.to(torch.float32) == 77).all())


@pytest.mark.parametrize("kernel", list(STORE_KERNELS))
def test_float_values_past_every_range_and_nan_cast_as_the_reference(kernel, cuda):
    """A float32 chain whose values pass int32's range, reach the infinities
    and NaN, cast by ``Cast`` and ``SaturateCast`` into every integer dtype
    in the chain and stored by ``out=`` into every integer dtype: truncated
    or rounded, saturated, NaN to 0, bit for bit the plain version."""
    module, read = STORE_KERNELS[kernel]
    rng = np.random.default_rng(71)
    edges = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.0 ** 31, 70000.5, -0.5, 254.5],
                     np.float32)
    img = rng.choice(edges, (96, 128, 3)).astype(np.float32)
    img = torch.from_numpy(np.where(rng.random(img.shape) < 0.5, img,
                                    rng.normal(0, 1e9, img.shape)).astype(np.float32)).to(cuda)
    for dst in (torch.uint8, torch.int8, torch.uint16, torch.int16, torch.int32):
        for cast in (T.Cast(dst=dst), T.SaturateCast(dst=dst)):
            pipeline = T.build_pipeline(read(img), T.multiply(1.5), cast, T.split_tensor())
            a = module.prepare(pipeline, module.build_plan(pipeline), cuda)
            _same(module.launch(a), _plain(module, a))
        pipeline = T.build_pipeline(read(img), T.multiply(1.5), T.split_tensor())
        a = module.prepare(pipeline, module.build_plan(pipeline), cuda)
        want = _plain(module, a)
        view = torch.zeros(tuple(want.shape), dtype=dst, device=cuda)
        _same(module.launch(a, out=view), T._dt.astype(want, dst))


@pytest.mark.parametrize("ring", ["u16", "i16", "u8", "i8", "f16"])
@pytest.mark.parametrize("head", ["resize", "plain"])
def test_integer_ring_update_is_one_launch_with_no_temporary(head, ring, cuda):
    """``CircularTensor.update`` of uint8 frames into a ring of another
    dtype: one launch of the head's kernel into the slot, no plan after the
    first update, nothing of a plane's size allocated, every plane equal to a
    ring updated on the CPU."""
    frames = [_source(cuda, (160, 96, 3), "u8", 80 + k) for k in range(6)]
    module = kfr if head == "resize" else kp

    def ops(k, dev):
        img = frames[k].to(dev)
        if head == "resize":
            return (T.resize(T.image(img), T.Size(64, 128)), T.convert_to(np.uint8))
        return (T.crop(T.image(img), T.Rect(3 * k, 2 * k, 64, 128)),)

    rt = T.CircularTensor(64, 128, 3, 4, dtype=D[ring], device=cuda)
    twin = T.CircularTensor(64, 128, 3, 4, dtype=D[ring], device="cpu")
    rt.update(*ops(0, cuda))
    twin.update(*ops(0, "cpu"))
    torch.cuda.synchronize()
    launches, builds = module.LAUNCHES, executor.PLAN_BUILDS
    allocated0 = torch.cuda.memory_stats(cuda)["allocated_bytes.all.allocated"]
    for k in range(1, 6):
        rt.update(*ops(k, cuda))
        twin.update(*ops(k, "cpu"))
    torch.cuda.synchronize()
    grown = torch.cuda.memory_stats(cuda)["allocated_bytes.all.allocated"] - allocated0
    assert module.LAUNCHES == launches + 5 and executor.PLAN_BUILDS == builds
    assert grown < 64 * 128 * 3, grown  # the updates' parameter blocks, no uint8 plane
    _same(rt.tensor, twin.tensor.to(cuda))
