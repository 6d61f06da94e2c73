"""int64 and float64 sources on the card: every kernel reads a 64-bit CUDA
tensor at load as its canonical dtype (int64 as its low 32 bits, float64
rounded to float32), in one launch, with no conversion launched before it.
Each must equal its plain version bit for bit, and the kernel on the same
tensor after ``.int()`` or ``.float()``. What ``chip_smoke.py`` phases 3
and 4 check at full sizes. Needs a CUDA device and skips without one. On a
machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_x64.py
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

pytestmark = pytest.mark.gpu

CANONICAL = {torch.int64: torch.int32, torch.float64: torch.float32}
PLAIN = {kbr: kbr.batch_resize_reference, kfr: kfr.frame_resize_reference,
         kw: kw.warp_reference, kp: kp.pointwise_reference, kd: kd.divergent_reference}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def values64(shape, dtype, seed, edges=False):
    """int64: low 32 bits over int32's range (past 2^24, near its bounds,
    small), high bits that vary, so that only the low 32 bits give the
    canonical value. float64: values of a few hundred that float32 rounds,
    and with ``edges`` values past float32's range and below its smallest
    normal (only a copy holds them unchanged)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if dtype == torch.int64:
        lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        kinds = rng.integers(0, 4, n)
        low = np.where(kinds == 0, rng.integers(lo, lo + 200, n),
                       np.where(kinds == 1, rng.integers(hi - 200, hi, n),
                                np.where(kinds == 2, rng.integers(2 ** 24, 2 ** 30, n),
                                         rng.integers(-300, 300, n))))
        v = low.astype(np.int64) + rng.integers(-4, 5, n).astype(np.int64) * 2 ** 32
    else:
        v = rng.uniform(-300.0, 300.0, n)
        if edges:
            table = np.array([1e39, -1e39, 1e-40, -1e-42, 1e-46, 3.4028235e38, 2.0 ** -149])
            pick = rng.integers(0, 4 * len(table), n)
            v = np.where(pick < len(table), table[np.minimum(pick, len(table) - 1)], v)
    return torch.from_numpy(v.reshape(shape)).to(dtype)


def _bits_same(got, want):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[g.element_size()]
        assert torch.equal(g.view(bits), w.view(bits)), \
            f"{int((g.view(bits) != w.view(bits)).sum())} values differ"


def _launch_once(module, a):
    launches = module.LAUNCHES
    got = module.launch(a)
    assert module.LAUNCHES == launches + 1
    return got


HEADS = {
    "resize_batch": (kbr, lambda a: T.resize_batch(
        a((60, 90, 3)), rects=np.array([[1, 2, 40, 30], [19, 5, 33, 47], [-3, 4, 22, 20]],
                                       np.int32), dsize=T.Size(24, 20))),
    "resize": (kfr, lambda a: T.resize(T.image(a((61, 94, 3))), T.Size(37, 29))),
    "warp_separable": (kw, lambda a: T.warp(
        T.image(a((50, 70, 3))), np.array([[0.7, 0.0, 1.5], [0.0, 0.8, 0.5]]), T.Size(45, 33),
        default=(3.0, 2.0, 1.0))),
    "warp_perspective": (kw, lambda a: T.warp(
        T.image(a((50, 70, 3))), np.array([[0.9, 0.02, 1.0], [0.03, 0.95, 2.0],
                                           [1e-3, 2e-3, 1.0]]), T.Size(45, 33),
        warp_type=T.WarpType.PERSPECTIVE)),
    "warp_batch": (kw, lambda a: T.warp_batch(
        [a((40, 60, 3))] * 3, [np.array([[0.7, 0.1, 1.5], [-0.1, 0.8, 0.5]])] * 3,
        T.Size(30, 20))),
    "pointwise_image": (kp, lambda a: T.image(a((29, 43, 3)))),
    "pointwise_ring": (kp, lambda a: T.circular_batch_read(a((4, 16, 24, 3)), first=-3)),
    "pointwise_crop": (kp, lambda a: T.crop(T.image(a((32, 47, 3))), T.Rect(-4, 3, 29, 17))),
    # border values past int32's range: cast to the canonical dtype as
    # utils.dtypes.cast casts (truncate, saturate)
    "pointwise_border": (kp, lambda a: T.make_border(
        T.image(a((18, 21, 3))), 2, 1, 3, 2, T.BorderMode.CONSTANT, value=(7.0, 3e9, -40000.5))),
    # one channel over 720,896 outputs: the one-lane instance of 16 pixels
    # a thread, whose group is read as one run
    "pointwise_one_channel": (kp, lambda a: T.image(a((512, 1536, 1)))),
}
COPIES = ("pointwise_image", "pointwise_ring", "pointwise_crop", "pointwise_border",
          "pointwise_one_channel")


@pytest.mark.parametrize("chain", ["copy", "ops"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64], ids=["i64", "f64"])
@pytest.mark.parametrize("head", list(HEADS))
def test_every_kernel_reads_a_64bit_source_at_load(head, dtype, chain, cuda):
    """One launch of the head's kernel on a 64-bit CUDA tensor, bit for bit
    its plain version and the kernel on the tensor's canonical twin: a copy
    keeps every low 32 bits of int64 and float32's rounding of float64
    (infinities and subnormals among them); an op runs on the canonical
    value."""
    if chain == "copy" and head not in COPIES:
        ops = (T.split_tensor(),)
    else:
        ops = ((T.multiply(0.37), T.add(-1.5)) if chain == "ops" else ()) + (T.write(),)
        if head in ("resize_batch", "warp_batch", "pointwise_ring"):
            ops = ops[:-1] + (T.split_tensor(),)
    module, read = HEADS[head]
    src = {}

    def make(shape):
        src["t"] = values64(shape, dtype, 5, edges=chain == "copy" and head in COPIES).to(cuda)
        return src["t"]

    pipeline = T.build_pipeline(read(make), *ops)
    plan = module.build_plan(pipeline)
    assert plan.src_dtype == dtype
    a = module.prepare(pipeline, plan, cuda)
    got = _launch_once(module, a)
    _bits_same(got, PLAIN[module](a))
    twin = T.build_pipeline(read(lambda shape: src["t"].to(CANONICAL[dtype])), *ops)
    _bits_same(got, module.launch(module.prepare(twin, module.build_plan(twin), cuda)))


@pytest.mark.parametrize("kind", ["ring", "crop_and_image", "warp"])
def test_divergent_reads_a_float64_source_at_load(kind, cuda):
    """K6 reads a float64 group's source at load as float32: one launch, bit
    for bit its plain version and K6 on the float32 twin."""
    seq = T.build_operation_sequence

    def batch(conv):
        ring = conv(values64((6, 17, 26, 3), torch.float64, 6).to(cuda))
        frame = conv(values64((40, 50, 3), torch.float64, 7).to(cuda))
        rects = np.array([[2 * z, 3 * z, 20, 14] for z in range(6)], np.int32)
        m = np.array([[0.7, 0.1, 1.5], [-0.1, 0.8, 0.5]])
        if kind == "ring":
            return [1, 2] * 3, (
                seq(T.circular_batch_read(ring, first=2), T.multiply(0.3), T.write_tensor()),
                seq(T.circular_batch_read(ring, first=-1, ascendent=False), T.convert_to(
                    np.uint8, alpha=0.5), T.convert_to(np.float32), T.write_tensor()))
        if kind == "crop_and_image":
            return [1, 1, 2, 1, 2, 1], (
                seq(T.resize_batch(frame, rects=rects, dsize=T.Size(26, 17)), T.subtract(0.5),
                    T.split_tensor()),
                seq(T.image(ring), T.multiply(2.0), T.split_tensor()))
        return [1, 2, 1, 2, 1, 2], (
            seq(T.warp_batch([frame] * 6, [m] * 6, T.Size(26, 17)), T.multiply(0.5),
                T.write_tensor()),
            seq(T.resize_batch(frame, rects=rects, dsize=T.Size(26, 17)), T.write_tensor()))

    ids, seqs = batch(lambda t: t)
    plan = kd.build_plan(seqs, ids)
    assert torch.float64 in {g.src_dtype for g in plan.groups}
    a = kd.prepare(seqs, plan, cuda)
    got = _launch_once(kd, a)
    assert got.dtype == torch.float32
    _bits_same(got, kd.divergent_reference(a))
    ids, twins = batch(lambda t: t.float())
    _bits_same(got, kd.divergent(kd.prepare(twins, kd.build_plan(twins, ids), cuda)))


@pytest.mark.parametrize("what", ["int64_tensor", "float64_tensor", "float64_host",
                                  "int64_host"])
def test_64bit_frames_through_the_entry_points_are_one_launch(what, cuda):
    """``execute_operations`` of a 64-bit frame, a tensor on the card (read at
    load) or a host array (converted before its copy): one launch of the
    kernel, no plan on the second call, the canonical dtype's result, equal
    to the eager version bit for bit."""
    from cvgpuspeedup_tpu_torch.exec import executor

    dtype = torch.int64 if what.startswith("int64") else torch.float64
    frames = [values64((72, 128, 3), dtype, 8 + k) for k in range(2)]
    if what.endswith("tensor"):
        frames = [f.to(cuda) for f in frames]
    else:
        frames = [f.numpy() for f in frames]

    def ops(f):
        return (T.crop(T.image(f), T.Rect(-40, 4, 64, 48)), T.multiply(0.5), T.split_tensor())

    T.execute_operations(*ops(frames[0]), device=cuda)
    launches, builds = kp.LAUNCHES, executor.PLAN_BUILDS
    got = T.execute_operations(*ops(frames[1]), device=cuda)
    assert T.last_backend() == "cuda:pointwise"
    assert kp.LAUNCHES == launches + 1 and executor.PLAN_BUILDS == builds
    assert got.dtype == CANONICAL[dtype]
    _bits_same(got, T.execute_operations(*ops(frames[1]), device=cuda,
                                         backend=T.ParBackend.TORCH))


def test_a_float64_ring_is_float32_and_updates_in_one_launch(cuda):
    """``CircularTensor(dtype=np.float64)`` holds float32, as the reference's
    ``jnp.zeros`` gives it; an update with a float64 frame on the card is one
    launch into the slot."""
    ring = T.CircularTensor(24, 16, 3, 4, dtype=np.float64, device=cuda)
    assert ring.tensor.dtype == torch.float32
    frame = values64((40, 60, 3), torch.float64, 9).to(cuda)
    ring.update(T.crop(T.image(frame), T.Rect(5, 7, 24, 16)))
    launches = kp.LAUNCHES
    ring.update(T.crop(T.image(frame), T.Rect(6, 7, 24, 16)))
    torch.cuda.synchronize()
    assert kp.LAUNCHES == launches + 1 and T.last_backend() == "cuda:pointwise"
    want = frame[7:23, 6:30].float().permute(2, 0, 1)
    _bits_same(ring.tensor[0], want.contiguous())
