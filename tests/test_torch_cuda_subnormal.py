"""Subnormal float32 values on the card: the five kernels, compiled with
``-ftz=true``, flush a subnormal float32 operand or result of every
arithmetic op, compare and min/max to a zero of its sign, as their plain
versions do (``utils.dtypes.flush_subnormal``), and keep a subnormal that is
only copied, a float64 value rounded to float32 at load among them. Each
kernel runs once on a float32 source whose values come from an edge table,
with a chain that holds a subnormal scalar, and must equal its plain version
on the card bit for bit as int32 (-0 and +0 differ). What ``chip_smoke.py``'s
subnormal phase checks at full sizes. Needs a CUDA device and skips without
one. On a machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_subnormal.py
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

PLAIN = {kbr: kbr.batch_resize_reference, kfr: kfr.frame_resize_reference,
         kw: kw.warp_reference, kp: kp.pointwise_reference}
TINY = 2.0 ** -126
#: subnormals, and values whose products with a chain's scalars underflow
EDGES32 = np.array([1e-40, -2e-39, -5e-40, 1e-38, 2.0 ** -149, -1e-38, 1e-30, -3e-31],
                   np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def edges(shape, seed, device, share=2):
    """float32 values: one in ``share`` from :data:`EDGES32`, the others
    normal values within 300."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-300.0, 300.0, shape).astype(np.float32)
    pick = rng.integers(0, share * len(EDGES32), shape)
    v = np.where(pick < len(EDGES32), EDGES32[np.minimum(pick, len(EDGES32) - 1)], v)
    return torch.from_numpy(v).to(device)


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _bits_same(got, want):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        assert torch.equal(_bits(g), _bits(w)), f"{int((_bits(g) != _bits(w)).sum())} values differ"


def _flushed(out):
    """The count of zeros, and that no value is subnormal."""
    out = torch.cat([o.reshape(-1) for o in (out if isinstance(out, tuple) else (out,))])
    sub = (out != 0) & (out.abs() < TINY)
    return int((out == 0).sum()), int(sub.sum())


#: a chain with a subnormal scalar and a product that underflows
CHAIN = (T.multiply(1.0), T.subtract((1e-40, 0.0, -2e-39)), T.multiply(1e-9))
HEADS = {
    "resize_batch": (kbr, lambda a: T.resize_batch(
        a((60, 90, 3)), rects=np.array([[1, 2, 40, 30], [19, 5, 33, 47], [-3, 4, 22, 20]],
                                       np.int32), dsize=T.Size(24, 20))),
    "resize": (kfr, lambda a: T.resize(T.image(a((61, 94, 3))), T.Size(37, 29))),
    "resize_keep_edge": (kfr, lambda a: T.resize(T.image(a((60, 94, 3))), T.Size(47, 30))),
    "warp_separable": (kw, lambda a: T.warp(
        T.image(a((50, 70, 3))), np.array([[0.7, 0.0, 1.5], [0.0, 0.8, 0.5]]), T.Size(45, 33),
        default=(1e-40, -2e-39, 1.0))),
    "warp_general": (kw, lambda a: T.warp(
        T.image(a((50, 70, 3))), np.array([[0.9, 0.3, -4.0], [-0.3, 0.9, 9.0]]), T.Size(45, 33))),
    "warp_perspective": (kw, lambda a: T.warp(
        T.image(a((50, 70, 3))), np.array([[0.9, 0.02, 1.0], [0.03, 0.95, 2.0],
                                           [1e-3, 2e-3, 1.0]]), T.Size(45, 33),
        warp_type=T.WarpType.PERSPECTIVE)),
    "warp_batch": (kw, lambda a: T.warp_batch(
        [a((40, 60, 3))] * 3, [np.array([[0.7, 0.1, 1.5], [-0.1, 0.8, 0.5]])] * 3,
        T.Size(30, 20))),
    "pointwise_image": (kp, lambda a: T.image(a((29, 43, 3)))),
    "pointwise_ring": (kp, lambda a: T.circular_batch_read(a((4, 16, 24, 3)), first=-3)),
    "pointwise_crop_border": (kp, lambda a: T.make_border(
        T.crop(T.image(a((32, 47, 3))), T.Rect(-4, 3, 29, 17)), 2, 1, 3, 2,
        T.BorderMode.CONSTANT, value=(1e-40, -2e-39, 7.0))),
    # one channel over 720,896 outputs: the one-lane instance of 16 pixels
    "pointwise_one_channel": (kp, lambda a: T.image(a((512, 1536, 1)))),
}
BATCHED = ("resize_batch", "warp_batch", "pointwise_ring")


def _launch_once(module, a):
    launches = module.LAUNCHES
    got = module.launch(a)
    assert module.LAUNCHES == launches + 1
    return got


@pytest.mark.parametrize("head,chain", [(h, c) for c in ("flush", "gray") for h in HEADS
                                        if not (c == "gray" and h == "pointwise_one_channel")])
def test_every_kernel_flushes_as_its_plain_version(head, chain, cuda):
    """One launch of the head's kernel, bit for bit its plain version on the
    card, no subnormal left, and zeros among its outputs where the chain
    flushes."""
    module, read = HEADS[head]
    ops = CHAIN if chain == "flush" else (T.cvt_color(T.ColorConversionCode.COLOR_RGB2GRAY),)
    if head == "pointwise_one_channel":
        ops = CHAIN[:1] + (T.subtract(1e-40), T.multiply(1e-9))
    write = T.split_tensor() if head in BATCHED else T.write()
    pipeline = T.build_pipeline(read(lambda shape: edges(shape, 3, cuda)), *ops, write)
    plan = module.build_plan(pipeline)
    a = module.prepare(pipeline, plan, cuda)
    got = _launch_once(module, a)
    _bits_same(got, PLAIN[module](a))
    zeros, subnormal = _flushed(got)
    assert subnormal == 0 and (zeros > 0 or chain == "gray")


def test_a_copy_keeps_subnormals_in_the_kernels(cuda):
    """A float32 image copied by the pointwise kernel, a 3:1 downscale whose
    every weight is 0 (K2 selects the tap) and a CONSTANT border of a
    subnormal value keep every subnormal, bit for bit the source."""
    src = edges((27, 36, 3), 4, cuda)
    for module, pipe, want in (
        (kp, T.build_pipeline(T.image(src), T.write()), src),
        (kfr, T.build_pipeline(T.resize(T.image(src), T.Size(12, 9)), T.write()),
         src[1::3, 1::3]),
        (kp, T.build_pipeline(T.make_border(T.image(src[:1, :1]), 0, 0, 1, 0,
                                            T.BorderMode.CONSTANT, value=(1e-40, -2e-39, 1e-38)),
                              T.write()),
         torch.cat([torch.tensor([[[1e-40, -2e-39, 1e-38]]], device=cuda), src[:1, :1]], 1)),
    ):
        got = _launch_once(module, module.prepare(pipe, module.build_plan(pipe), cuda))
        _bits_same(got, want.contiguous())


@pytest.mark.parametrize("head", ["pointwise", "resize_copies", "divergent_ring"])
def test_a_float64_copy_keeps_1e_40_and_minus_1e_42(head, cuda):
    """A float64 source rounds to float32 at load without a flush (the
    conversion is ``cvt.rn.f32.f64``, not its ``.ftz`` form): 1e-40 and
    -1e-42 stay, bit for bit numpy's ``astype(np.float32)``."""
    rng = np.random.default_rng(5)
    v = rng.uniform(-3, 3, (4, 9, 12, 3))
    v.reshape(-1)[::3] = 1e-40
    v.reshape(-1)[1::3] = -1e-42
    want = torch.from_numpy(v.astype(np.float32)).to(cuda)
    src = torch.from_numpy(v).to(cuda)
    if head == "pointwise":
        pipe, module, ref = T.build_pipeline(T.image(src[0]), T.write()), kp, want[0]
    elif head == "resize_copies":
        pipe = T.build_pipeline(T.resize(T.image(src[0]), T.Size(4, 3)), T.write())
        module, ref = kfr, want[0, 1::3, 1::3]
    else:
        seqs = (T.build_operation_sequence(T.circular_batch_read(src, first=1), T.write_tensor()),
                T.build_operation_sequence(T.image(src), T.write_tensor()))
        ids = [1, 2, 1, 2]
        a = kd.prepare(seqs, kd.build_plan(seqs, ids), cuda)
        got = _launch_once(kd, a)
        _bits_same(got, kd.divergent_reference(a))
        _bits_same(got, torch.stack([want[1], want[1], want[3], want[3]]))
        return
    got = _launch_once(module, module.prepare(pipe, module.build_plan(pipe), cuda))
    _bits_same(got, ref.contiguous())
    assert int(((got != 0) & (got.abs() < TINY)).sum()) > 0


def test_divergent_batch_of_d1s_kinds_flushes_as_its_plain_version(cuda):
    """K6 on a float32 ring read by two sequences (``chip_smoke.py``'s D1
    kinds) with chains that flush, and a warp group: one launch, bit for bit
    its plain version."""
    seq = T.build_operation_sequence
    ring = edges((6, 17, 26, 3), 6, cuda)
    frame = edges((40, 50, 3), 7, cuda)
    m = np.array([[0.7, 0.1, 1.5], [-0.1, 0.8, 0.5]])
    for ids, seqs in (
        ([1, 2] * 3, (seq(T.circular_batch_read(ring, first=2), T.convert_to(np.float32, 0.3),
                          T.subtract((1e-40, 0.0, 0.0)), T.write_tensor()),
                      seq(T.circular_batch_read(ring, first=2), T.convert_to(np.float32, 0.5),
                          T.multiply((2.0, 1.0, 1e-9)), T.write_tensor()))),
        ([1, 2] * 3, (seq(T.warp_batch([frame] * 6, [m] * 6, T.Size(26, 17)), T.multiply(1e-9),
                          T.write_tensor()),
                      seq(T.resize_batch(frame, rects=np.array(
                          [[2 * z, 3 * z, 20, 14] for z in range(6)], np.int32),
                          dsize=T.Size(26, 17)), T.multiply(1.0), T.write_tensor()))),
    ):
        a = kd.prepare(seqs, kd.build_plan(seqs, ids), cuda)
        got = _launch_once(kd, a)
        _bits_same(got, kd.divergent_reference(a))
        zeros, subnormal = _flushed(got)
        assert zeros > 0 and subnormal == 0


#: forward maps whose inverse holds -1e-39 at c01, then at c10 (the
#: factories invert on the host)
SUBNORMAL_MAPS = {"c01": ((1, 1e-39, 0), (0, 1, 0)), "c10": ((1, 0, 0), (1e-39, 1, 0))}


@pytest.mark.parametrize("name", list(SUBNORMAL_MAPS))
def test_a_warp_map_with_a_subnormal_coefficient(name, cuda):
    """The warp kernel, the composed kernel's warp core and the divergent
    kernel's warp groups on a map whose inverse holds a subnormal
    coefficient, with an infinite border channel: one launch each, bit for
    bit its plain version, which takes the host's terms (-1e-39 * Y kept:
    column or row 0 reads the border with weight 0, NaN in that channel)."""
    from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc

    src = torch.from_numpy(np.random.default_rng(9).uniform(
        -3, 3, (1024, 40, 3)).astype(np.float32)).to(cuda)
    m, border, size = np.array(SUBNORMAL_MAPS[name]), (np.inf, -2.0, 5.0), T.Size(40, 1024)
    p = T.build_pipeline(T.warp(T.image(src), m, size, default=border), T.write())
    a = kw.prepare(p, kw.build_plan(p), cuda)
    want = kw.warp_reference(a)
    _bits_same(_launch_once(kw, a), want)
    assert bool(torch.isnan(want).any())
    p = T.build_pipeline(T.warp(T.crop(T.image(src), T.Rect(0, 0, 40, 1024)), m, size,
                                default=border), T.write())
    a = kc.prepare(p, kc.build_plan(p), cuda)
    _bits_same(_launch_once(kc, a), kc.composed_reference(a))
    seq = T.build_operation_sequence
    other = np.array(SUBNORMAL_MAPS["c10" if name == "c01" else "c01"])
    seqs = (seq(T.warp_batch([src] * 4, [m] * 4, size, border_value=border), T.write_tensor()),
            seq(T.warp_batch([src] * 4, [other] * 4, size, border_value=border),
                T.write_tensor()))
    ids = [1, 2, 1, 2]
    a = kd.prepare(seqs, kd.build_plan(seqs, ids), cuda)
    _bits_same(_launch_once(kd, a), kd.divergent_reference(a))
