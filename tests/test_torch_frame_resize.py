"""``ResizeRead`` over one frame: the port against the JAX package.

Each pipeline is built with the JAX package's factories and carried across
with ``from_jax``. The port runs it twice: through the eager PyTorch version
(``execute_operations`` on CPU tensors) and through the frame kernel's
wrapper on CPU tensors, which gathers the kernel's arguments with
``prepare`` and runs the plain version on them.

Tolerances. The port equals the reference's op-by-op lowering
(``Pipeline.lower()`` outside jit) bit for bit, uint8 and float32 alike.
Against the reference's jitted ``ParBackend.XLA`` path, and its frame kernel
in ``ParBackend.PALLAS_INTERPRET``, uint8 outputs match bit for bit and
float32 outputs within 1e-5: XLA-CPU contracts some lerps of an upscale into
FMAs (ROADMAP §3), which moves a float32 result by an ulp, so the chains end
normalized (x/255) and the uint8 cases use ratios whose lerps it leaves
alone.
"""

import math

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from conftest import assert_backend
from cvgpuspeedup_tpu.exec import pallas_frame
from cvgpuspeedup_tpu.ops import resize as jresize
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.ops import resize as tresize
from cvgpuspeedup_tpu_torch.utils import dtypes as dt

F32_TOL = 1e-5
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _img(seed, h=96, w=384, c=3, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, c)).astype(dtype)


def _normalize(m):
    return (m.convert_to(np.float32, alpha=1 / 255.0), m.subtract(MEAN), m.divide(STD))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _host(x):
    return tuple(np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for v in _as_tuple(x))


def _assert_close(actual, expected, msg):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.shape == e.shape and a.dtype == e.dtype, f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}"
        if a.dtype == np.uint8:
            assert np.array_equal(a, e), f"{msg}: {(a != e).sum()} uint8 values differ"
        else:
            d = np.abs(a.astype(np.float64) - e.astype(np.float64)).max()
            assert d <= F32_TOL, f"{msg}: max |diff| {d}"


def _assert_equal(actual, expected, msg):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.dtype == e.dtype and np.array_equal(a, e), f"{msg}: not bit-equal"


def check_parity(*jax_ops, pallas=None):
    """Run the pipeline in the JAX package (jitted XLA, op by op, and the
    Pallas frame kernel in interpret mode when it takes the pipeline) and in
    both port versions; returns the port's eager output."""
    jp = J.build_pipeline(*jax_ops)
    xla = J.execute_operations(*jax_ops, backend=J.ParBackend.XLA)
    pipeline = from_jax(jp)
    eager = T.execute_operations(pipeline.read, *pipeline.compute, pipeline.write, device="cpu")
    assert T.last_backend() == "torch"
    _assert_equal(eager, jp.lower(), "eager vs the reference op by op")
    _assert_close(eager, xla, "eager vs the reference's XLA path")
    plain = kfr.run(pipeline, kfr.build_plan(pipeline), torch.device("cpu"))
    _assert_equal(plain, eager, "kernel plain version vs eager")
    if pallas is None:
        pallas = pallas_frame.supports(jp)
    if pallas:
        got = J.execute_operations(*jax_ops, backend=J.ParBackend.PALLAS_INTERPRET)
        assert_backend("pallas:frame:interpret")
        _assert_close(eager, got, "eager vs the reference's frame kernel")
    return eager


RATIOS = {
    "3to1": (128, 32),         # pure subsample: every weight 0
    "1.5to1": (256, 64),
    "upscale": (512, 144),     # negative numerators at the first column and row
    "over_32_phases": (97, 41),  # 384 -> 97: 97 phases, the zeroed-edge rule
}


@pytest.mark.parametrize("name", sorted(RATIOS))
def test_ratios_match_reference(name):
    ops = (J.resize(J.image(_img(1)), J.Size(*RATIOS[name])), *_normalize(J), J.split_tensor())
    # the reference's frame kernel takes the two downscales (its tiling gates
    # refuse the other two)
    out = check_parity(*ops, pallas=name in ("3to1", "1.5to1"))
    w, h = RATIOS[name]
    assert tuple(out.shape) == (3, h, w) and out.dtype == torch.float32


@pytest.mark.parametrize("src,dst", [(384, 128), (384, 256), (384, 512), (96, 144), (384, 97),
                                     (96, 41), (1080, 416), (1, 5), (7, 2)])
def test_tap_tables_follow_the_reference_rule(src, dst):
    """``axis_taps`` equals the reference's polyphase plan (taps clamped,
    weights kept) within the phase cap, and its ``axis_lerp_np`` (weights
    zeroed at clamped edges) past it."""
    q_phases = dst // math.gcd(src, dst)
    keep = q_phases <= tresize.MAX_PHASES
    assert tresize.keeps_edge_weight(src, src, T.Size(dst, dst)) == keep
    i0, i1, w = tresize.axis_taps(src, dst, keep)
    assert w.dtype == np.float32
    if keep:
        p_stride, q, i0s, ws, _ = jresize._axis_phases(src, dst)
        k = np.arange(dst) // q
        phase = np.arange(dst) % q
        want0 = i0s[phase] + k * p_stride
        assert np.array_equal(i0, np.clip(want0, 0, src - 1))
        assert np.array_equal(i1, np.clip(want0 + 1, 0, src - 1))
        assert np.array_equal(w.view(np.uint32), ws[phase].astype(np.float32).view(np.uint32))
    else:
        j0, j1, jw = jresize.axis_lerp_np(np.arange(dst), src, dst)
        assert np.array_equal(i0, j0) and np.array_equal(i1, j1)
        assert np.array_equal(w.view(np.uint32), jw.view(np.uint32))


def test_plan_holds_the_tables_of_its_rule():
    for dsize, keep in (((128, 32), True), ((97, 41), False)):
        pipe = T.build_pipeline(T.resize(T.image(_img(2)), T.Size(*dsize)), T.split_tensor())
        plan = kfr.build_plan(pipe)
        assert plan.keep_edge is keep and not plan.yuv
        tx, ty = tresize.axis_taps(384, dsize[0], keep), tresize.axis_taps(96, dsize[1], keep)
        assert np.array_equal(plan.taps, np.concatenate([tx[0], tx[1], ty[0], ty[1]]))
        assert np.array_equal(plan.weights, np.concatenate([tx[2], ty[2]]))


@pytest.mark.parametrize("kind", ["gray_2d", "gray_1ch", "f32_rgb", "f32_rgba"])
def test_gray_and_float_sources(kind):
    if kind == "gray_2d":
        img = _img(3, c=1)[..., 0]
    elif kind == "gray_1ch":
        img = _img(3, c=1)
    else:
        img = _img(4, c=3 if kind == "f32_rgb" else 4).astype(np.float32) / np.float32(255.0)
    out = check_parity(J.resize(J.image(img), J.Size(256, 64)), J.multiply(3.0), J.split_tensor())
    assert out.shape[0] == (1 if kind.startswith("gray") else img.shape[-1])


def test_packed_host_image():
    """The reference ingests a host (H, W, C) frame as packed (H, W*C) rows;
    the port reads the same rows, through its own ``image(channels=)`` too."""
    img = _img(5)
    jread = J.image(img)
    assert jread.packed_channels == 3 and jread.data.shape == (96, 384 * 3)
    out = check_parity(J.resize(jread, J.Size(128, 32)), *_normalize(J), J.split_tensor())
    packed = T.image(img.reshape(96, 384 * 3), channels=3)
    pipe = T.build_pipeline(T.resize(packed, T.Size(128, 32)), *_normalize(T), T.split_tensor())
    assert kfr.supports(pipe)
    _assert_equal(kfr.run(pipe, kfr.build_plan(pipe), torch.device("cpu")), out, "port packed")


@pytest.mark.parametrize("fx,fy", [(0.5, 0.25), (1.5, 0.75), (0.33, 0.34)])
def test_fx_fy_sizing(fx, fy):
    img = _img(6)
    jr = J.resize(img, fx=fx, fy=fy)
    tr = T.resize(img, fx=fx, fy=fy)
    assert tuple(tr.dsize) == tuple(jr.dsize) == (round(384 * fx), round(96 * fy))
    tr0 = T.resize(torch.from_numpy(img), dsize=T.Size(0, 0), fx=fx, fy=fy)
    assert tr0.dsize == tr.dsize
    check_parity(jr, *_normalize(J), J.split_tensor())


def test_fx_fy_errors_like_reference():
    img = _img(6)
    for m in (J, T):
        with pytest.raises(ValueError):
            m.resize(img)  # no dsize, no fx/fy
        with pytest.raises(ValueError):
            m.resize(m.image(img), fx=0.5, fy=0.5)  # a read op has no shape to read
        with pytest.raises(ValueError):
            m.resize()


@pytest.mark.parametrize("layout", ["split", "split_tensor", "write"])
def test_write_layouts(layout):
    out = check_parity(J.resize(J.image(_img(7)), J.Size(256, 64)), *_normalize(J),
                       getattr(J, layout)())
    if layout == "split":
        assert isinstance(out, tuple) and len(out) == 3 and tuple(out[0].shape) == (64, 256)


@pytest.mark.parametrize("layout", ["split", "split_tensor"])
def test_u8_out_chain(layout):
    # alpha is a power of two: x*alpha is exact, so no FMA contraction on
    # the reference side can move a rounding tie
    out = check_parity(J.resize(J.image(_img(8)), J.Size(128, 32)),
                       J.convert_to(np.uint8, alpha=0.5, beta=3.0), J.multiply(1.25),
                       getattr(J, layout)())
    assert _as_tuple(out)[0].dtype == torch.uint8


def test_u8_out_at_fractional_ratio_equals_reference_op_by_op():
    """A uint8 result of a 1.5:1 resize, with a uint8 chain, against the
    reference bit for bit."""
    check_parity(J.resize(J.image(_img(9)), J.Size(256, 64)), J.convert_to(np.uint8),
                 J.split_tensor())


def test_pending_resize_binds_to_the_preceding_read():
    img = _img(10)
    a = T.execute_operations(T.image(img), T.resize(T.Size(128, 32)), T.split_tensor(),
                             device="cpu")
    b = T.execute_operations(T.resize(T.image(img), T.Size(128, 32)), T.split_tensor(),
                             device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        T.resize(dsize=None)


def test_kernel_supports_and_refusals():
    img = _img(11)
    ok = T.build_pipeline(T.resize(T.image(img), T.Size(128, 32)), *_normalize(T), T.split_tensor())
    assert kfr.supports(ok)
    # no TPU tiling gate: an odd frame is supported
    odd = T.build_pipeline(T.resize(T.image(_img(11, h=37, w=61)), T.Size(13, 7)))
    assert kfr.supports(odd)
    refused = {
        "batched": T.build_pipeline(T.resize(T.image(np.stack([img, img])), T.Size(128, 32))),
        "tensor_write": T.build_pipeline(T.resize(T.image(img), T.Size(128, 32)), T.write_tensor()),
        "five_channels": T.build_pipeline(T.resize(T.image(_img(11, c=5)), T.Size(128, 32))),
        "uint32_out": T.build_pipeline(T.resize(T.image(img), T.Size(128, 32)),
                                       T.Cast(dst=torch.uint32)),
        "no_resize": T.build_pipeline(T.image(img), T.multiply(2.0)),
        "uint32_source": T.build_pipeline(T.resize(T.image(img.astype(np.uint32)),
                                                   T.Size(128, 32))),
    }
    for name, pipe in refused.items():
        assert not kfr.supports(pipe), name
    # every dtype a 32-bit register holds is a source, a chain and an output
    assert kfr.supports(T.build_pipeline(T.resize(T.image(img.astype(np.int16)), T.Size(128, 32)),
                                         T.convert_to(np.float16)))
    assert kfr.supports(T.build_pipeline(T.resize(T.image(img.astype(np.int32)), T.Size(128, 32)),
                                         T.convert_to(np.int32)))
    # int64 and float64 are int32 and float32 where they enter (a tensor of
    # either is read at load), as in the reference
    for dtype in (torch.int64, torch.float64):
        src = torch.from_numpy(img).to(dtype)
        plan = kfr.build_plan(T.build_pipeline(T.resize(T.image(src), T.Size(128, 32)),
                                               T.Cast(dst=dtype)))
        assert plan.src_dtype == dtype and plan.out_dtype == dt.canonical_dtype(dtype)


def test_backend_choice_on_the_cpu():
    ops = (T.resize(T.image(torch.from_numpy(_img(12))), T.Size(128, 32)), T.split_tensor())
    assert T.describe_backend(*ops, device="cpu") == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        T.execute_operations(*ops, backend=T.ParBackend.CUDA, device="cpu")
