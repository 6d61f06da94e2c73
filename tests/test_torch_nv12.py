"""NV12/NV21 reads and YUV->RGB: the port against the JAX package.

Unfused (``read_yuv`` then ``convert_yuv_to_rgb``) over bt601/bt709 x
full/limited x alpha x uint8/float32 out x NV12/NV21, and fused under a
resize, where the conversion commutes with the resize and runs on
destination pixels only (the frame kernel's NV12 path).

Tolerances. The port equals the reference's op-by-op lowering
(``Pipeline.lower()`` outside jit) bit for bit. The reference's jitted XLA
path contracts ``Y + c*V`` into FMAs on the CPU (ROADMAP §3), which moves a
float32 result by up to 6e-5 at these magnitudes and can round a uint8
result one step the other way; so against it float32 chains end with
x/255 and are held within 1e-5, and uint8 results within 1.
"""

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

F32_TOL = 1e-5


def _on_cpu(m):
    """The port's entry points default to the card; the reference has no
    ``device`` argument."""
    return {"device": "cpu"} if m is T else {}


def _buf(seed, h=144, w=384):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h * 3 // 2, w)).astype(np.uint8)


def _run_both(jax_ops):
    jp = J.build_pipeline(*jax_ops)
    pipeline = from_jax(jp)
    eager = T.execute_operations(pipeline.read, *pipeline.compute, pipeline.write,
                                 device="cpu").numpy()
    assert T.last_backend() == "torch"
    op_by_op = np.asarray(jp.lower())
    assert eager.dtype == op_by_op.dtype and np.array_equal(eager, op_by_op)
    return jp, pipeline, eager


@pytest.mark.parametrize("fmt", list(J.PixelFormat), ids=lambda f: f.name)
@pytest.mark.parametrize("out", ["u8", "f32"])
@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("rng_", list(J.ColorRange), ids=lambda r: r.name)
@pytest.mark.parametrize("std", list(J.ColorStandard), ids=lambda s: s.name)
def test_unfused_read_and_convert(std, rng_, alpha, out, fmt):
    buf = _buf(2, h=72, w=128)
    out_dtype = np.uint8 if out == "u8" else np.float32
    conv = J.convert_yuv_to_rgb(color_range=rng_, standard=std, alpha=alpha, out_dtype=out_dtype)
    ops = (J.read_yuv(buf, pixel_format=fmt), conv)
    if out == "f32":
        ops += (J.multiply(1 / 255.0),)
    _, _, eager = _run_both(ops)
    assert eager.shape == (72, 128, 4 if alpha else 3) and eager.dtype == out_dtype
    xla = np.asarray(J.execute_operations(*ops, backend=J.ParBackend.XLA))
    d = np.abs(eager.astype(np.float64) - xla.astype(np.float64)).max()
    assert d <= (1 if out == "u8" else F32_TOL), d
    if alpha:
        assert np.all(eager[..., 3] == (255 if out == "u8" else np.float32(1 / 255.0)))


FUSED = {
    "bt709_full_3to1": (J.ColorStandard.BT709, J.ColorRange.FULL, False, (128, 48)),
    "bt601_limited_alpha_1.5to1": (J.ColorStandard.BT601, J.ColorRange.LIMITED, True, (256, 96)),
    "bt709_limited_upscale": (J.ColorStandard.BT709, J.ColorRange.LIMITED, False, (512, 192)),
}


def _fused_ops(m, buf, fmt, std, rng_, alpha, dsize):
    return (
        m.resize(m.fuse(m.read_yuv(buf, pixel_format=fmt),
                        m.convert_yuv_to_rgb(color_range=rng_, standard=std, alpha=alpha,
                                             out_dtype=np.float32)),
                 m.Size(*dsize)),
        m.multiply(1 / 255.0),
        m.split_tensor(),
    )


@pytest.mark.parametrize("fmt", list(J.PixelFormat), ids=lambda f: f.name)
@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_under_resize(case, fmt):
    std, rng_, alpha, dsize = FUSED[case]
    ops = _fused_ops(J, _buf(3), fmt, std, rng_, alpha, dsize)
    jp, pipeline, eager = _run_both(ops)
    assert eager.shape == (4 if alpha else 3, dsize[1], dsize[0])
    xla = np.asarray(J.execute_operations(*ops, backend=J.ParBackend.XLA))
    assert np.abs(eager - xla).max() <= F32_TOL
    if pallas_frame.supports(jp):
        got = np.asarray(J.execute_operations(*ops, backend=J.ParBackend.PALLAS_INTERPRET))
        assert_backend("pallas:frame:interpret")
        assert np.abs(eager - got).max() <= F32_TOL
    plan = kfr.build_plan(pipeline)
    assert plan.yuv and plan.nv21 == (fmt == J.PixelFormat.NV21) and plan.keep_edge
    plain = kfr.run(pipeline, plan, torch.device("cpu")).numpy()
    assert np.array_equal(plain, eager)


def test_fused_reads_on_the_reference_frame_kernels_path():
    """At least one fused geometry runs the reference's own frame kernel."""
    jp = J.build_pipeline(*_fused_ops(J, _buf(3), J.PixelFormat.NV12, J.ColorStandard.BT709,
                                      J.ColorRange.FULL, False, (128, 48)))
    assert pallas_frame.supports(jp)


@pytest.mark.parametrize("width,dsize", [(390, (190, 48)), (384, (97, 48))],
                         ids=["half_plan_past_the_cap", "over_32_phases"])
def test_fused_where_the_half_plane_plan_is_infeasible(width, dsize):
    """The reference falls back to a full-resolution read with nearest
    chroma; the port's plane-space read must equal it. 390 -> 190 has 19
    phases but the halved chroma plan needs 38 (past the cap); 384 -> 97
    has 97 phases and takes the zeroed-edge rule."""
    assert jresize._axis_phases_half(width, dsize[0]) is None
    ops = _fused_ops(J, _buf(4, w=width), J.PixelFormat.NV12, J.ColorStandard.BT601,
                     J.ColorRange.FULL, True, dsize)
    _, pipeline, eager = _run_both(ops)
    xla = np.asarray(J.execute_operations(*ops, backend=J.ParBackend.XLA))
    assert np.abs(eager - xla).max() <= F32_TOL
    plan = kfr.build_plan(pipeline)
    assert plan.keep_edge == (width == 390)
    assert np.array_equal(kfr.run(pipeline, plan, torch.device("cpu")).numpy(), eager)


@pytest.mark.parametrize("src,dst", [(384, 128), (384, 256), (144, 48), (144, 96), (384, 512),
                                     (5760, 1920), (3240, 1080)])
def test_plan_chroma_taps_equal_the_half_plane_plan(src, dst):
    """The plan's chroma taps (full-resolution taps halved) equal the
    reference's half-plane polyphase taps, clamped into the half plane."""
    half = jresize._axis_phases_half(src, dst)
    assert half is not None
    stride, q2, j0s, j1s, ws = half
    buf = np.zeros((src * 3 // 2, src), np.uint8)  # a square frame: both axes src -> dst
    pipe = T.build_pipeline(T.resize(T.fuse(T.read_yuv(buf), T.convert_yuv_to_rgb(out_dtype=np.float32)),
                                     T.Size(dst, dst)))
    plan = kfr.build_plan(pipe)
    cx0, cx1 = plan.taps[4 * dst:5 * dst], plan.taps[5 * dst:6 * dst]
    k, phase = np.arange(dst) // q2, np.arange(dst) % q2
    assert np.array_equal(cx0, np.clip(j0s[phase] + k * stride, 0, src // 2 - 1))
    assert np.array_equal(cx1, np.clip(j1s[phase] + k * stride, 0, src // 2 - 1))
    assert np.array_equal(plan.weights[:dst].view(np.uint32),
                          ws[phase].astype(np.float32).view(np.uint32))


def test_integer_conversion_under_resize_is_not_commuted():
    """A uint8 conversion saturates, so it is not affine: the frame is
    converted first and the RGB image resized; the frame kernel refuses it."""
    ops = (J.resize(J.fuse(J.read_yuv(_buf(5)), J.convert_yuv_to_rgb()), J.Size(128, 48)),
           J.split_tensor())
    jp, pipeline, eager = _run_both(ops)
    xla = np.asarray(J.execute_operations(*ops, backend=J.ParBackend.XLA))
    assert np.abs(eager - xla).max() <= F32_TOL
    assert not kfr.supports(pipeline)


def test_port_factories_and_errors():
    buf = _buf(6, h=8, w=16)
    read = T.read_yuv(torch.from_numpy(buf), pixel_format=T.PixelFormat.NV21)
    assert read.pixel_format is T.PixelFormat.NV21
    y, uv = read.lower_native_planes()
    assert tuple(y.shape) == (8, 16) and tuple(uv.shape) == (4, 8, 2)
    assert np.array_equal(uv[..., 0].numpy(), buf[8:].reshape(4, 8, 2)[..., 1])
    # a trailing 1-axis is squeezed
    y1, _ = T.read_yuv(buf[..., None]).lower_native_planes()
    assert np.array_equal(y1.numpy(), buf[:8])
    conv = T.convert_yuv_to_rgb(out_dtype=np.float32)
    assert conv.out_dtype == torch.float32
    for m in (J, T):  # luma of 11 columns: odd
        with pytest.raises(ValueError):
            m.execute_operations(m.read_yuv(np.zeros((15, 11), np.uint8)), **_on_cpu(m))
