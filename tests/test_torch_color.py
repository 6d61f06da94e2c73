"""``ColorConversion``: the port against the JAX package and cv2, and the
batched crop-resize kernel's encoding of the colour codes.

All 16 codes on uint8 images (bit-exact) and float32 images in [0, 1)
(within 1e-5; the reference's XLA path may contract the float gray sum into
FMAs, an ulp at these magnitudes). uint8 gray against cv2 bit for bit.
"""

import cv2
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.ops.color import _CODE_INFO

F32_TOL = 1e-5
CODES = [c.name for c in J.ColorConversionCode]


def _on_cpu(m):
    """The port's entry points default to the card; the reference has no
    ``device`` argument."""
    return {"device": "cpu"} if m is T else {}


def _img(seed, c, dtype=np.uint8, h=24, w=40):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    return rng.random((h, w, c)).astype(np.float32)


def _close(a, e):
    assert a.shape == e.shape and a.dtype == e.dtype, (a.shape, a.dtype, e.shape, e.dtype)
    if a.dtype == np.uint8:
        assert np.array_equal(a, e), f"{(a != e).sum()} uint8 values differ"
    else:
        assert np.abs(a.astype(np.float64) - e.astype(np.float64)).max() <= F32_TOL


def test_port_knows_every_reference_code():
    assert [c.name for c in T.ColorConversionCode] == CODES
    assert sorted(c.name for c in _CODE_INFO) == sorted(CODES)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("code", CODES)
def test_codes_match_reference(code, dtype):
    jcode = J.ColorConversionCode[code]
    in_c = _CODE_INFO[T.ColorConversionCode[code]][0]
    img = _img(1, in_c, dtype)
    want = np.asarray(J.execute_operations(J.image(img), J.cvt_color(jcode),
                                           backend=J.ParBackend.XLA))
    got = T.execute_operations(T.image(torch.from_numpy(img)),
                               T.cvt_color(T.ColorConversionCode[code]), device="cpu").numpy()
    _close(got, want)
    carried = from_jax(J.build_pipeline(J.image(img), J.cvt_color(jcode)))
    _close(T.execute_operations(carried.read, *carried.compute, carried.write,
                                device="cpu").numpy(), want)


@pytest.mark.parametrize("code", ["COLOR_RGB2GRAY", "COLOR_RGBA2GRAY", "COLOR_BGR2GRAY",
                                  "COLOR_BGRA2GRAY"])
def test_u8_gray_matches_cv2(code):
    in_c = _CODE_INFO[T.ColorConversionCode[code]][0]
    img = _img(2, in_c, h=64, w=96)
    got = T.execute_operations(T.image(torch.from_numpy(img)),
                               T.cvt_color(T.ColorConversionCode[code]), device="cpu").numpy()
    want = cv2.cvtColor(img, getattr(cv2, code))
    assert np.array_equal(got[..., 0], want)


@pytest.mark.parametrize("code", ["COLOR_BGR2BGRA", "COLOR_BGRA2RGB"])
def test_alpha_fill_matches_cv2(code):
    in_c = _CODE_INFO[T.ColorConversionCode[code]][0]
    img = _img(3, in_c)
    got = T.execute_operations(T.image(torch.from_numpy(img)),
                               T.cvt_color(T.ColorConversionCode[code]), device="cpu").numpy()
    assert np.array_equal(got, cv2.cvtColor(img, getattr(cv2, code)))


def test_wrong_channel_count_raises_like_reference():
    img = _img(4, 4)
    for m in (J, T):
        with pytest.raises(ValueError):
            m.execute_operations(m.image(img), m.cvt_color(m.ColorConversionCode.COLOR_BGR2RGB),
                                 **_on_cpu(m))


def test_batch_kernel_encodes_colour_codes():
    C = T.ColorConversionCode
    chain = (T.cvt_color(C.COLOR_BGR2RGBA), T.multiply(2.0), T.cvt_color(C.COLOR_RGBA2BGR),
             T.convert_to(np.uint8), T.cvt_color(C.COLOR_BGR2GRAY))
    ops, out_dtype, out_ch, n_params = kbr.encode_chain(chain, 3, first_param=3)
    assert (out_dtype, out_ch, n_params) == (torch.uint8, 1, 4)
    swap = 2 | (1 << 4) | (0 << 8)
    assert ops.tolist() == [
        [kbr.OP_REORDER, 0, 0, swap | (3 << 16)],
        [kbr.OP_ALPHA, 0, 0, 1],                     # float alpha: 1.0
        [kbr.OP_MUL, 3, 0, 0],
        [kbr.OP_REORDER, 0, 0, swap | (3 << 16)],    # RGBA -> BGR drops alpha
        [kbr.OP_SAT_U8, 0, 0, 0],
        [kbr.OP_GRAY_U8, 0, 0, 2 | (1 << 4) | (0 << 8)],
    ]
    # float gray; a per-channel scalar after it has one channel to match
    ops, _, out_ch, _ = kbr.encode_chain((T.cvt_color(C.COLOR_RGB2GRAY), T.subtract(0.5)), 3)
    assert ops[0].tolist() == [kbr.OP_GRAY_F32, 0, 0, 0 | (1 << 4) | (2 << 8)] and out_ch == 1
    with pytest.raises(kbr.Unsupported):
        kbr.encode_chain((T.cvt_color(C.COLOR_RGB2GRAY), T.subtract((1.0, 2.0, 3.0))), 3)
    with pytest.raises(kbr.Unsupported):
        kbr.encode_chain((T.cvt_color(C.COLOR_BGRA2BGR),), 3)


BATCH_CHAINS = {
    "bgr2gray_f32": lambda m: (m.cvt_color(m.ColorConversionCode.COLOR_BGR2GRAY),
                               m.multiply(1 / 255.0), m.split_tensor()),
    "bgr2rgba_normalize": lambda m: (m.cvt_color(m.ColorConversionCode.COLOR_BGR2RGBA),
                                     m.convert_to(np.float32, alpha=1 / 255.0),
                                     m.subtract((0.5, 0.4, 0.3, 0.0)), m.split_tensor()),
    "u8_gray": lambda m: (m.convert_to(np.uint8), m.cvt_color(m.ColorConversionCode.COLOR_RGB2GRAY),
                          m.write_tensor()),
    "u8_rgba_then_rgb": lambda m: (m.convert_to(np.uint8),
                                   m.cvt_color(m.ColorConversionCode.COLOR_RGB2BGRA),
                                   m.cvt_color(m.ColorConversionCode.COLOR_BGRA2RGB),
                                   m.split_tensor_transposed()),
}


@pytest.mark.parametrize("name", sorted(BATCH_CHAINS))
def test_batch_kernel_plain_version_with_colour_chain(name):
    """The batched crop-resize with a colour chain: the kernel's plain
    version on CPU tensors equals the eager path, which equals the
    reference's op-by-op lowering, bit for bit. Against the reference's
    jitted XLA path float32 holds within 1e-5 and uint8 within 1: XLA-CPU
    contracts some lerps into FMAs (ROADMAP §3), which can move a .5 tie."""
    frame = _img(5, 3, h=150, w=220)
    rects = np.array([[i * 9, i * 7, 60, 40] for i in range(5)], np.int32)
    jops = (J.resize_batch(frame, rects=rects, dsize=J.Size(32, 24)), *BATCH_CHAINS[name](J))
    jp = J.build_pipeline(*jops)
    pipeline = from_jax(jp)
    eager = T.execute_operations(pipeline.read, *pipeline.compute, pipeline.write, device="cpu")
    plan = kbr.build_plan(pipeline)
    plain = kbr.run(pipeline, plan, torch.device("cpu"))
    assert torch.equal(plain, eager)
    op_by_op = np.asarray(jp.lower())
    assert eager.numpy().dtype == op_by_op.dtype and np.array_equal(eager.numpy(), op_by_op)
    xla = np.asarray(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    d = np.abs(eager.numpy().astype(np.float64) - xla.astype(np.float64)).max()
    assert d <= (1 if xla.dtype == np.uint8 else F32_TOL), d
    assert plan.out_ch == {"bgr2gray_f32": 1, "bgr2rgba_normalize": 4, "u8_gray": 1,
                           "u8_rgba_then_rgb": 3}[name]
