"""``BatchResizeRead`` pipelines: the port against the JAX package.

Each pipeline is built with the JAX package's factories, run there through
``ParBackend.XLA`` on the CPU, carried across with ``from_jax`` and run in
the port twice: through the eager PyTorch version (``execute_operations``
on a CPU tensor) and through the kernel wrapper on CPU tensors, which
gathers the kernel's arguments with ``prepare`` and runs the plain version
on them. uint8 outputs must match bit for bit, float32 within 1e-5: inside
the 1e-4 contract, with room for XLA-CPU contraction.
"""

import cv2
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax

F32_TOL = 1e-5
UP = J.Size(64, 128)
ALPHA, SUB, DIV = 0.3, (3.2, 0.6, 11.8), (128.0, 128.0, 128.0)


def _frame(seed, h=200, w=300, c=3, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (h, w, c))
    return f.astype(dtype)


def _rects(n, cw=60, ch=120, step=1):
    return np.array([[i * step, i * step, cw, ch] for i in range(n)], np.int32)


def _flagship_chain(m):
    return (m.convert_to(np.float32, alpha=ALPHA), m.subtract(SUB), m.divide(DIV))


def _assert_close(actual, expected, msg=""):
    if isinstance(expected, tuple):
        assert isinstance(actual, tuple) and len(actual) == len(expected), msg
        for a, e in zip(actual, expected):
            _assert_close(a, e, msg)
        return
    a = actual.numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    e = np.asarray(expected)
    assert a.shape == e.shape, f"{msg}: shape {a.shape} vs {e.shape}"
    assert a.dtype == e.dtype, f"{msg}: dtype {a.dtype} vs {e.dtype}"
    if a.dtype == np.uint8:
        assert np.array_equal(a, e), f"{msg}: {(a != e).sum()} uint8 values differ"
    else:
        d = np.abs(a.astype(np.float64) - e.astype(np.float64)).max()
        assert d <= F32_TOL, f"{msg}: max |diff| {d}"


def check_parity(*jax_ops):
    """Run the pipeline in the JAX package and both port versions."""
    expected = J.execute_operations(*jax_ops, backend=J.ParBackend.XLA)
    expected = tuple(map(np.asarray, expected)) if isinstance(expected, tuple) else np.asarray(expected)
    pipeline = from_jax(J.build_pipeline(*jax_ops))
    eager = T.execute_operations(pipeline.read, *pipeline.compute, pipeline.write, device="cpu")
    assert T.last_backend() == "torch"
    _assert_close(eager, expected, "eager")
    kernel_plain = kbr.run(pipeline, kbr.build_plan(pipeline), torch.device("cpu"))
    _assert_close(kernel_plain, expected, "kernel plain version")
    return eager


@pytest.mark.parametrize("mode", list(J.AspectRatio), ids=lambda m: m.name)
@pytest.mark.parametrize("cw", [60, 30, 200])
def test_rect_mode_aspect_ratios(mode, cw):
    frame = _frame(1)
    rects = _rects(6, cw=cw, ch=120 if cw != 200 else 40, step=9)
    read = J.resize_batch(frame, rects=rects, dsize=UP, background=(128.0, 7.0, 250.0),
                          aspect_ratio=mode)
    check_parity(read, *_flagship_chain(J), J.split_tensor())


@pytest.mark.parametrize("mode", [J.AspectRatio.IGNORE_AR, J.AspectRatio.PRESERVE_AR])
def test_stack_mode(mode):
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((100, 50), (80, 120), (37, 61), (9, 5))]
    read = J.resize_batch(imgs, dsize=UP, background=11.0, aspect_ratio=mode)
    check_parity(read, *_flagship_chain(J), J.split_tensor())


def test_stack_mode_port_factory_pads_to_largest():
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for h, w in ((100, 50), (37, 61))]
    read = T.resize_batch(imgs, dsize=T.Size(64, 128))
    assert read.stack.shape == (2, 100, 61, 3)
    assert read.rects.tolist() == [[0, 0, 50, 100], [0, 0, 61, 37]]
    jread = J.resize_batch(imgs, dsize=UP)
    expected = np.asarray(J.execute_operations(jread, J.split_tensor(), backend=J.ParBackend.XLA))
    _assert_close(T.execute_operations(read, T.split_tensor(),
                                       device="cpu"), expected, "port factory")


@pytest.mark.parametrize("used", [0, 5, 8])
def test_ragged_used_planes(used):
    read = J.resize_batch(_frame(3), rects=_rects(8), dsize=UP, used_planes=used,
                          background=(128.0, 0.0, 64.0))
    out = check_parity(read, *_flagship_chain(J), J.split_tensor())
    masked = out[used:]
    bg = (np.array([128.0, 0.0, 64.0], np.float32) * np.float32(ALPHA)
          - np.array(SUB, np.float32)) / np.array(DIV, np.float32)
    assert np.array_equal(masked.numpy(), np.broadcast_to(bg[None, :, None, None], masked.shape))


@pytest.mark.parametrize("layout", ["write", "write_tensor", "split", "split_tensor",
                                    "split_tensor_transposed", "split_tensor_packed"])
def test_write_layouts(layout):
    read = J.resize_batch(_frame(4), rects=_rects(5, step=13), dsize=UP)
    check_parity(read, *_flagship_chain(J), getattr(J, layout)())


@pytest.mark.parametrize("alpha,beta", [(0.5, 3.0), (2.0, -20.0), (1.0, 0.5)])
def test_u8_saturate_tail(alpha, beta):
    # alpha is a power of two, so x*alpha is exact and XLA-CPU's contraction
    # of x*alpha + beta into an FMA cannot move a rounding tie
    read = J.resize_batch(_frame(5), rects=_rects(4, step=11), dsize=UP)
    out = check_parity(read, J.convert_to(np.uint8, alpha=alpha, beta=beta),
                       J.multiply(1.3), J.add((5.0, -300.0, 0.5)), J.split_tensor())
    assert out.dtype == torch.uint8


def test_u8_tail_rounds_each_op_once():
    """With an inexact alpha, XLA-CPU fuses ``x*alpha + beta`` into one FMA
    and can round a .5 tie the other way. The port rounds the product and
    the sum separately, as the CUDA kernel does: it must equal that
    computation in numpy bit for bit."""
    read = T.resize_batch(_frame(5), rects=_rects(4, step=11), dsize=T.Size(64, 128))
    f32 = T.execute_operations(read, T.write_tensor(), device="cpu").numpy()
    out = T.execute_operations(read, T.convert_to(np.uint8, alpha=1.7, beta=-20.0),
                               T.write_tensor(), device="cpu").numpy()
    y = (f32 * np.float32(1.7)).astype(np.float32) + np.float32(-20.0)
    assert np.array_equal(out, np.clip(np.rint(y), 0, 255).astype(np.uint8))
    pipeline = T.build_pipeline(read, T.convert_to(np.uint8, alpha=1.7, beta=-20.0),
                                T.write_tensor())
    plain = kbr.run(pipeline, kbr.build_plan(pipeline), torch.device("cpu")).numpy()
    assert np.array_equal(plain, out)


def test_static_loop_and_reorder():
    from cvgpuspeedup_tpu.ops.arithmetic import StaticLoop

    read = J.resize_batch(_frame(6), rects=_rects(3), dsize=UP)
    check_parity(read, J.vector_reorder(2, 0, 1),
                 StaticLoop(body=J.convert_to(np.uint8, alpha=1.1, beta=-2.0), n=3),
                 J.convert_to(np.float32), J.divide(255.0), J.split_tensor_transposed())


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rects_touching_and_past_the_frame_edge(dtype):
    frame = _frame(7, h=150, w=220, dtype=dtype)
    rects = np.array([
        [220 - 60, 150 - 120, 60, 120],   # touches the bottom-right corner
        [220 - 30, 10, 60, 120],          # hangs off the right edge
        [5, 150 - 50, 60, 120],           # hangs off the bottom edge
        [219, 149, 60, 120],              # starts on the last pixel
    ], np.int32)
    read = J.resize_batch(frame, rects=rects, dsize=UP)
    check_parity(read, *_flagship_chain(J), J.split_tensor())


NEGATIVE_ORIGINS = {
    "left_and_above": (-5, -3, 20, 10),
    "left_of_minus_width": (-70, 2, 20, 10),
    "past_right_and_bottom": (50, 35, 20, 10),
    "far_above_and_left": (-100, -50, 20, 10),
}


@pytest.mark.parametrize("out", ["u8", "f32"])
@pytest.mark.parametrize("name", sorted(NEGATIVE_ORIGINS))
def test_rects_with_negative_origins_read_like_the_reference(name, out):
    """The reference gathers taps with array indexing: an index left of or
    above the frame counts from the far edge (``t + len``), and then every
    index clamps into the frame. uint8 bit-exact, float32 bit-exact too."""
    frame = _frame(12, h=40, w=64)
    rects = np.array([NEGATIVE_ORIGINS[name]], np.int32)
    read = J.resize_batch(frame, rects=rects, dsize=J.Size(16, 8))
    tail = (J.convert_to(np.uint8),) if out == "u8" else ()
    expected = np.asarray(J.execute_operations(read, *tail, J.write_tensor(),
                                               backend=J.ParBackend.XLA))
    got = check_parity(read, *tail, J.write_tensor()).numpy()
    assert np.array_equal(got, expected)


def test_gray_source():
    frame = _frame(8, c=1)[..., 0]
    read = J.resize_batch(frame, rects=_rects(4), dsize=UP, background=9.0,
                          aspect_ratio=J.AspectRatio.PRESERVE_AR_LEFT)
    check_parity(read, J.convert_to(np.float32, alpha=2.0), J.split_tensor())


@pytest.mark.parametrize("batch", [1, 10])
def test_flagship_reduced_vs_cv2(batch):
    """The flagship at reduced size against the cv2 oracle of ``bench.py``:
    per-crop ``cv2.resize`` in float32, then the same scalar math."""
    frame = _frame(9, h=400, w=600)
    rects = _rects(batch)
    out = T.execute_operations(
        T.resize_batch(torch.from_numpy(frame), rects=rects, dsize=T.Size(64, 128)),
        *_flagship_chain(T), T.split_tensor(), device="cpu",
    ).numpy()
    assert out.shape == (batch, 3, 128, 64)
    for z, (x, y, w, h) in enumerate(rects):
        crop = frame[y:y + h, x:x + w].astype(np.float32)
        r = cv2.resize(crop, (64, 128), interpolation=cv2.INTER_LINEAR)
        r = (r * np.float32(ALPHA) - np.float32(SUB)) / np.float32(DIV)
        assert np.abs(out[z] - r.transpose(2, 0, 1)).max() <= 1e-4


def test_prepare_packs_host_and_device_leaves_alike():
    """The kernel's parameter block is the background, then the chain
    scalars in leaf order, whether the leaves are host values or tensors."""
    frame = torch.from_numpy(_frame(10))
    chain = (T.convert_to(np.float32, alpha=0.3), T.subtract((3.2, 0.6, 11.8)), T.divide(128.0))
    want = np.array([128.0, 7.0, 250.0, 0.3, 3.2, 0.6, 11.8, 128.0], np.float32)
    for background in ((128.0, 7.0, 250.0), torch.tensor([128.0, 7.0, 250.0])):
        pipeline = T.build_pipeline(
            T.resize_batch(frame, rects=_rects(3), dsize=T.Size(64, 128), background=background),
            *chain, T.split_tensor())
        plan = kbr.build_plan(pipeline)
        a = kbr.prepare(pipeline, plan, torch.device("cpu"))
        assert a.fparams.dtype == torch.float32 and a.fparams.numel() == plan.n_fparams
        assert np.array_equal(a.fparams.numpy(), want)
        assert a.plan.ops.tolist() == [[kbr.OP_MUL, 3, 0, 0], [kbr.OP_SUB, 4, 1, 0],
                                       [kbr.OP_DIV, 7, 0, 0]]
