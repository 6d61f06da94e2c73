"""The reference's remaining test cases, carried across to the port:
``tests/test_api_edges.py``, ``test_arithmetic.py``, ``test_convert_to.py``,
``test_graph.py``, ``test_packed.py``, ``test_batchresize_sweep.py`` and
``test_backend_select.py``, case by case under the original's name, each from
one numpy seed through the port (``device="cpu"``), the original's oracle
(cv2) and, where the original has none, the JAX package. Tolerances are the
repo's: integer outputs bit for bit, float outputs within 1e-4.
"""

import cv2
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from conftest import check_exact, check_float
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import FusedCompute, FusedRead, flatten, map_leaves
from cvgpuspeedup_tpu_torch.ops.memory import ImageRead
from cvgpuspeedup_tpu_torch.ops.resize import BatchResizeRead

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # only named: the routing tests decide on shapes


def _run(*ops, **kw):
    out = T.execute_operations(*ops, device="cpu", **kw)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def _ref(*ops, **kw):
    return np.asarray(J.execute_operations(*ops, backend=J.ParBackend.XLA, **kw))


# --- test_api_edges.py -----------------------------------------------------------


def test_resize_with_fx_fy(rng):
    img = rng.integers(0, 256, (40, 60, 3)).astype(np.uint8)
    out = _run(T.resize(img, T.Size(0, 0), fx=0.5, fy=0.25))
    assert out.shape == (10, 30, 3)
    check_float(out, cv2.resize(img.astype(np.float32), (30, 10), interpolation=cv2.INTER_LINEAR),
                msg="fx/fy resize")
    check_float(out, _ref(J.resize(img, J.Size(0, 0), fx=0.5, fy=0.25)), msg="against the reference")


def test_execute_with_input_array(rng):
    img = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    out = _run(T.convert_to(np.float32, alpha=2.0), input=img)
    check_float(out, img.astype(np.float32) * 2.0, msg="input= overload")
    with pytest.raises(ValueError, match="not both"):
        _run(T.image(img), input=img)


def test_grayscale_2d_input(rng):
    img = rng.integers(0, 256, (12, 20)).astype(np.uint8)
    out = _run(T.image(img), T.multiply(2.0))
    assert out.shape == (12, 20, 1)
    check_exact(out[..., 0], cv2.multiply(img, np.array(2.0)), "gray 2D")
    assert kp.supports(T.build_pipeline(T.image(img), T.multiply(2.0)))


def test_convert_to_float_beta(rng):
    img = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    out = _run(T.image(img), T.convert_to(np.float32, alpha=0.5, beta=-3.25))
    ref = cv2.addWeighted(img, 0.5, img, 0.0, -3.25, dtype=cv2.CV_32F).reshape(img.shape)
    check_float(out, ref, msg="float alpha+beta")


def test_crop_batch_same_size(rng):
    frame = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    rects = [T.Rect(i, 2 * i, 16, 12) for i in range(4)]
    out = _run(T.crop_batch(frame, rects))
    assert out.shape == (4, 12, 16, 3)
    for i, r in enumerate(rects):
        check_exact(out[i], frame[r.y:r.y + 12, r.x:r.x + 16], f"crop {i}")
    with pytest.raises(ValueError):
        T.crop_batch(frame, [T.Rect(0, 0, 8, 8), T.Rect(0, 0, 9, 8)])


def test_divergent_selector_out_of_range(rng):
    data = rng.random((2, 4, 4, 1), dtype=np.float32)
    seq = T.build_operation_sequence(T.image(data))
    with pytest.raises(ValueError):
        T.launch_divergent_batch(lambda z: 5, seq, device="cpu")


def test_batched_pipeline_input_4d(rng):
    batch = rng.integers(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    out = _run(T.convert_to(np.float32), input=batch)
    assert out.shape == (3, 8, 8, 3) and out.dtype == np.float32


def test_int16_negative_saturate(rng):
    img = (rng.random((8, 8, 1), dtype=np.float32) * 200000 - 100000).astype(np.float32)
    out = _run(T.image(img), T.convert_to(np.int16))
    check_exact(out, np.clip(np.rint(img), -32768, 32767).astype(np.int16), "negative saturate")
    assert out.dtype == np.int16
    assert kp.build_plan(T.build_pipeline(T.image(img), T.convert_to(np.int16))).out_dtype == torch.int16


def test_convert_to_beta_only():
    img = np.full((4, 4, 3), 100, np.uint8)
    assert np.all(_run(T.image(img), T.convert_to(np.uint8, beta=10.0)) == 110)
    assert np.all(_run(T.image(img), T.convert_to(np.float32, beta=10.0)) == 110.0)


def test_divergent_accepts_id_list(rng):
    data = rng.random((4, 4, 4, 1), dtype=np.float32)
    seq1 = T.build_operation_sequence(T.image(data), T.multiply(2.0))
    seq2 = T.build_operation_sequence(T.image(data))
    out = T.launch_divergent_batch([1, 2, 1, 2], seq1, seq2, device="cpu").numpy()
    check_float(out[0], data[0] * 2.0)
    check_float(out[1], data[1])


def test_divergent_lambda_reuses_cache(rng):
    """New lambdas with the same routing find the plan of the first."""
    data = rng.random((4, 4, 4, 1), dtype=np.float32)
    executor.clear_cache()
    builds = []
    for _ in range(3):
        seq = T.build_operation_sequence(T.image(data), T.add(1.0))
        T.launch_divergent_batch(lambda z: 1, seq, device="cpu")
        builds.append(executor.PLAN_BUILDS)
    assert builds[0] == builds[1] == builds[2]
    assert sum(1 for k in executor._PLANS if "divergent" in k) == 1


def test_circular_tensor_snapshot():
    ct = T.CircularTensor(width=4, height=4, channels=3, batch=2, device="cpu")
    ct.update(input=np.full((4, 4, 3), 1, np.uint8))
    snap = ct.snapshot()
    ct.update(input=np.full((4, 4, 3), 2, np.uint8))
    assert float(snap[0, 0, 0, 0]) == 1.0 and float(ct.tensor[0, 0, 0, 0]) == 2.0


def test_resize_batch_2d_grayscale_frame(rng):
    frame = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    rects = np.array([[0, 0, 32, 32], [8, 8, 16, 16]], np.int32)
    out = _run(T.resize_batch(frame, rects=rects, dsize=T.Size(16, 16)))
    assert out.shape == (2, 16, 16, 1)
    check_float(out[0, ..., 0], cv2.resize(frame[:32, :32].astype(np.float32), (16, 16)),
                msg="gray frame plane 0")


def test_warp_2d_grayscale(rng):
    img = rng.integers(0, 256, (12, 20)).astype(np.uint8)
    m = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    out = _run(T.warp(img, m, T.Size(10, 8)))
    assert out.shape == (8, 10, 1)
    check_float(out[..., 0], img[:8, :10].astype(np.float32))


def test_warp_channels_from_readop(rng):
    img = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    m = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    assert _run(T.warp(T.image(img), m, T.Size(8, 8))).shape == (8, 8, 4)


def test_batch_read_used_planes_requires_default(rng):
    ops = [T.image(rng.random((4, 4, 3), dtype=np.float32)) for _ in range(2)]
    with pytest.raises(ValueError):
        T.batch_read(ops, used_planes=1)


def test_pipeline_lower_outside_jit(rng):
    """``Pipeline.lower`` with numpy leaves moved to tensors, called directly."""
    frame = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    pipe = T.build_pipeline(T.resize_batch(frame, rects=np.array([[0, 0, 32, 32]], np.int32),
                                           dsize=T.Size(8, 8)))
    out = map_leaves(pipe, lambda v: torch.as_tensor(v)).lower()
    assert tuple(out.shape) == (1, 8, 8, 3)


def test_pallas_scalar_vec_broadcast(rng):
    """A per-channel scalar of length 1 broadcasts on the kernel's path too
    (its plan and plain version) as on the eager one."""
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[0, 0, 60, 120]], np.int32)
    ops = (T.resize_batch(frame, rects=rects, dsize=T.Size(64, 128)), T.multiply((2.0,)),
           T.split_tensor())
    pipeline = T.build_pipeline(*ops)
    plan = kbr.build_plan(pipeline)
    assert plan.ops[0, 2] == 0  # stride 0: one scalar for every channel
    check_float(kbr.run(pipeline, plan, CPU).numpy(), _run(*ops), tol=0, msg="len-1 scalar")


# --- test_arithmetic.py ----------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("src_dtype", [np.uint8, np.uint16, np.int16, np.float32])
def test_convert_sub_mul_div_chain(rng, channels, src_dtype):
    if np.issubdtype(src_dtype, np.integer):
        info = np.iinfo(src_dtype)
        img = rng.integers(max(info.min, -1000), min(info.max, 1000) + 1,
                           size=(45, 77, channels)).astype(src_dtype)
    else:
        img = (rng.random((45, 77, channels), dtype=np.float32) * 255).astype(src_dtype)
    alpha = 0.3
    sub = tuple(np.linspace(1.0, 4.0, channels))
    div = tuple(np.linspace(2.0, 8.0, channels))
    ops = (T.image(img), T.convert_to(np.float32, alpha=alpha), T.subtract(sub), T.divide(div))
    out = _run(*ops)
    f = cv2.addWeighted(img, alpha, img, 0.0, 0.0, dtype=cv2.CV_32F).reshape(img.shape)
    f = cv2.subtract(f, np.array(sub, np.float64))
    f = cv2.divide(f, np.array(div, np.float64)).reshape(img.shape)
    check_float(out, f, msg="normalize chain")
    pipeline = T.build_pipeline(*ops)
    check_float(kp.run(pipeline, kp.build_plan(pipeline), CPU).numpy(), out, tol=0)


@pytest.mark.parametrize("op,cvfn", [("multiply", cv2.multiply), ("add", cv2.add),
                                     ("subtract", cv2.subtract)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_integer_saturating_arith(rng, op, cvfn, dtype):
    info = np.iinfo(dtype)
    img = rng.integers(info.min, info.max + 1, size=(33, 41, 3)).astype(dtype)
    val = (100.0, 200.0, 50.0)
    out = _run(T.image(img), getattr(T, op)(val))
    check_exact(out, cvfn(img, np.array(val, np.float64)).reshape(img.shape), f"{op} {dtype}")
    assert out.dtype == dtype


def test_split_single(rng):
    img = rng.integers(0, 256, (45, 77, 3)).astype(np.uint8)
    outs = _run(T.image(img), T.split())
    assert len(outs) == 3
    for got, ref in zip(outs, cv2.split(img)):
        check_exact(got, ref, "split plane")


def test_split_batch(rng):
    batch = rng.integers(0, 256, (10, 45, 77, 3)).astype(np.uint8)
    outs = _run(T.image(batch), T.split())
    assert len(outs) == 3 and outs[0].shape == (10, 45, 77)
    for z in (0, 9):
        for c, ref in enumerate(cv2.split(batch[z])):
            check_exact(outs[c][z], ref, f"batch split z={z} c={c}")


def test_split_tensor_layouts(rng):
    batch = rng.integers(0, 256, (5, 8, 9, 3)).astype(np.uint8)
    planar = _run(T.image(batch), T.split_tensor())
    transposed = _run(T.image(batch), T.split_tensor_transposed())
    packed = _run(T.image(batch), T.write_tensor())
    assert planar.shape == (5, 3, 8, 9) and transposed.shape == (3, 5, 8, 9)
    check_exact(planar, batch.transpose(0, 3, 1, 2), "TensorSplit")
    check_exact(transposed, batch.transpose(3, 0, 1, 2), "TensorTSplit")
    check_exact(packed, batch, "TensorWrite")


def test_static_loop_mad_chain(rng):
    img = rng.random((16, 128), dtype=np.float32)
    mad = T.fuse(T.multiply(1.001), T.add(0.001))
    loop = T.static_loop(T.static_loop(mad, 10), 10)
    out = _run(T.image(img[..., None]), loop)[..., 0]
    ref = img.copy()
    for _ in range(100):
        ref = ref * np.float32(1.001) + np.float32(0.001)
    check_float(out, ref, tol=0, msg="MAD loop x100: each op rounded once")


def test_vector_reorder(rng):
    img = rng.integers(0, 256, (45, 77, 4)).astype(np.uint8)
    check_exact(_run(T.image(img), T.vector_reorder(2, 1, 0, 3)), img[..., [2, 1, 0, 3]],
                "VectorReorder<2,1,0,3>")


# --- test_convert_to.py ----------------------------------------------------------

DEPTHS = [np.uint8, np.int8, np.uint16, np.int16, np.int32, np.float32]
CV_DEPTH = {np.uint8: cv2.CV_8U, np.int8: cv2.CV_8S, np.uint16: cv2.CV_16U, np.int16: cv2.CV_16S,
            np.int32: cv2.CV_32S, np.float32: cv2.CV_32F, np.float64: cv2.CV_64F}


def _rand_img(rng, dtype, channels, h=37, w=61):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        lo, hi = max(info.min, -4000), min(info.max, 4000)
        return rng.integers(lo, hi + 1, size=(h, w, channels)).astype(dtype)
    return (rng.random((h, w, channels), dtype=np.float32) * 200 - 100).astype(dtype)


def _cv_convert_to(src, dst_dtype, alpha=1.0, beta=0.0):
    return cv2.addWeighted(src, alpha, src, 0.0, beta, dtype=CV_DEPTH[dst_dtype])


@pytest.mark.parametrize("src_dtype", DEPTHS)
@pytest.mark.parametrize("dst_dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("channels", [1, 3])
def test_plain_saturate_cast(rng, src_dtype, dst_dtype, channels):
    img = _rand_img(rng, src_dtype, channels)
    out = _run(T.image(img), T.convert_to(dst_dtype))
    ref = _cv_convert_to(img, dst_dtype).reshape(img.shape)
    if np.issubdtype(dst_dtype, np.integer):
        check_exact(out, ref, f"{src_dtype}->{dst_dtype}")
    else:
        check_float(out, ref, msg=f"{src_dtype}->{dst_dtype}")
    assert out.dtype == dst_dtype
    # every depth here runs in the pointwise kernel (int32 held as its bits)
    assert kp.supports(T.build_pipeline(T.image(img), T.convert_to(dst_dtype)))


@pytest.mark.parametrize("src_dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_alpha_to_float(rng, src_dtype, channels):
    img = _rand_img(rng, src_dtype, channels)
    out = _run(T.image(img), T.convert_to(np.float32, alpha=0.3))
    check_float(out, _cv_convert_to(img, np.float32, alpha=0.3).reshape(img.shape),
                msg=f"{src_dtype} alpha=0.3")
    assert out.dtype == np.float32


@pytest.mark.parametrize("src_dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("alpha,beta", [(0.25, 3.5), (1.5, -2.0), (2.0, 0.5)])
def test_alpha_beta_to_int(rng, src_dtype, alpha, beta):
    img = _rand_img(rng, src_dtype, 3)
    ops = (T.image(img), T.convert_to(np.int16, alpha=alpha, beta=beta))
    out = _run(*ops)
    check_exact(out, _cv_convert_to(img, np.int16, alpha=alpha, beta=beta).reshape(img.shape),
                f"{src_dtype} a={alpha} b={beta}")
    pipeline = T.build_pipeline(*ops)
    check_exact(kp.run(pipeline, kp.build_plan(pipeline), CPU).numpy(), out, "plain version")


def test_saturation_extremes():
    img = np.array([[[-300.7, 255.5, 254.5], [256.5, -0.5, 1000.0]]], np.float32)
    check_exact(_run(T.image(img), T.convert_to(np.uint8)),
                _cv_convert_to(img, np.uint8).reshape(img.shape), "saturation extremes")


def test_round_half_to_even():
    img = np.array([[[0.5, 1.5, 2.5], [3.5, -1.5, -2.5]]], np.float32)
    check_exact(_run(T.image(img), T.convert_to(np.int16)),
                _cv_convert_to(img, np.int16).reshape(img.shape), "cvRound banker's rounding")


# --- test_graph.py ---------------------------------------------------------------


def test_then_composition_types(rng):
    img = rng.random((8, 8, 3), dtype=np.float32)
    m, a = T.multiply(2.0), T.add(1.0)
    fused = m.then(a)
    assert isinstance(fused, FusedCompute) and len(fused.ops) == 2
    read = T.image(img).then(fused)
    assert isinstance(read, FusedRead) and len(read.chain) == 2
    read2 = T.fuse(T.image(img), m, a)
    assert isinstance(read2, FusedRead)
    check_float(_run(read2), img * 2.0 + 1.0, msg="fused read chain")
    with pytest.raises(TypeError):
        T.write().then(m)


def test_fused_param_access():
    chain = T.fuse(T.multiply(3.0), T.add(4.0))
    assert float(chain.ops[0].value) == 3.0 and float(chain.ops[1].value) == 4.0


def test_param_change_does_not_recompile(rng):
    executor.clear_cache()
    img1 = rng.random((16, 16, 3), dtype=np.float32)
    img2 = rng.random((16, 16, 3), dtype=np.float32)
    out1 = _run(T.image(img1), T.multiply(2.0))
    n_after_first = len(executor._PLANS)
    out2 = _run(T.image(img2), T.multiply(5.0))
    assert len(executor._PLANS) == n_after_first, "a new value must find the plan"
    check_float(out1, img1 * 2.0)
    check_float(out2, img2 * 5.0)
    _run(T.image(img1), T.multiply(2.0), T.add(1.0))
    assert len(executor._PLANS) == n_after_first + 1


def test_ops_are_pytrees():
    """``flatten`` and ``map_leaves`` are the port's tree functions."""
    op = T.fuse(T.multiply((1.0, 2.0, 3.0)), T.add(0.5))
    key, leaves = flatten(op)
    assert len(leaves) == 2
    rebuilt = map_leaves(op, lambda v: v)
    assert isinstance(rebuilt, FusedCompute) and flatten(rebuilt)[0] == key


def test_single_program_compilation(rng):
    """The whole chain is one program: one plan, and on a card one launch of
    one kernel (decided from the structure)."""
    img = rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)
    ops = (T.image(img), T.convert_to(np.float32, 0.5), T.subtract((1.0, 2.0, 3.0)),
           T.divide(2.0), T.split_tensor())
    pipeline = T.build_pipeline(*ops)
    assert executor._select(pipeline, T.ParBackend.AUTO, CUDA).backend == "cuda:pointwise"
    assert kp.build_plan(pipeline).ops.shape[0] == 3
    assert _run(*ops).shape == (3, 32, 32)


def test_pending_geometry_ops(rng):
    frame = rng.integers(0, 255, (64, 96, 3)).astype(np.uint8)
    read = T.image(frame).then(T.crop(T.Rect(8, 4, 32, 16))).then(T.resize(T.Size(16, 8)))
    ref = _run(T.resize(T.crop(frame, T.Rect(8, 4, 32, 16)), T.Size(16, 8)))
    check_float(_run(read), ref, tol=0)
    out2 = _run(T.image(frame), T.vector_reorder(2, 1, 0), T.resize(dsize=T.Size(16, 8)),
                T.multiply(2.0))
    ref2 = _run(T.resize(T.fuse(T.image(frame), T.vector_reorder(2, 1, 0)), T.Size(16, 8)),
                T.multiply(2.0))
    check_float(out2, ref2, tol=0)
    check_float(out2, _ref(J.image(frame), J.vector_reorder(2, 1, 0),
                           J.resize(dsize=J.Size(16, 8)), J.multiply(2.0)),
                msg="against the reference")


def test_set_to():
    x = T.set_to(3.5, (4, 5, 2), device="cpu")
    assert tuple(x.shape) == (4, 5, 2) and float(x[0, 0, 0]) == 3.5


# --- test_packed.py --------------------------------------------------------------
# The reference packs host arrays into (H, W*C) rows at the factory because a
# relayout costs a copy on the TPU; the port reads (H, W, C) and packed rows
# alike, so its factories pack nothing and `channels=` declares packed rows.


def test_image_keeps_host_arrays_as_they_are(rng):
    img = rng.integers(0, 256, (16, 32, 3)).astype(np.uint8)
    read = T.image(img)
    assert isinstance(read, ImageRead) and read.packed_channels == 0
    assert read.data.shape == (16, 32, 3)
    assert np.array_equal(np.asarray(read.lower()), np.asarray(J.image(img).lower()))


def test_image_batched(rng):
    batch = rng.integers(0, 256, (4, 8, 16, 3)).astype(np.uint8)
    read = T.image(batch)
    assert read.is_batch and np.array_equal(np.asarray(read.lower()), batch)
    assert np.array_equal(np.asarray(J.image(batch).lower()), batch)


def test_grayscale_not_packed(rng):
    img = rng.integers(0, 256, (16, 32)).astype(np.uint8)
    assert T.image(img).packed_channels == 0 and J.image(img).packed_channels == 0


def test_image_channels_kwarg_prepacked(rng):
    img = rng.integers(0, 256, (16, 32, 3)).astype(np.uint8)
    packed = img.reshape(16, 96)
    read = T.image(packed, channels=3)
    assert read.packed_channels == 3 and not read.is_batch
    assert np.array_equal(map_leaves(read, torch.as_tensor).lower().numpy(), img)
    read_dev = T.image(torch.from_numpy(packed), channels=3)
    assert read_dev.packed_channels == 3 and np.array_equal(read_dev.lower().numpy(), img)
    with pytest.raises(ValueError):
        T.image(packed[:, :95], channels=3)


def test_resize_batch_of_a_frame(rng):
    frame = rng.integers(0, 256, (64, 128, 3)).astype(np.uint8)
    rects = np.array([[0, 0, 32, 16], [8, 8, 32, 16]], np.int32)
    read = T.resize_batch(frame, rects=rects, dsize=T.Size(16, 8))
    assert isinstance(read, BatchResizeRead) and read.source_dims() == (64, 128, 3)
    assert J.resize_batch(frame, rects=rects, dsize=J.Size(16, 8)).source_dims() == (64, 128, 3)


def test_packed_pipeline_matches_cv2(rng):
    frame = rng.integers(0, 256, (96, 160, 3)).astype(np.uint8)
    rects = np.array([[i, i, 40, 48] for i in range(6)], np.int32)
    ops = (T.resize_batch(frame, rects=rects, dsize=T.Size(32, 64)),
           T.convert_to(np.float32, alpha=0.5), T.split_tensor())
    out = _run(*ops)
    for z, (x, y, w, h) in enumerate(rects):
        crop = frame[y:y + h, x:x + w].astype(np.float32)
        ref = cv2.resize(crop, (32, 64), interpolation=cv2.INTER_LINEAR) * 0.5
        check_float(out[z], ref.transpose(2, 0, 1), tol=1e-5, msg=f"packed plane {z}")
    pipeline = T.build_pipeline(*ops)
    check_float(kbr.run(pipeline, kbr.build_plan(pipeline), CPU).numpy(), out, tol=0,
                msg="the kernel's plain version == eager")


def test_packed_stack_mode(rng):
    imgs = [rng.integers(0, 256, (24 + 8 * i, 40, 3)).astype(np.uint8) for i in range(3)]
    read = T.resize_batch(imgs, dsize=T.Size(16, 16))
    assert read.stack.shape == (3, 40, 40, 3)
    out = _run(read, T.convert_to(np.float32))
    for z, im in enumerate(imgs):
        ref = cv2.resize(im.astype(np.float32), (16, 16), interpolation=cv2.INTER_LINEAR)
        check_float(out[z], ref, tol=1e-5, msg=f"stack plane {z}")


# --- test_batchresize_sweep.py ---------------------------------------------------

UP = (32, 64)


def _frame(rng, dtype, ch):
    shape = (296, 384, ch)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, min(np.iinfo(dtype).max, 4096) + 1, shape).astype(dtype)
    return (rng.random(shape, dtype=np.float32) * 255).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.int32, np.float32,
                                   np.float64])
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_type_sweep_eager_and_kernel_plan(rng, dtype, ch):
    """Every supported depth and channel count through the eager path against
    cv2; the batched kernel takes every one (a float64 frame as float32, the
    dtype it takes where it enters, as in the reference), and its plain
    version equals the eager path bit for bit."""
    frame = _frame(rng, dtype, ch)
    rects = np.array([[i, 2 * i, 40, 56] for i in range(4)], np.int32)
    ops = (T.resize_batch(frame, rects=rects, dsize=T.Size(*UP), channels=ch), T.multiply(0.5),
           T.split_tensor())
    x = _run(*ops)
    assert x.shape == (4, ch, UP[1], UP[0])
    for z in range(4):
        xx, y, w, h = rects[z]
        crop = frame[y:y + h, xx:xx + w].astype(np.float32)
        ref = cv2.resize(crop, UP, interpolation=cv2.INTER_LINEAR).reshape(UP[1], UP[0], ch)
        check_float(x[z], (ref * np.float32(0.5)).transpose(2, 0, 1), msg=f"{dtype} c{ch} z={z}")
    pipeline = T.build_pipeline(*ops)
    assert x.dtype == np.float32 and kbr.supports(pipeline)
    check_float(kbr.run(pipeline, kbr.build_plan(pipeline), CPU).numpy(), x, tol=0)


def test_batch_300_stress(rng):
    frame = _frame(rng, np.uint8, 3)
    rects = np.array([[i % 200, i % 150, 30, 40] for i in range(300)], np.int32)
    out = _run(T.resize_batch(frame, rects=rects, dsize=T.Size(16, 16)))
    assert out.shape == (300, 16, 16, 3)
    x, y, w, h = rects[123]
    check_float(out[123], cv2.resize(frame[y:y + h, x:x + w].astype(np.float32), (16, 16)),
                msg="batch300 plane 123")


def test_batch_size_change_no_recompile(rng):
    frame = _frame(rng, np.uint8, 3)
    executor.clear_cache()
    for shift in range(3):
        rects = np.array([[i + shift, i, 20, 24] for i in range(8)], np.int32)
        _run(T.resize_batch(frame, rects=rects, dsize=T.Size(8, 8)))
    assert len(executor._PLANS) == 1
    _run(T.resize_batch(frame, rects=rects[:5], dsize=T.Size(8, 8)))
    assert len(executor._PLANS) == 2  # another N is another structure


# --- test_backend_select.py ------------------------------------------------------


def _flagship_ops(frame, rects):
    return [T.resize_batch(frame, rects=rects, dsize=T.Size(64, 128)),
            T.convert_to(np.float32, alpha=0.3), T.subtract((3.2, 0.6, 11.8)),
            T.divide((128.0, 128.0, 128.0)), T.split_tensor()]


def _backend_on(dev, *ops, backend=T.ParBackend.AUTO):
    return executor._select(T.build_pipeline(*ops), backend, dev).backend


def test_flagship_reports_batch_resize_kernel(rng):
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[i, i, 60, 120] for i in range(10)], np.int32)
    assert _backend_on(CUDA, *_flagship_ops(frame, rects)) == "cuda:batch_resize"
    assert T.describe_backend(*_flagship_ops(frame, rects), device="cpu") == "torch"


def test_odd_height_frame_has_no_cliff(rng):
    """The TPU kernel's 8-row gate has no counterpart: any frame size the
    eager path takes, the frame kernel takes."""
    img = rng.integers(0, 256, (1080, 1920, 3)).astype(np.uint8)

    def ops(im):
        return [T.resize(T.image(im), T.Size(640, 360)), T.convert_to(np.float32, alpha=1 / 255.0),
                T.split_tensor()]

    assert _backend_on(CUDA, *ops(img)) == "cuda:frame_resize"
    assert _backend_on(CUDA, *ops(img[:-1])) == "cuda:frame_resize"
    assert kfr.supports(T.build_pipeline(*ops(img[:-1, :-3])))


def test_small_frame_has_no_profitability_gate(rng):
    img = rng.integers(0, 256, (128, 128, 3)).astype(np.uint8)
    ops = [T.resize(T.image(img), T.Size(64, 64)), T.convert_to(np.float32, alpha=1 / 255.0),
           T.split_tensor()]
    assert _backend_on(CUDA, *ops) == "cuda:frame_resize"
    assert _backend_on(CUDA, *ops, backend=T.ParBackend.CUDA) == "cuda:frame_resize"


def test_warp_reports_warp_kernel(rng):
    img = rng.integers(0, 256, (1080, 1920, 3)).astype(np.uint8)
    m = np.array([[0.55, 0.0, 23.0], [0.0, 0.62, 11.0]], np.float32)
    ops = [T.warp(T.image(img), m, T.Size(640, 360)), T.convert_to(np.float32, alpha=1 / 255.0),
           T.split_tensor()]
    assert _backend_on(CUDA, *ops) == "cuda:warp"


def test_last_backend_records_torch_on_cpu(rng):
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[i, i, 60, 120] for i in range(10)], np.int32)
    _run(*_flagship_ops(frame, rects))
    assert T.last_backend() == "torch"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _run(*_flagship_ops(frame, rects), backend=T.ParBackend.CUDA)


def test_explicit_cuda_names_every_kernels_refusal(rng):
    """``ParBackend.CUDA`` raises with each kernel's reason, the pointwise
    kernel's last, for a source no kernel reads (uint32). An int64 image is
    int32's where it enters, as in the reference: one launch of the
    pointwise kernel."""
    img = rng.integers(0, 256, (16, 16, 3)).astype(np.int64)
    assert _backend_on(CUDA, T.image(img), T.multiply(2.0),
                       backend=T.ParBackend.CUDA) == "cuda:pointwise"
    with pytest.raises(ValueError) as e:
        _backend_on(CUDA, T.image(img.astype(np.uint32)), T.multiply(2.0),
                    backend=T.ParBackend.CUDA)
    msg = str(e.value)
    order = [msg.index(k) for k in ("cuda:batch_resize:", "cuda:frame_resize:", "cuda:warp:",
                                    "cuda:pointwise:")]
    assert order == sorted(order) and "source dtype uint32" in msg
