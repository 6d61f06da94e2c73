"""Every dtype a TPU kernel takes, in the port's kernels: uint8, int8,
uint16, int16, float16 and float32 sources, chains and stores.

Three parts:

- the routing: for each pipeline of the probe table (a resampling head of
  every source dtype, a uint8 head whose chain runs through another dtype,
  an image converted to float16) the JAX package's ``describe_backend`` on a
  TPU and the port's selection on a CUDA device. Where the reference names
  a Pallas emitter the port names its counterpart; where it runs one XLA
  program the port still runs one kernel;
- the numerics: each kernel head (``resize_batch``, ``resize``, the three
  warp classes, the divergent D1 and D3 sequences, the pointwise image,
  ring, crop and border heads) x source dtype x chain dtype, built with the
  JAX factories and carried across with ``from_jax``. The port's plain
  version (what each kernel is held against on the card) must equal the
  reference's op-by-op lowering (``Pipeline.lower()`` under
  ``jax.disable_jit()``) bit for bit;
- the encoder: the rows and store modes the kernels read (``encode_chain``,
  ``store_cast``).

Inputs are made from a seed with numpy, at small sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu.exec import executor as JE
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # only named: the routing is decided on shapes and dtypes
D = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16, "i16": np.int16, "f16": np.float16,
     "f32": np.float32}
D32 = {**D, "i32": np.int32}  # int32 has its own file of cases (test_torch_int32.py)
# int64 and float64 have theirs too (test_torch_x64.py); the probe table's rows
D64 = {**D32, "i64": np.int64, "f64": np.float64}
NEW = ("i8", "u16", "i16", "f16")  # the source dtypes this port's resampling kernels added
# a scale that brings each source dtype's values to a few hundred
ALPHA = {"u8": 0.5, "i8": 1.5, "u16": 1 / 128.0, "i16": 1 / 96.0, "f16": 0.25, "f32": 0.5}


def _src(shape, name, seed=0):
    """Values over the whole range of an integer dtype; float values of a
    few hundred, both signs, exact in float16."""
    rng = np.random.default_rng(seed)
    dtype = D64[name]
    if name in ("f16", "f32", "f64"):
        return (rng.integers(-400, 2400, shape) / 8.0).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, shape).astype(dtype)


def _chain(M, src, dst):
    """``convert_to`` the chain's dtype, then a multiply, a subtract and a
    divide in it: an integer saturates after each op, float16 rounds."""
    return (M.convert_to(D[dst], alpha=ALPHA[src]), M.multiply(0.3), M.subtract(0.51),
            M.divide(0.23))


# ---------------------------------------------------------------------------
# the probe table: which kernel each package runs
# ---------------------------------------------------------------------------

RECTS = np.array([[8 * i, 4 * i, 60, 80] for i in range(4)], np.int32)
SEPARABLE = np.array([[0.5, 0.0, 3.0], [0.0, 0.6, 2.0]])
GENERAL = np.array([[0.9, 0.3, 3.0], [-0.3, 0.9, 20.0]])
PERSPECTIVE = np.array([[0.9, 0.01, 3.0], [0.02, 0.95, 2.0], [1e-4, 2e-4, 1.0]])
COUNTERPART = {"pallas:batch_resize": "cuda:batch_resize", "pallas:frame": "cuda:frame_resize",
               "pallas:warp": "cuda:warp", "pallas:warp_general": "cuda:warp",
               "pallas:warp_universal": "cuda:warp"}


def _probe_rows():
    """``{name: (ops of M, the port's kernel)}`` over a 256x384x3 frame."""
    rows = {}

    def frame(name):
        return _src((256, 384, 3), name, 7)

    for s in NEW:
        rows[f"resize_batch_{s}"] = ("cuda:batch_resize", lambda M, s=s: (
            M.resize_batch(frame(s), rects=RECTS, dsize=M.Size(64, 128)),
            M.convert_to(np.float32, alpha=0.5), M.split_tensor()))
        rows[f"resize_{s}_split"] = ("cuda:frame_resize", lambda M, s=s: (
            M.resize(M.image(frame(s)), M.Size(128, 72)), M.convert_to(np.float32, alpha=0.5),
            M.split()))
        rows[f"warp_separable_{s}"] = ("cuda:warp", lambda M, s=s: (
            M.warp(M.image(frame(s)), SEPARABLE, M.Size(128, 72)),
            M.convert_to(np.float32, alpha=0.5), M.split_tensor()))
        rows[f"u8_resize_batch_to_{s}"] = ("cuda:batch_resize", lambda M, s=s: (
            M.resize_batch(frame("u8"), rects=RECTS, dsize=M.Size(64, 128)),
            M.convert_to(D[s], alpha=0.5), M.split_tensor()))
        rows[f"u8_warp_separable_to_{s}"] = ("cuda:warp", lambda M, s=s: (
            M.warp(M.image(frame("u8")), SEPARABLE, M.Size(128, 72)), M.convert_to(D[s]),
            M.split_tensor()))
    for s in ("i16", "u16", "f16"):
        rows[f"u8_resize_batch_{s}_chain_to_f32"] = ("cuda:batch_resize", lambda M, s=s: (
            M.resize_batch(frame("u8"), rects=RECTS, dsize=M.Size(64, 128)), M.convert_to(D[s]),
            M.multiply(0.3), M.subtract(0.51), M.divide(0.23), M.convert_to(np.float32),
            M.split_tensor()))
        rows[f"u8_resize_to_{s}_split"] = ("cuda:frame_resize", lambda M, s=s: (
            M.resize(M.image(frame("u8")), M.Size(128, 72)), M.convert_to(D[s], alpha=0.5),
            M.split()))
    rows["warp_general_i8"] = ("cuda:warp", lambda M: (
        M.warp(M.image(frame("i8")), GENERAL, M.Size(128, 72)),
        M.convert_to(np.float32, alpha=0.5), M.split_tensor()))
    rows["warp_perspective_i8"] = ("cuda:warp", lambda M: (
        M.warp(M.image(frame("i8")), PERSPECTIVE, M.Size(128, 72),
               warp_type=M.WarpType.PERSPECTIVE),
        M.convert_to(np.float32, alpha=0.5), M.split_tensor()))
    rows["image_to_f16"] = ("cuda:pointwise", lambda M: (
        M.image(frame("u8")), M.convert_to(np.float16, alpha=0.5), M.write()))
    # int32: a source, a chain and an output, each in one kernel
    rows["resize_batch_i32"] = ("cuda:batch_resize", lambda M: (
        M.resize_batch(frame("i32"), rects=RECTS, dsize=M.Size(64, 128)),
        M.convert_to(np.float32, alpha=0.5), M.split_tensor()))
    rows["u8_resize_batch_to_i32_mul"] = ("cuda:batch_resize", lambda M: (
        M.resize_batch(frame("u8"), rects=RECTS, dsize=M.Size(64, 128)), M.convert_to(np.int32),
        M.multiply(3.0), M.split_tensor()))
    rows["resize_i32_split"] = ("cuda:frame_resize", lambda M: (
        M.resize(M.image(frame("i32")), M.Size(128, 72)), M.convert_to(np.float32, alpha=0.5),
        M.split()))
    rows["warp_separable_i32"] = ("cuda:warp", lambda M: (
        M.warp(M.image(frame("i32")), SEPARABLE, M.Size(128, 72)),
        M.convert_to(np.float32, alpha=0.5), M.split_tensor()))
    rows["u8_warp_separable_to_i32"] = ("cuda:warp", lambda M: (
        M.warp(M.image(frame("u8")), SEPARABLE, M.Size(128, 72)), M.convert_to(np.int32),
        M.split_tensor()))
    rows["warp_general_i32"] = ("cuda:warp", lambda M: (
        M.warp(M.image(frame("i32")), GENERAL, M.Size(128, 72)), M.convert_to(np.float32),
        M.split_tensor()))
    rows["warp_perspective_i32"] = ("cuda:warp", lambda M: (
        M.warp(M.image(frame("i32")), PERSPECTIVE, M.Size(128, 72),
               warp_type=M.WarpType.PERSPECTIVE), M.convert_to(np.int32), M.split_tensor()))
    rows["warp_batch_i32"] = ("cuda:warp", lambda M: (
        M.warp_batch([frame("i32")] * 2, [SEPARABLE, GENERAL], M.Size(128, 72)),
        M.convert_to(np.float32), M.split_tensor()))
    rows["image_i32"] = ("cuda:pointwise", lambda M: (
        M.image(frame("i32")), M.multiply(2.0), M.write()))
    rows["image_u8_to_i32_gray"] = ("cuda:pointwise", lambda M: (
        M.image(frame("u8")), M.convert_to(np.int32, alpha=1e6),
        M.cvt_color(M.ColorConversionCode.COLOR_RGB2GRAY), M.write()))
    # int64 and float64: int32 and float32 where they enter, as in the
    # reference; every head runs its kernel
    for s in ("i64", "f64"):
        rows[f"resize_batch_{s}"] = ("cuda:batch_resize", lambda M, s=s: (
            M.resize_batch(frame(s), rects=RECTS, dsize=M.Size(64, 128)),
            M.convert_to(np.float32, alpha=0.5), M.split_tensor()))
        rows[f"resize_{s}_split"] = ("cuda:frame_resize", lambda M, s=s: (
            M.resize(M.image(frame(s)), M.Size(128, 72)), M.convert_to(np.float32, alpha=0.5),
            M.split()))
        rows[f"warp_separable_{s}"] = ("cuda:warp", lambda M, s=s: (
            M.warp(M.image(frame(s)), SEPARABLE, M.Size(128, 72)),
            M.convert_to(np.float32, alpha=0.5), M.split_tensor()))
        rows[f"warp_general_{s}"] = ("cuda:warp", lambda M, s=s: (
            M.warp(M.image(frame(s)), GENERAL, M.Size(128, 72)), M.convert_to(np.float32),
            M.split_tensor()))
        rows[f"warp_batch_{s}"] = ("cuda:warp", lambda M, s=s: (
            M.warp_batch([frame(s)] * 2, [SEPARABLE, GENERAL], M.Size(128, 72)),
            M.convert_to(np.float32), M.split_tensor()))
        rows[f"image_{s}"] = ("cuda:pointwise", lambda M, s=s: (
            M.image(frame(s)), M.multiply(2.0), M.write()))
        rows[f"crop_border_{s}"] = ("cuda:pointwise", lambda M, s=s: (
            M.make_border(M.crop(M.image(frame(s)), M.Rect(-200, 10, 160, 90)), 4, 4, 4, 4,
                          M.BorderMode.CONSTANT, value=(3e9, -9.0, 0.5)), M.write()))
    rows["u8_resize_batch_to_f64"] = ("cuda:batch_resize", lambda M: (
        M.resize_batch(frame("u8"), rects=RECTS, dsize=M.Size(64, 128)),
        M.convert_to(np.float64, alpha=0.5), M.split_tensor()))
    rows["u8_resize_to_f64_split"] = ("cuda:frame_resize", lambda M: (
        M.resize(M.image(frame("u8")), M.Size(128, 72)), M.convert_to(np.float64, alpha=0.5),
        M.split()))
    rows["image_u8_to_f64"] = ("cuda:pointwise", lambda M: (
        M.image(frame("u8")), M.convert_to(np.float64, alpha=0.5), M.write()))
    return rows


PROBE = _probe_rows()


@pytest.mark.parametrize("row", sorted(PROBE))
def test_every_row_of_the_probe_table_runs_in_one_kernel(row):
    """The reference's choice on a TPU beside the port's on a CUDA device:
    a Pallas emitter's counterpart, and one kernel where the reference runs
    one XLA program; ``ParBackend.CUDA`` takes the same kernel."""
    kernel, ops = PROBE[row]
    jax_name = JE.describe_backend(*ops(J), backend=J.ParBackend.PALLAS, platform="tpu")
    pipeline = from_jax(J.build_pipeline(*ops(J)))
    port = executor._select(pipeline, T.ParBackend.AUTO, CUDA).backend
    assert port == kernel
    assert executor._select(pipeline, T.ParBackend.CUDA, CUDA).backend == kernel
    if jax_name.startswith("pallas:"):
        assert COUNTERPART[jax_name] == port, (jax_name, port)
    else:
        assert jax_name == "xla", jax_name


def test_the_probe_tables_pallas_rows():
    """The rows the reference runs as a Pallas kernel on a TPU, by emitter:
    every source dtype of each resampling head, and the uint8 heads whose
    chain runs through int16, uint16 or float16 behind a crop resize."""
    names = {row: JE.describe_backend(*ops(J), backend=J.ParBackend.PALLAS, platform="tpu")
             for row, (_, ops) in PROBE.items()}
    for s in NEW:
        assert names[f"resize_batch_{s}"] == "pallas:batch_resize"
        assert names[f"resize_{s}_split"] == "pallas:frame"
        assert names[f"warp_separable_{s}"] == "pallas:warp"
    for s in ("i16", "u16", "f16"):
        assert names[f"u8_resize_batch_{s}_chain_to_f32"] == "pallas:batch_resize"
    assert names["warp_general_i8"] == names["warp_perspective_i8"] == "pallas:warp_universal"
    # int32: the reference's Pallas kernels take it as a source and a chain
    assert names["resize_batch_i32"] == names["u8_resize_batch_to_i32_mul"] == \
        "pallas:batch_resize"
    assert names["resize_i32_split"] == "pallas:frame"
    assert names["warp_separable_i32"] == names["u8_warp_separable_to_i32"] == "pallas:warp"
    # int64 and float64: the reference's kernels take them as int32 and
    # float32, the dtypes its dispatch makes of them (64-bit values off)
    for s in ("i64", "f64"):
        assert names[f"resize_batch_{s}"] == "pallas:batch_resize"
        assert names[f"resize_{s}_split"] == "pallas:frame"
        assert names[f"warp_separable_{s}"] == "pallas:warp"
    assert names["u8_resize_batch_to_f64"] == "pallas:batch_resize"
    assert names["u8_resize_to_f64_split"] == "pallas:frame"


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_what_an_f32_register_cannot_hold_stays_eager(dtype):
    """int64 and float64, which a 32-bit register cannot hold, never reach
    one: the reference runs with 64-bit values off, so they are int32 and
    float32 where they enter, and nothing of them stays eager. A 64-bit
    tensor is a source the kernels read at load, a host frame is its
    canonical dtype's, a cast to either is a cast to int32 or float32 (a
    saturating one to int64 raises, as the reference's call does). What no
    kernel reads (a uint32 source) stays eager, and ``ParBackend.CUDA`` says
    why, naming each kernel."""
    frame = torch.zeros((32, 48, 3), dtype=dtype)
    canonical = {torch.int64: torch.int32, torch.float64: torch.float32}[dtype]
    for src, plan_dtype in ((frame, dtype), (frame.numpy(), canonical)):
        pipeline = T.build_pipeline(T.resize_batch(src, rects=RECTS, dsize=T.Size(16, 16)),
                                    T.split_tensor())
        plan = executor._select(pipeline, T.ParBackend.CUDA, CUDA)
        assert plan.backend == "cuda:batch_resize" and plan.kernel.src_dtype == plan_dtype
    cast = T.Cast(dst=dtype) if dtype == torch.int64 else T.convert_to(np.float64)
    pipeline = T.build_pipeline(T.image(torch.zeros((32, 48, 3), dtype=torch.uint8)), cast,
                                T.write())
    plan = executor._select(pipeline, T.ParBackend.AUTO, CUDA)
    assert plan.backend == "cuda:pointwise" and plan.kernel.out_dtype == canonical
    if dtype == torch.int64:
        with pytest.raises(OverflowError):
            T.convert_to(np.int64)
    pipeline = T.build_pipeline(T.resize_batch(frame.to(torch.uint32), rects=RECTS,
                                               dsize=T.Size(16, 16)), T.split_tensor())
    assert executor._select(pipeline, T.ParBackend.AUTO, CUDA).backend == "torch"
    with pytest.raises(ValueError, match="cuda:batch_resize: .*cuda:pointwise: "):
        executor._select(pipeline, T.ParBackend.CUDA, CUDA)


# ---------------------------------------------------------------------------
# the numerics: the port's plain versions against the reference op by op
# ---------------------------------------------------------------------------


def _lowered(jp):
    with jax.disable_jit():
        out = jp.lower()
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o) for o in out]


def _hold(module, jops, ids=None):
    """The port's plain version (through the kernel's wrapper on CPU
    tensors) against the reference's op-by-op lowering, bit for bit; returns
    the plan."""
    if ids is None:
        jp = J.build_pipeline(*jops)
        p = from_jax(jp)
        plan = module.build_plan(p)
        got = module.run(p, plan, CPU)
        want = _lowered(jp)
    else:
        seqs = tuple(from_jax(J.build_pipeline(*ops)) for ops in jops)
        plan = kd.build_plan(seqs, ids)
        got = kd.run(seqs, plan, CPU)
        with jax.disable_jit():
            want = JE.launch_divergent_batch(list(ids), *(J.build_pipeline(*o) for o in jops),
                                             backend=J.ParBackend.XLA)
        want = [np.asarray(w) for w in (want if isinstance(want, (tuple, list)) else (want,))]
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype, w.shape)
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), \
            f"{int((g != w).sum())} of {g.size} values differ"
    return plan


HEADS = {
    "resize_batch": (kbr, lambda M, a: (
        M.resize_batch(a((24, 36, 3)), rects=np.array([[1, 2, 20, 14], [9, 5, 13, 17],
                                                      [-3, 4, 12, 10]], np.int32),
                       dsize=M.Size(12, 10)),)),
    "resize": (kfr, lambda M, a: (M.resize(M.image(a((21, 34, 3))), M.Size(13, 9)),)),
    "warp_separable": (kw, lambda M, a: (
        M.warp(M.image(a((20, 30, 3))), np.array([[0.7, 0.0, 1.5], [0.0, 0.8, 0.5]]),
               M.Size(18, 12), default=(3.0, 2.0, 1.0)),)),
    "warp_general": (kw, lambda M, a: (
        M.warp(M.image(a((20, 30, 3))), np.array([[0.8, 0.3, 1.0], [-0.3, 0.8, 8.0]]),
               M.Size(18, 12)),)),
    "warp_perspective": (kw, lambda M, a: (
        M.warp(M.image(a((20, 30, 3))), np.array([[0.9, 0.02, 1.0], [0.03, 0.95, 2.0],
                                                   [1e-3, 2e-3, 1.0]]), M.Size(18, 12),
               warp_type=M.WarpType.PERSPECTIVE),)),
    "pointwise_image": (kp, lambda M, a: (M.image(a((9, 14, 3))),)),
    "pointwise_ring": (kp, lambda M, a: (M.circular_batch_read(a((4, 6, 8, 3)), first=-3),)),
    "pointwise_crop": (kp, lambda M, a: (M.crop(M.image(a((12, 17, 3))), M.Rect(-4, 3, 9, 7)),)),
    # the value a device array: the reference then casts it to the source's
    # dtype by XLA's convert (saturating) also op by op, as its jitted path
    # does; a numpy value would be cast on the host by numpy, which wraps
    "pointwise_border": (kp, lambda M, a: (
        M.make_border(M.image(a((8, 11, 3))), 2, 1, 3, 2, M.BorderMode.CONSTANT,
                      value=jnp.asarray((7.0, 300.5, -9.0), jnp.float32)),)),
}


@pytest.mark.parametrize("chain", list(D))
@pytest.mark.parametrize("src", list(D))
@pytest.mark.parametrize("head", list(HEADS))
def test_every_head_source_and_chain_dtype_equals_the_reference(head, src, chain):
    """Each head over every source dtype, its chain run in every dtype and
    stored in it: the plain version equals the reference op by op."""
    module, read = HEADS[head]
    jops = (*read(J, lambda shape: _src(shape, src, 3)), *_chain(J, src, chain), J.split_tensor())
    plan = _hold(module, jops)
    assert plan.src_dtype == T._dt.to_torch_dtype(D[src])
    assert plan.out_dtype == T._dt.to_torch_dtype(D[chain])


@pytest.mark.parametrize("chain", list(D))
@pytest.mark.parametrize("src", ["u8", "f32"])
@pytest.mark.parametrize("row", ["d1", "d3"])
def test_divergent_sequences_of_every_chain_dtype_equal_the_reference(row, src, chain):
    """The divergent rows D1 (a ring read by two sequences) and D3 (crops
    and an image group) with chains in every dtype: one group's chain ends
    in ``chain``, the other's in float32 or uint8, so the batch stores a
    group of another dtype too, as the merge casts it."""
    ring = _src((6, 7, 9, 3), src, 4)
    if row == "d1":
        read = J.circular_batch_read(ring, first=2)
        jops = ((read, *_chain(J, src, chain), J.write_tensor()),
                (read, J.convert_to(np.float32, alpha=0.5), J.multiply((2.0, 1.0, 0.5)),
                 J.write_tensor()))
        ids = [1, 2] * 3
    else:
        frame = _src((30, 40, 3), src, 5)
        rects = np.array([[2 * z, 3 * z, 20, 14] for z in range(6)], np.int32)
        jops = ((J.resize_batch(frame, rects=rects, dsize=J.Size(9, 7)), *_chain(J, src, chain),
                 J.write_tensor()),
                (J.image(_src((6, 7, 9, 3), src, 6)), J.convert_to(np.uint8, alpha=0.7),
                 J.write_tensor()))
        ids = [1, 1, 2, 1, 2, 1]
    plan = _hold(kd, jops, ids)
    assert plan.out_dtype == T._dt.to_torch_dtype(D[chain])


@pytest.mark.parametrize("chain", ["i8", "u16", "i16", "f16"])
def test_gray_and_alpha_in_every_chain_dtype(chain):
    """A colour conversion on a value of each dtype: the integer fixed point,
    float16's rounded products and sums, an alpha of the dtype's maximum
    (1 for a float)."""
    C = J.ColorConversionCode
    img = _src((9, 13, 3), "u8", 8)
    for conv in (C.COLOR_RGB2GRAY, C.COLOR_BGR2RGBA):
        _hold(kp, (J.image(img), J.convert_to(D[chain], alpha=ALPHA["u8"]), J.cvt_color(conv),
                   J.multiply(1.5), J.write()))
        _hold(kbr, (J.resize_batch(img, rects=np.array([[0, 0, 9, 13]], np.int32),
                                   dsize=J.Size(7, 5)),
                    J.convert_to(D[chain], alpha=0.9), J.cvt_color(conv), J.write_tensor()))


def test_float16_saturates_at_the_integer_bounds_as_the_reference():
    """A float16 value past an integer type's bounds saturates to the bound:
    32767 and 65535 are not float16 values (they round to 32768 and inf), so
    the port clamps in float32, as the reference's XLA convert saturates."""
    vals = np.array([[[40000.0, -40000.0, 65504.0], [32767.0, 2.5, -0.5]]], np.float16)
    for dst in (np.int16, np.uint16, np.int8, np.uint8):
        _hold(kp, (J.image(vals), J.convert_to(dst), J.write()))


# ---------------------------------------------------------------------------
# the encoder and the store modes
# ---------------------------------------------------------------------------


def test_float16_rows():
    """An op on a float16 value is a row that rounds its scalar first
    (``OP_MUL_F16`` ..), then a row that rounds the result (``OP_CAST_F16``);
    a float16 scalar leaf is taken; casts into and out of float16 are one
    row each."""
    ops, dtype, ch, n = kbr.encode_chain(
        (T.convert_to(np.float16, alpha=0.5), T.subtract(0.51), T.convert_to(np.int16),
         T.convert_to(np.float32)), 3)
    assert dtype == torch.float32 and ch == 3 and n == 2
    assert ops.tolist() == [
        [kbr.OP_CAST_F16, 0, 0, 0],
        [kbr.OP_MUL_F16, 0, 0, 0], [kbr.OP_CAST_F16, 0, 0, 0],
        [kbr.OP_SUB_F16, 1, 0, 0], [kbr.OP_CAST_F16, 0, 0, 0],
        [kbr.OP_SAT_I16, 0, 0, 0]]
    alpha = T.convert_to(np.float16, alpha=0.5).ops[1].value
    assert np.asarray(alpha).dtype == np.float16
    ops, dtype, _, _ = kbr.encode_chain(
        (T.cvt_color(T.ColorConversionCode.COLOR_RGB2GRAY),), 3, dtype=torch.float16)
    assert dtype == torch.float16 and ops[0, 0] == kbr.OP_GRAY_F16
    # a cast to int64 is one to int32, its canonical dtype; a saturating one
    # raises, as the reference's call does; uint32 is no chain dtype
    assert kbr.encode_chain((T.Cast(dst=torch.int64),), 3)[1] == torch.int32
    with pytest.raises(OverflowError, match="int64"):
        T.convert_to(np.int64)
    with pytest.raises(kbr.Unsupported, match="cast to torch.uint32"):
        kbr.encode_chain((T.Cast(dst=torch.uint32),), 3)


#: float values past every integer range, the halves, the infinities and NaN
EDGES = (float("inf"), float("-inf"), float("nan"), 3e9, -3e9, 2.0 ** 31, -2.0 ** 31, 70000.5,
         -0.5, 254.5, 300.0, -9.0, 65535.5, -32768.5)


@pytest.mark.parametrize("out", list(D32))
@pytest.mark.parametrize("chain", list(D32))
def test_store_modes_cast_as_astype(chain, out):
    """``store_cast`` of every pair of ``TYPE_CODES``: the row a kernel runs
    after its chain (none; a float's truncate and saturate into an integer;
    int32's conversion into a float, or its low bits into a narrower
    integer), then its store (the register's 32 bits into a float32 or an
    int32 buffer, the low bits into an 8- or 16-bit one, float16 rounded),
    equals ``utils.dtypes.astype``: on values over the chain dtype's whole
    range and, for a float chain, past every integer range, the infinities
    and NaN."""
    from test_torch_tiling import emulate_rows, to_out

    src, dst = T._dt.to_torch_dtype(D32[chain]), T._dt.to_torch_dtype(D32[out])
    row = kbr.store_cast(src, dst)
    x = torch.from_numpy(_src((257,), chain, 9))
    if src.is_floating_point:
        x = torch.cat([x, torch.tensor(EDGES, dtype=torch.float32).to(src)])
    if src == dst:
        assert row == 0
    elif src == torch.int32:
        assert row == (kbr.OP_I32_F32 if dst.is_floating_point else kbr._WRAP[dst])
    elif dst == torch.int32 or (src.is_floating_point and not dst.is_floating_point):
        assert row == kbr._TRUNC[dst]
    else:
        assert row == 0
    # the registers: int32 as its bits, every other dtype as float32 values
    regs = (x.view(torch.float32) if src == torch.int32 else x.to(torch.float32)).numpy()
    regs = regs.reshape(-1, 1).copy()
    if row:
        with np.errstate(all="ignore"):
            emulate_rows(regs, [(row, 0, 1, np.zeros(4, np.float32))])
    with np.errstate(all="ignore"):
        stored = to_out(regs[:, 0], D32[out])
    want = T._dt.astype(x, dst).numpy()
    assert np.array_equal(stored.view(np.uint8), want.view(np.uint8)), (stored, want)


def test_every_kernel_stores_every_dtype_in_one_launch_on_the_meta_path():
    """Each kernel's ``out=`` takes every dtype of ``TYPE_CODES``, so that
    ``run_pipeline`` never needs a temporary and a ``copy_`` for them."""
    img = torch.empty((32, 48, 3), dtype=torch.uint8, device="meta")
    rects = np.array([[0, 0, 16, 16]], np.int32)
    for module, ops in (
            (kbr, (T.resize_batch(img, rects=rects, dsize=T.Size(8, 8)), T.convert_to(np.uint16))),
            (kfr, (T.resize(T.image(img), T.Size(8, 8)), T.convert_to(np.float16))),
            (kw, (T.warp(T.image(img), SEPARABLE, T.Size(8, 8)), T.convert_to(np.int16))),
            (kp, (T.image(img), T.convert_to(np.int8)))):
        plan = module.build_plan(T.build_pipeline(*ops, T.split_tensor()))
        assert all(module.can_store(plan, dtype) for dtype in kbr.TYPE_CODES)
        assert module.can_store(plan, torch.int32) and not module.can_store(plan, torch.int64)
