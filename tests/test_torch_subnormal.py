"""Subnormal float32 values in the port as the reference computes them, on
the CPU against the JAX package.

The reference's XLA program on the CPU, jitted or op by op, runs with x86
FTZ and DAZ: a float32 operand of an arithmetic op, a comparison, ``floor``,
``max`` or ``min`` that is subnormal reads as a zero of its sign, and a
subnormal result is written as one. A copy keeps a subnormal: a read, a
gather, a crop, a border fill, a select, a layout write, a float64 value
rounded to float32. float16 is not flushed (its values are normal in the
float32 its ops run in). The port applies the rule in its eager ops
(``utils.dtypes.flush_subnormal`` and ``fmul``, ``fadd``, ``fsub``,
``fdiv``, ``ffloor``, ``lerp``), which are the kernels' plain versions too;
its kernels are compiled with ``-ftz=true`` (``tests/test_torch_cuda_subnormal.py``).

Each case of ``CASES`` is held bit for bit, as int32 (so that -0 and +0
differ), against the reference's op-by-op lowering with ``jnp`` leaves, and
must have the zero mask and the subnormal mask of its ``ParBackend.XLA``
path and lie within 1e-4 of it (XLA-CPU may contract a multiply-add into an
FMA, ``ROADMAP.md``'s standing differences). On 40d332a every case of
``FLUSHING`` failed (the port kept subnormal operands and results: 1e-40 *
1.0 was 1e-40, 1e-30 * 1e-9 was 1e-39) and every case of ``COPIES``
passed; both pass now.

Inputs are made from a seed with numpy, at small sizes: subnormals (1e-40,
-2e-39, -5e-40, 1e-38, 2^-149), values whose products with the chain's
scalars underflow (1e-30, -3e-31), and normal values.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.utils import dtypes as tdt

PORT = Path(__file__).resolve().parents[1] / "cvgpuspeedup_tpu_torch"
F32_TOL = 1e-4
TINY = np.float32(2.0 ** -126)
#: subnormals, and values whose products with a chain's scalars underflow
EDGES32 = np.array([1e-40, -2e-39, -5e-40, 1e-38, 2.0 ** -149, -1e-38, 1e-30, -3e-31],
                   np.float32)


def edge_image(seed, shape, share=2, scale=3.0):
    """float32 values: one in ``share`` from :data:`EDGES32`, the others
    normal values within ``scale``."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-scale, scale, shape).astype(np.float32)
    pick = rng.integers(0, share * len(EDGES32), shape)
    return np.where(pick < len(EDGES32), EDGES32[np.minimum(pick, len(EDGES32) - 1)], v)


def subnormal_image(seed, shape):
    """float32 values of :data:`EDGES32`'s subnormals and one in eight
    normal, so that most of a lerp's taps are subnormal."""
    rng = np.random.default_rng(seed)
    sub = EDGES32[np.abs(EDGES32) < TINY]
    v = sub[rng.integers(0, len(sub), shape)]
    return np.where(rng.integers(0, 8, shape) == 0, rng.uniform(-2, 2, shape), v).astype(
        np.float32)


def _masks(a):
    a = np.asarray(a)
    return a == 0, (a != 0) & (np.abs(a) < TINY)


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    bad = got != want
    assert not bad.any(), f"{int(bad.sum())} of {got.size} values differ, first at " \
                          f"{np.argwhere(bad)[0].tolist()}"


def hold(got, low, xla):
    """The port bit for bit against the lowering; the XLA path's zero and
    subnormal masks, and within 1e-4 of it."""
    got, low, xla = np.asarray(got), np.asarray(low), np.asarray(xla)
    _bits_equal(got, low)
    assert got.dtype == xla.dtype
    if got.dtype != np.float32:
        return
    for name, g, x in zip(("zero", "subnormal"), _masks(got), _masks(xla)):
        assert np.array_equal(g, x), f"{int((g != x).sum())} values differ in the {name} mask"
    fin = np.isfinite(xla)
    assert np.array_equal(fin, np.isfinite(got))
    assert float(np.abs(got[fin] - xla[fin]).max(initial=0.0)) <= F32_TOL


def _xla(ops, *arrays):
    return np.asarray(J.execute_operations(*ops(J, *arrays), backend=J.ParBackend.XLA))


def _lowered(ops, *arrays):
    with jax.disable_jit():
        return np.asarray(J.build_pipeline(*ops(J, *(jnp.asarray(a) for a in arrays))).lower())


def _port(ops, *arrays):
    return T.execute_operations(*ops(T, *arrays), device="cpu").numpy()


def _rot(angle, scale, center, to):
    """A 2x3 rotation about ``center`` that puts it at ``to``."""
    a = np.deg2rad(angle)
    c, s = scale * np.cos(a), scale * np.sin(a)
    return np.array([[c, s, to[0] - c * center[0] - s * center[1]],
                     [-s, c, to[1] + s * center[0] - c * center[1]]])


_RECTS = np.array([[1, 2, 10, 8], [5, 3, 9, 12]], np.int32)
_HOMOGRAPHY = np.array([[0.9, 0.05, 1.0], [0.03, 0.95, 0.5], [1e-3, 2e-3, 1.0]])

FLUSHING = {
    # the Motivation's rows: one flushed op each
    "multiply_1": (lambda M, a: (M.image(a), M.multiply(1.0), M.write()),
                   (edge_image(1, (6, 7, 3)),)),
    "add_0": (lambda M, a: (M.image(a), M.add(0.0), M.write()), (edge_image(2, (6, 7, 3)),)),
    "subtract_subnormal_scalar": (lambda M, a: (M.image(a), M.subtract((0.0, 1e-40, -2e-39)),
                                                M.write()), (edge_image(3, (6, 7, 3)),)),
    "multiply_underflows": (lambda M, a: (M.image(a), M.multiply(1e-9), M.write()),
                            (edge_image(4, (6, 7, 3)),)),
    "divide_underflows": (lambda M, a: (M.image(a), M.divide(1e9), M.write()),
                          (edge_image(5, (6, 7, 3)),)),
    "convert_to_f32_1": (lambda M, a: (M.image(a), M.convert_to(np.float32, 1.0), M.write()),
                         (edge_image(6, (6, 7, 3)),)),
    "convert_to_f32_2": (lambda M, a: (M.image(a), M.convert_to(np.float32, 2.0), M.write()),
                         (edge_image(7, (6, 7, 3)),)),
    # 200 * 1e-40 is normal: the scalar itself reads as 0
    "u8_convert_to_subnormal_alpha": (
        lambda M, a: (M.image(a), M.convert_to(np.float32, 1e-40), M.write()),
        (np.random.default_rng(8).integers(0, 256, (6, 7, 3)).astype(np.uint8),)),
    # float16's subnormal 6e-8 is normal in float32; its product is not
    "f16_convert_to_f32": (
        lambda M, a: (M.image(a), M.convert_to(np.float32, 1e-33), M.write()),
        (np.concatenate([np.array([6e-8, -6e-8, 1e-5, 2.0, 0.0, 65504.0], np.float16),
                         np.random.default_rng(9).uniform(-4, 4, 36).astype(np.float16)]
                        ).reshape(6, 7, 1),)),
    "int32_convert_to_subnormal_alpha": (
        lambda M, a: (M.image(a), M.convert_to(np.float32, 2e-39), M.write()),
        (np.random.default_rng(10).integers(-10 ** 6, 10 ** 6, (6, 7, 3)).astype(np.int32),)),
    "resize_4x4": (lambda M, a: (M.resize(M.image(a), M.Size(4, 4)), M.write()),
                   (subnormal_image(11, (8, 8, 3)),)),
    "resize_13x11": (lambda M, a: (M.resize(M.image(a), M.Size(13, 11)), M.write()),
                     (subnormal_image(12, (8, 8, 3)),)),
    # an exact 2:1 ratio: polyphase in the reference, keep_edge in the port
    "resize_keep_edge_2to1": (lambda M, a: (M.resize(M.image(a), M.Size(8, 6)),
                                            M.multiply(1.0), M.write()),
                              (subnormal_image(13, (12, 16, 1)),)),
    "resize_batch": (lambda M, a: (M.resize_batch(a, rects=_RECTS, dsize=M.Size(6, 4)),
                                   M.split_tensor()),
                     (subnormal_image(14, (16, 20, 3)),)),
    "resize_batch_flagship_chain": (
        lambda M, a: (M.resize_batch(a, rects=_RECTS, dsize=M.Size(6, 4)),
                      M.convert_to(np.float32, 0.3), M.subtract((0.0, 1e-40, 0.0)),
                      M.divide((1e9, 1.0, 2.0)), M.split_tensor()),
        (edge_image(15, (16, 20, 3)),)),
    "warp_affine": (lambda M, a: (M.warp(M.image(a), _rot(12.0, 0.8, (10, 8), (9, 7)),
                                         M.Size(16, 12)), M.write()),
                    (subnormal_image(16, (16, 20, 3)),)),
    "warp_affine_subnormal_border": (
        lambda M, a: (M.warp(M.image(a), _rot(30.0, 1.3, (10, 8), (8, 6)), M.Size(16, 12),
                             default=(1e-40, -2e-39, 3.0)), M.write()),
        (edge_image(17, (16, 20, 3)),)),
    "warp_perspective": (lambda M, a: (M.warp(M.image(a), _HOMOGRAPHY, M.Size(16, 12),
                                              warp_type=M.WarpType.PERSPECTIVE), M.write()),
                         (subnormal_image(18, (16, 20, 3)),)),
    "warp_batch": (lambda M, a, b: (M.warp_batch(
        [M.image(a), M.image(b)], [_rot(8.0, 0.9, (10, 8), (8, 6)),
                                   _rot(-5.0, 1.1, (10, 8), (8, 6))], M.Size(16, 12)),
        M.multiply(1.0), M.split_tensor()),
        (subnormal_image(19, (16, 20, 3)), edge_image(20, (16, 20, 3)))),
    "border_constant_subnormal_then_multiply": (
        lambda M, a: (M.make_border(M.image(a), 2, 1, 3, 2, M.BorderMode.CONSTANT, value=1e-40),
                      M.multiply(2.0), M.write()),
        (edge_image(21, (6, 7, 3)),)),
    "crop_border_chain": (
        lambda M, a: (M.make_border(M.crop(M.image(a), M.Rect(1, 2, 6, 5)), 1, 2, 2, 1,
                                    M.BorderMode.REFLECT), M.multiply(0.5), M.add(1e-40),
                      M.write()),
        (edge_image(22, (9, 10, 3)),)),
    "static_loop": (lambda M, a: (M.image(a), M.static_loop(M.multiply(0.25), 3), M.write()),
                    (edge_image(23, (6, 7, 3), scale=1e-36),)),
    "cvt_color_gray": (lambda M, a: (M.image(a), M.cvt_color(M.ColorConversionCode.COLOR_RGB2GRAY),
                                     M.write()),
                       (edge_image(24, (6, 7, 3)),)),
}

COPIES = {
    "write": (lambda M, a: (M.image(a), M.write()), (edge_image(31, (6, 7, 3)),)),
    "split_tensor": (lambda M, a: (M.image(a), M.split_tensor()), (edge_image(32, (2, 6, 7, 3)),)),
    "crop": (lambda M, a: (M.crop(M.image(a), M.Rect(2, 1, 5, 4)), M.write()),
             (edge_image(33, (6, 7, 3)),)),
    "border_constant_subnormal": (
        lambda M, a: (M.make_border(M.image(a), 2, 1, 3, 2, M.BorderMode.CONSTANT,
                                    value=(1e-40, -2e-39, 1e-38)), M.write()),
        (edge_image(34, (6, 7, 3)),)),
    "float64_source": (lambda M, a: (M.image(a), M.write()),
                       (np.concatenate([[1e-40, -1e-42, 2.0 ** -149, 1e-46, 1 / 3],
                                        np.random.default_rng(35).uniform(-3, 3, 37)]
                                       ).reshape(6, 7, 1),)),
    # every phase of a 3:1 downscale has weight 0: the reference's strided
    # slice and the port's select copy the tap
    "resize_3to1_copies": (lambda M, a: (M.resize(M.image(a), M.Size(3, 3)), M.write()),
                           (subnormal_image(36, (9, 9, 3)),)),
}
CASES = {**FLUSHING, **COPIES}


@pytest.mark.parametrize("case", list(CASES))
def test_the_subnormal_table(case):
    ops, arrays = CASES[case]
    got = _port(ops, *arrays)
    low = _lowered(ops, *arrays)
    hold(got, low, _xla(ops, *arrays))
    zero, sub = _masks(low)
    if case in COPIES:  # a copy keeps subnormals
        assert sub.any()
    else:  # the case flushes: the reference's output has zeros and no subnormal
        assert zero.any() and not sub.any()


def test_flushed_values_of_the_motivating_rows():
    """multiply(1.0) of {1e-40, -2e-39, 1e-30, 3, 1e-38, 5} gives {0, -0,
    1e-30, 3, 0, 5}; multiply(1e-9) and divide(1e9) of 1e-30 give 0; a
    uint8 image times the subnormal 1e-40 is 0."""
    a = np.array([1e-40, -2e-39, 1e-30, 3.0, 1e-38, 5.0], np.float32).reshape(1, 6, 1)
    got = _port(lambda M, x: (M.image(x), M.multiply(1.0), M.write()), a).reshape(-1)
    assert got.view(np.int32).tolist() == np.array(
        [0.0, -0.0, 1e-30, 3.0, 0.0, 5.0], np.float32).view(np.int32).tolist()
    for op in (T.multiply(1e-9), T.divide(1e9)):
        assert T.execute_operations(T.image(a), op, T.write(), device="cpu").numpy()[0, 2, 0] == 0
    u8 = np.arange(1, 7, dtype=np.uint8).reshape(1, 6, 1) * 40
    got = T.execute_operations(T.image(u8), T.convert_to(np.float32, 1e-40), T.write(),
                               device="cpu").numpy()
    assert not got.any()


@pytest.mark.parametrize("ring_dtype", [np.float32, np.uint8])
def test_circular_tensor_update_into_a_ring(ring_dtype):
    """``CircularTensor.update`` with a chain that flushes, into a float32
    ring (and a uint8 one, which the flush cannot reach): the port's ring
    equals the reference's ring updated op by op bit for bit, and its jitted
    ring within the masks."""
    frames = [edge_image(40 + k, (5, 6, 3)) for k in range(3)]
    rings = {}
    for name, m in (("port", T), ("low", J), ("xla", J)):
        kw = {"device": "cpu"} if m is T else {}
        ct = m.CircularTensor(6, 5, 3, 2, dtype=ring_dtype, **kw)
        for f in frames:
            ops = (m.image(jnp.asarray(f) if m is J else f), m.multiply(1.0), m.add(1e-40))
            if name == "low":
                with jax.disable_jit():
                    ct.update(*ops)
            else:
                ct.update(*ops)
        rings[name] = np.asarray(ct.tensor)
    hold(rings["port"], rings["low"], rings["xla"])
    if ring_dtype == np.float32:
        zero, sub = _masks(rings["low"])
        assert zero.any() and not sub.any()


def _divergent_d1(M, ring):
    seq = M.build_operation_sequence
    read = M.circular_batch_read(ring, first=1)
    return [1, 2, 1, 2], (
        seq(read, M.convert_to(np.float32, alpha=0.3), M.subtract((1e-40, 0.0, 0.0)),
            M.write_tensor()),
        seq(read, M.convert_to(np.float32, alpha=0.5), M.multiply((2.0, 1.0, 1e-9)),
            M.write_tensor()))


def test_divergent_batch_of_d1s_kinds():
    """A float32 ring of 4 planes read by two sequences (the kinds of
    ``chip_smoke.py``'s D1): the port's eager merge and its kernel's plain
    version against the reference's merge op by op bit for bit and its XLA
    merge within the masks."""
    from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd

    ring = edge_image(50, (4, 5, 6, 3))
    ids, jseqs = _divergent_d1(J, jnp.asarray(ring))
    with jax.disable_jit():
        groups = {}
        for z, sid in enumerate(ids):
            groups.setdefault(sid, []).append(z)
        merged = jnp.zeros((len(ids), 5, 6, 3), jnp.float32)
        for sid, planes in groups.items():
            x = jseqs[sid - 1].read.lower_planes(tuple(planes))
            for o in jseqs[sid - 1].compute:
                x = o.apply(x)
            merged = merged.at[jnp.asarray(planes)].set(x)
        low = np.asarray(jseqs[0].write.write(merged))
    xla = np.asarray(J.launch_divergent_batch(ids, *jseqs, backend=J.ParBackend.XLA))
    tids, tseqs = _divergent_d1(T, ring)
    got = T.launch_divergent_batch(tids, *tseqs, device="cpu").numpy()
    hold(got, low, xla)
    _bits_equal(kd.run(tseqs, kd.build_plan(tseqs, tids), torch.device("cpu")).numpy(), got)
    zero, sub = _masks(low)
    assert zero.any() and not sub.any()


# ---------------------------------------------------------------------------
# the rule itself
# ---------------------------------------------------------------------------

_OPERANDS = np.array([1e-40, -2e-39, -5e-40, 1e-38, 2.0 ** -149, 0.0, -0.0, 1e-30, -3e-31,
                      1e-9, 1e9, 3.0, -1.5, 1.17549435e-38, -1.17549435e-38, np.inf, -np.inf,
                      3.4e38], np.float32)


@pytest.mark.parametrize("name", ["fmul", "fadd", "fsub", "fdiv"])
def test_each_elementary_op_against_the_reference(name):
    """``utils.dtypes.fmul``/``fadd``/``fsub``/``fdiv`` on every pair of an
    edge table, as float32 tensors and with a Python float, against the
    reference's op on ``jnp`` arrays, bit for bit."""
    a, b = np.meshgrid(_OPERANDS, _OPERANDS)
    jop = {"fmul": jnp.multiply, "fadd": jnp.add, "fsub": jnp.subtract, "fdiv": jnp.divide}[name]
    with jax.disable_jit():
        want = np.asarray(jop(jnp.asarray(a), jnp.asarray(b)))
        want_scalar = np.asarray(jop(jnp.asarray(a), jnp.float32(1e-40)))
    fn = getattr(tdt, name)
    got = fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got))
    _bits_equal(got[~nan], want[~nan])
    got = fn(torch.from_numpy(a), 1e-40).numpy()
    nan = np.isnan(want_scalar)
    _bits_equal(got[~nan], want_scalar[~nan])


def test_flush_subnormal_floor_and_what_it_leaves_alone():
    """A zero of the subnormal's sign, every other float32 as it is
    (NaN and the infinities too); float16, float64 and integer tensors
    untouched; ``ffloor`` of -1e-40 is -0, as the reference's floor."""
    x = torch.from_numpy(_OPERANDS)
    got = tdt.flush_subnormal(x).numpy()
    sub = (_OPERANDS != 0) & (np.abs(_OPERANDS) < TINY)
    want = np.where(sub, np.copysign(np.float32(0.0), _OPERANDS), _OPERANDS)
    _bits_equal(got, want)
    for t in (torch.tensor([6e-8, -6e-8], dtype=torch.float16),
              torch.tensor([1e-40, 1e-310], dtype=torch.float64),
              torch.tensor([1, -2], dtype=torch.int32)):
        assert tdt.flush_subnormal(t) is t
    assert tdt.flush_subnormal(1e-40) == 0.0 and str(tdt.flush_subnormal(-1e-40)) == "-0.0"
    assert tdt.flush_subnormal(2.0) == 2.0
    with jax.disable_jit():
        want = np.asarray(jnp.floor(jnp.asarray(_OPERANDS[np.isfinite(_OPERANDS)])))
    _bits_equal(tdt.ffloor(torch.from_numpy(_OPERANDS[np.isfinite(_OPERANDS)])).numpy(), want)


def test_no_port_source_flushes_the_process():
    """``torch.set_flush_denormal`` changes the caller's whole process, works
    only on the CPU and misses the intra-op threads: no port source calls
    it."""
    paths = sorted(PORT.rglob("*.py"))
    assert paths
    for path in paths:
        assert not re.search(r"set_flush_denormal", path.read_text()), path


#: forward warp matrices whose inverse has a subnormal coefficient: the
#: factories invert on the host, so the first gives c01 = +1e-39, the second
#: c01 = -1e-39 and the third c10 = -1e-39
SUBNORMAL_MAPS = {"c01_pos": ((1, -1e-39, 0), (0, 1, 0)), "c01_neg": ((1, 1e-39, 0), (0, 1, 0)),
                  "c10_neg": ((1, 0, 0), (1e-39, 1, 0))}


@pytest.mark.parametrize("border", [(7.0, -2.0, 5.0), (np.inf, -2.0, 5.0)], ids=["finite", "inf"])
@pytest.mark.parametrize("name", list(SUBNORMAL_MAPS))
def test_a_warp_map_with_a_subnormal_coefficient(name, border):
    """The host's numpy terms keep the subnormal coefficient: -1e-39 * Y is
    a normal float from Y = 12 on, where a flushed product is 0, so column
    0 (row 0) floors to -1 and reads the border with weight 0 (an infinite
    border gives NaN there). The warp kernel's and the composed kernel's
    plain versions (the eager lowering, and the composed one recomputing
    the terms from the block) equal the reference's ``ParBackend.XLA`` path
    as int32 bits, at a height of 1024; the composed one did not where the
    border held an infinity until it computed the terms as the host does."""
    from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
    from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw

    src = np.random.default_rng(50).uniform(-3, 3, (1024, 40, 3)).astype(np.float32)
    m = np.array(SUBNORMAL_MAPS[name], np.float64)

    def ops(M, a, crop=False):
        read = M.crop(M.image(a), M.Rect(0, 0, 40, 1024)) if crop else M.image(a)
        return (M.warp(read, m, M.Size(40, 1024), default=border), M.write())

    want = np.asarray(J.execute_operations(*ops(J, jnp.asarray(src)), backend=J.ParBackend.XLA))
    cpu = torch.device("cpu")
    p = T.build_pipeline(*ops(T, torch.from_numpy(src)))
    got = kw.warp_reference(kw.prepare(p, kw.build_plan(p), cpu)).numpy()
    _bits_equal(got, want)
    _bits_equal(T.execute_operations(*ops(T, src), device="cpu").numpy(), want)
    p = T.build_pipeline(*ops(T, torch.from_numpy(src), crop=True))
    got = kc.composed_reference(kc.prepare(p, kc.build_plan(p), cpu)).numpy()
    _bits_equal(got, np.asarray(J.execute_operations(*ops(J, jnp.asarray(src), crop=True),
                                                     backend=J.ParBackend.XLA)))
    if border[0] == np.inf and name != "c01_pos":
        assert np.isnan(want).any()  # the border's weight-0 tap: the case bites


def _kernel_sass():
    import importlib.util

    spec = importlib.util.spec_from_file_location("kernel_sass", PORT.parent / "tools" /
                                                  "kernel_sass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: SASS lines of a kernel: an FMUL and an FADD without .FTZ (a warp map's
#: terms), flushed ops, and a float64 load's conversion without .FTZ
_TERMS_SASS = """
        /*0070*/                   FMUL R2, R2, R3 ;
        /*0080*/                   FADD R4, R2, R5 ;
        /*0090*/                   FADD.FTZ R6, R4, R7 ;
        /*00a0*/               @P0 FSETP.GT.FTZ.AND P1, PT, R6, RZ, PT ;
        /*00b0*/                   F2F.F32.F64 R8, R10 ;
"""


@pytest.mark.parametrize("kernel,extra,holds", [
    ("warp_kernel", "", True), ("divergent_kernel", "", True), ("composed_kernel", "", True),
    ("divergent_split", "", True),
    ("pointwise_kernel", "", False), ("frame_resize_kernel", "", False),
    ("warp_kernel", "        /*00c0*/                   FSETP.GT.AND P1, PT, R6, RZ, PT ;\n", False),
    ("warp_kernel", "        /*00c0*/                   FMNMX R6, R6, RZ, !PT ;\n", False),
    ("warp_kernel", "        /*00c0*/                   FMUL32I R6, R6, 0.5 ;\n", False),
    ("warp_kernel", "        /*00c0*/                   F2F.FTZ.F32.F64 R8, R10 ;\n", False)],
    ids=["warp", "divergent", "composed", "divergent_split", "pointwise", "frame_resize", "fsetp",
         "fmnmx", "fmul32i", "f2f_ftz"])
def test_the_sass_census_excepts_a_warp_map_s_terms_alone(kernel, extra, holds):
    """Phase 2's census of ``chip_smoke.py`` lets a warp map's terms, an
    ``FMUL`` or ``FADD`` without ``.FTZ`` (``csrc/warp.cuh``'s PTX
    ``mul.rn.f32`` and ``add.rn.f32``), through in the kernels that compute
    warp coordinates (the split kernel holds K6's and the composed
    kernel's bodies), and nowhere else; every other float32 op
    without ``.FTZ``, and a float64 conversion with it, breaks the rule."""
    ks = _kernel_sass()
    c = {"instances": 1, **ks.ftz_stats(_TERMS_SASS + extra)}
    assert c["keep_terms"] == 2
    assert ks.rule_holds(kernel, c) is holds
    assert not ks.rule_holds(kernel, {**c, "instances": 0})
