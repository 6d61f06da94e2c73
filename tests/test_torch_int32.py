"""int32 through the port's kernels, and float -> integer conversions as the
reference makes them, on the CPU against the JAX package.

Four parts:

- the conversion rule: float32 and float16 values past every integer
  range, the infinities, NaN and the halves, cast into every integer dtype
  by ``utils.dtypes`` (``cast``, ``saturate_cast``, ``astype``), by the
  ``Cast`` and ``SaturateCast`` ops, as a CONSTANT border's value and by
  int32 ``Add`` and ``Mul``, equal to the reference's ``utils.dtypes`` and
  its jitted XLA path (whose converts saturate, NaN to 0) at tolerance 0;
- the numerics: every kernel head x an int32 source or an int32 chain x its
  output, built with the JAX factories and carried across with
  ``from_jax``: the port's plain version (what each kernel is held against
  on the card) equals the reference's op-by-op lowering bit for bit, and
  its XLA path within 1e-4 where the output is float32;
- the encoder: the rows of each int32 case;
- the interpreters: every op code of ``exec/cuda_batch_resize.py`` is
  handled by name in ``csrc/chain.cuh::run_chain`` and in
  ``csrc/pointwise_chain.cuh::run_rows``, read from the sources.

Inputs are made from a seed with numpy, at small sizes.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu.utils import dtypes as jdt
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.utils import dtypes as tdt
from test_torch_dtypes import HEADS, _hold, _lowered

CPU = torch.device("cpu")
CSRC = Path(__file__).resolve().parents[1] / "cvgpuspeedup_tpu_torch" / "csrc"
INTS = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16, "i16": np.int16, "i32": np.int32}
#: the values of the conversion rule
EDGES = np.array([np.inf, -np.inf, np.nan, 2.0 ** 31, -2.0 ** 31, 3e9, 300.0, -9.0, 70000.5,
                  -0.5, 254.5, 0.5, -2.0 ** 31 - 300.0, 65535.5, -32768.5], np.float32)
I32 = np.iinfo(np.int32)


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), (got, want)


def _xla(*jops):
    return np.asarray(J.execute_operations(*jops, backend=J.ParBackend.XLA))


def _port(*jops):
    p = from_jax(J.build_pipeline(*jops))
    return T.execute_operations(p.read, *p.compute, p.write, device="cpu").numpy()


# ---------------------------------------------------------------------------
# the conversion rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", [np.float32, np.float16], ids=["f32", "f16"])
@pytest.mark.parametrize("dst", list(INTS))
def test_the_conversion_rule_equals_the_references(dst, src):
    """``cast`` and ``astype`` truncate, ``saturate_cast`` rounds half to
    even; each then saturates, NaN to 0, as XLA's convert does (2^31 - 1 for
    3e9 into int32, which float32 does not hold)."""
    x = EDGES.astype(src)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    d = INTS[dst]
    td = tdt.to_torch_dtype(d)
    _bits_equal(tdt.cast(t, td).numpy(), np.asarray(jdt.cast(j, d)))
    _bits_equal(tdt.astype(t, td).numpy(), np.asarray(j.astype(d)))
    _bits_equal(tdt.saturate_cast(t, td).numpy(), np.asarray(jdt.saturate_cast(j, d)))


def test_the_fault_table():
    """The values of the fault the rule repairs, each where the platform's
    own conversion gave another."""
    x = torch.tensor([300.0, -9.0, 3e9, 70000.5])
    assert tdt.cast(x, torch.uint8).tolist() == [255, 0, 255, 255]
    assert tdt.cast(x, torch.uint16).tolist() == [300, 0, 65535, 65535]
    assert tdt.cast(x, torch.int32).tolist() == [300, -9, 2147483647, 70000]
    y = torch.tensor([3e9, 2.0 ** 31, float("nan")])
    assert tdt.saturate_cast(y, torch.int32).tolist() == [2147483647, 2147483647, 0]
    # integer -> integer keeps the low bits, or saturates
    z = torch.tensor([16777217, 2147483647, -2147483648], dtype=torch.int32)
    assert tdt.cast(z, torch.uint8).tolist() == [1, 255, 0]
    assert tdt.saturate_cast(z, torch.uint8).tolist() == [255, 255, 0]


@pytest.mark.parametrize("op", ["cast", "saturate_cast"])
@pytest.mark.parametrize("dst", list(INTS))
def test_cast_ops_equal_the_references_xla_path(dst, op):
    """The ``Cast`` and ``SaturateCast`` ops of an image of the rule's values
    against the reference's jitted XLA path, through the executor and the
    pointwise kernel's plain version. (The reference's op-by-op lowering of
    a numpy image casts it on the host with numpy, which wraps.)"""
    img = np.tile(EDGES, 3).reshape(3, 5, 3)
    cast = (J.Cast(dst=np.dtype(INTS[dst])) if op == "cast"
            else J.SaturateCast(dst=np.dtype(INTS[dst])))
    jops = (J.image(img), cast, J.write())
    want = _xla(*jops)
    _bits_equal(_port(*jops), want)
    p = from_jax(J.build_pipeline(*jops))
    _bits_equal(kp.run(p, kp.build_plan(p), CPU).numpy(), want)


@pytest.mark.parametrize("value", [-9.0, 300.0, 3e9, -3e9, float("nan"), 70000.5, 2.0 ** 31])
@pytest.mark.parametrize("dst", list(INTS))
def test_a_constant_borders_value_is_cast_as_the_reference_casts_it(dst, value):
    """``make_border(CONSTANT, value)``: the value cast to the source's dtype
    by the rule (-9.0 into uint16 is 0, 300.0 into uint8 is 255)."""
    img = np.zeros((4, 5, 3), INTS[dst])
    jops = (J.make_border(J.image(img), 1, 2, 2, 1, J.BorderMode.CONSTANT, value=value), J.write())
    got = _port(*jops)
    _bits_equal(got, _xla(*jops))
    want = tdt.cast(torch.tensor([value], dtype=torch.float32), tdt.to_torch_dtype(INTS[dst]))
    assert int(got[0, 0, 0]) == int(want[0])


@pytest.mark.parametrize("op", ["add", "multiply", "subtract", "divide"])
def test_int32_arithmetic_saturates_as_the_reference(op):
    """An op on int32 is ``x.astype(f32) op v``, then ``saturate_cast``:
    2147483647 + 1 stays 2147483647, 2147483000 * 2 saturates, 16777217 + 1
    is 16777216 (both round through float32)."""
    vals = np.array([2147483647, 2147483000, -2147483648, -2147483000, 16777217, 16777216, 7,
                     -7, 0], np.int32)
    img = np.stack([vals, vals[::-1], vals], axis=-1)[None]
    arg = {"add": 1.0, "multiply": 2.0, "subtract": 1e9, "divide": 0.25}[op]
    jops = (J.image(img), getattr(J, op)(arg), J.write())
    got = _port(*jops)
    _bits_equal(got, _xla(*jops))
    _bits_equal(got, _lowered(J.build_pipeline(*jops))[0])
    _hold(kp, jops)
    if op == "add":
        assert got[0, 0, 0] == 2147483647 and got[0, 4, 0] == 16777216
    if op == "multiply":
        assert got[0, 1, 0] == 2147483647 and got[0, 2, 0] == -2147483648


# ---------------------------------------------------------------------------
# the numerics: every head x an int32 source or chain x output
# ---------------------------------------------------------------------------


def int32_values(shape, seed):
    """int32 values of three kinds: within 200 of int32's bounds, past
    2^24, and small."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    kinds = rng.integers(0, 4, n)
    v = np.where(kinds == 0, rng.integers(I32.min, I32.min + 200, n),
                 np.where(kinds == 1, rng.integers(I32.max - 200, I32.max, n),
                          np.where(kinds == 2, rng.integers(2 ** 24, 2 ** 30, n) *
                                   rng.choice([-1, 1], n), rng.integers(-300, 300, n))))
    return v.astype(np.int32).reshape(shape)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


RESAMPLING = ("resize_batch", "resize", "warp_separable", "warp_general", "warp_perspective")
CHAINS = {
    # an int32 source into float32 planes (the resampling heads read it into
    # float32, as the reference's astype does)
    "to_f32": lambda M: (M.convert_to(np.float32, alpha=2.0 ** -31), M.multiply(0.3),
                         M.subtract(0.51)),
    # through int32: an op is a float32 op saturated back
    "i32_ops": lambda M: (M.convert_to(np.int32), M.multiply(3.0), M.add(-7.0)),
    "wrap_u8": lambda M: (M.convert_to(np.int32), M.Cast(dst=np.dtype(np.uint8))),
    "saturate_i16": lambda M: (M.convert_to(np.int32), M.convert_to(np.int16)),
    "to_f16": lambda M: (M.convert_to(np.int32), M.convert_to(np.float16)),
    "gray": lambda M: (M.convert_to(np.int32),
                       M.cvt_color(M.ColorConversionCode.COLOR_RGB2GRAY)),
    "bgra": lambda M: (M.convert_to(np.int32), M.cvt_color(M.ColorConversionCode.COLOR_BGR2BGRA)),
}


@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("head", list(HEADS))
def test_every_head_of_an_int32_source_equals_the_reference(head, chain):
    """Each head over an int32 source, a chain through int32 stored in its
    output dtype: the plain version equals the reference op by op bit for
    bit, and its XLA path within 1e-4 for a float32 output."""
    module, read = HEADS[head]
    jops = (*read(J, lambda shape: int32_values(shape, 3)), *CHAINS[chain](J), J.split_tensor())
    plan = _hold(module, jops)
    assert plan.src_dtype == torch.int32
    if plan.out_dtype == torch.float32:
        jp = J.build_pipeline(*jops)
        got = module.run(from_jax(jp), plan, CPU).numpy()
        assert np.abs(got - np.asarray(J.execute_operations(*jops, backend=J.ParBackend.XLA))
                      ).max() <= 1e-4


@pytest.mark.parametrize("out", ["i32", "f32"])
@pytest.mark.parametrize("head", list(HEADS))
def test_every_head_of_a_uint8_source_through_int32(head, out):
    """A uint8 source converted into int32 past 2^24 and past int32's range,
    an op that saturates, stored as int32 or converted back to float32."""
    module, read = HEADS[head]
    jops = (*read(J, lambda shape: _u8(shape, 4)), J.convert_to(np.int32, alpha=3e7),
            J.add(-2e9), *((J.convert_to(np.float32),) if out == "f32" else ()), J.split_tensor())
    plan = _hold(module, jops)
    assert plan.out_dtype == (torch.int32 if out == "i32" else torch.float32)


@pytest.mark.parametrize("head", ["pointwise_image", "pointwise_ring", "pointwise_crop",
                                  "pointwise_border"])
def test_int32_copies_keep_every_value(head):
    """A copy, a ring read, a crop and a CONSTANT border of int32 keep the
    values past 2^24 and at int32's bounds (the pointwise kernel moves the
    bits)."""
    module, read = HEADS[head]
    jops = (*read(J, lambda shape: int32_values(shape, 5)), J.split_tensor())
    _hold(module, jops)
    p = from_jax(J.build_pipeline(*jops))
    got = module.run(p, module.build_plan(p), CPU).numpy()
    assert got.dtype == np.int32 and np.abs(got.astype(np.int64)).max() > 2 ** 30


@pytest.mark.parametrize("batch", ["i32", "f32"])
def test_divergent_groups_through_int32(batch):
    """The divergent kernel's groups: an int32 chain on a uint8 ring beside a
    float32 group, the batch int32 (the float group truncated and saturated
    into it) or float32 (the int32 group converted)."""
    ring = _u8((6, 7, 9, 3), 6)
    i32 = (J.circular_batch_read(ring, first=2), J.convert_to(np.int32, alpha=1e7),
           J.multiply(0.75), J.add(-1e9), J.write_tensor())
    f32 = (J.circular_batch_read(ring, first=-1), J.convert_to(np.float32, alpha=3e7),
           J.write_tensor())
    jops = (i32, f32) if batch == "i32" else (f32, i32)
    plan = _hold(kd, jops, [1, 2, 2, 1, 2, 1])
    assert plan.out_dtype == (torch.int32 if batch == "i32" else torch.float32)


# ---------------------------------------------------------------------------
# the probe table's int32 rows live in test_torch_dtypes.py; here the rows
# the encoder gives each int32 case
# ---------------------------------------------------------------------------


def _rows(chain, nch=3, dtype=torch.float32):
    ops, out_dtype, _, _ = kbr.encode_chain(chain, nch, dtype=dtype)
    return [r[0] for r in ops.tolist()], out_dtype


def test_int32_rows():
    """Into int32: a float truncates (``OP_TRUNC_I32``) or rounds
    (``OP_SAT_I32``) into its bits; an op on int32 is three rows; out of
    int32 a float conversion, a saturate through float32 or the low bits;
    the integer gray and an alpha of int32's maximum as bits."""
    i32 = torch.int32
    assert _rows((T.Cast(dst=i32),)) == ([kbr.OP_TRUNC_I32], i32)
    assert _rows((T.convert_to(np.int32),)) == ([kbr.OP_SAT_I32], i32)
    assert _rows((T.convert_to(np.int32),), dtype=torch.uint8) == ([kbr.OP_SAT_I32], i32)
    assert _rows((T.Cast(dst=i32),), dtype=torch.int16) == ([kbr.OP_TRUNC_I32], i32)
    assert _rows((T.multiply(2.0),), dtype=i32) == (
        [kbr.OP_I32_F32, kbr.OP_MUL, kbr.OP_SAT_I32], i32)
    assert _rows((T.convert_to(np.float32),), dtype=i32) == ([kbr.OP_I32_F32], torch.float32)
    assert _rows((T.convert_to(np.float16),), dtype=i32) == (
        [kbr.OP_I32_F32, kbr.OP_CAST_F16], torch.float16)
    assert _rows((T.convert_to(np.uint8),), dtype=i32) == (
        [kbr.OP_I32_F32, kbr.OP_SAT_U8], torch.uint8)
    for d, code in ((torch.uint8, kbr.OP_WRAP_U8), (torch.int8, kbr.OP_WRAP_I8),
                    (torch.uint16, kbr.OP_WRAP_U16), (torch.int16, kbr.OP_WRAP_I16)):
        assert _rows((T.Cast(dst=d),), dtype=i32) == ([code], d)
    ops, _, ch, _ = kbr.encode_chain(
        (T.cvt_color(T.ColorConversionCode.COLOR_BGR2BGRA),), 3, dtype=i32)
    assert ops[-1].tolist() == [kbr.OP_ALPHA_I32, 0, 0, 2 ** 31 - 1] and ch == 4
    ops, _, ch, _ = kbr.encode_chain(
        (T.cvt_color(T.ColorConversionCode.COLOR_BGR2GRAY),), 3, dtype=i32)
    assert ops.tolist() == [[kbr.OP_GRAY_I32, 0, 0, 2 | (1 << 4)]] and ch == 1


def test_float_casts_saturate_and_integer_casts_wrap():
    """A ``Cast`` of a float value into a narrower integer truncates and
    saturates (``OP_TRUNC_*``); of an integer value it keeps the low bits
    (``OP_CAST_*``); ``SaturateCast`` saturates either (``OP_SAT_*``)."""
    for d, trunc, wrap, sat in (
            (torch.uint8, kbr.OP_TRUNC_U8, kbr.OP_CAST_U8, kbr.OP_SAT_U8),
            (torch.int8, kbr.OP_TRUNC_I8, kbr.OP_CAST_I8, kbr.OP_SAT_I8),
            (torch.uint16, kbr.OP_TRUNC_U16, kbr.OP_CAST_U16, kbr.OP_SAT_U16),
            (torch.int16, kbr.OP_TRUNC_I16, kbr.OP_CAST_I16, kbr.OP_SAT_I16)):
        for src in (torch.float32, torch.float16):
            assert _rows((T.Cast(dst=d),), dtype=src) == ([trunc], d)
            assert _rows((T.SaturateCast(dst=d),), dtype=src) == ([sat], d)
        other = torch.int16 if d != torch.int16 else torch.uint16
        assert _rows((T.Cast(dst=d),), dtype=other) == ([wrap], d)


# ---------------------------------------------------------------------------
# the interpreters name every op code
# ---------------------------------------------------------------------------


def _body(text, signature):
    """The body of the function whose definition contains ``signature``."""
    start = text.index(signature)
    end = text.index("\n}\n", start)
    return text[start:end]


def _op_names():
    names = sorted((n for n in dir(kbr) if n.startswith("OP_") and n != "OP_CODES"),
                   key=lambda n: getattr(kbr, n))
    assert [getattr(kbr, n) for n in names] == list(kbr.OP_CODES)
    return names


def test_the_op_codes_match_the_enum():
    """The Python tuple of op codes and ``chain.cuh``'s enum give every name
    the same number."""
    text = (CSRC / "chain.cuh").read_text()
    enum = dict((m.group(1), int(m.group(2)))
                for m in re.finditer(r"^\s*(OP_\w+) = (\d+),", text, re.M))
    assert enum == {n: getattr(kbr, n) for n in _op_names()}


def test_every_op_code_is_handled_by_name_in_both_interpreters():
    """``run_chain`` names every code in a ``case``; each that it hands to
    ``run_integer_row`` is named there too. ``run_rows`` names every code
    in a comparison or reaches ``run_integer_row``, which names it; the
    float16 arithmetic codes are the range ``stage_rows`` maps onto the
    float32 ones. A code named nowhere would be skipped (``run_chain``'s
    default) or run as another row."""
    chain = (CSRC / "chain.cuh").read_text()
    pw = (CSRC / "pointwise_chain.cuh").read_text()
    run_chain = _body(chain, "int run_chain(")
    integer_row = _body(chain, "void run_integer_row(")
    run_rows = _body(pw, "void run_rows(")
    stage = _body(pw, "void stage_rows(")
    in_chain = set(re.findall(r"case (OP_\w+):", run_chain))
    in_integer = set(re.findall(r"case (OP_\w+):", integer_row))
    in_rows = set(re.findall(r"code == (OP_\w+)", run_rows))
    f16 = {"OP_MUL_F16", "OP_ADD_F16", "OP_SUB_F16", "OP_DIV_F16"}
    assert "code >= OP_MUL_F16 && code <= OP_DIV_F16" in stage
    assert [getattr(kbr, n) for n in ("OP_MUL_F16", "OP_ADD_F16", "OP_SUB_F16", "OP_DIV_F16")] == \
        list(range(kbr.OP_MUL_F16, kbr.OP_DIV_F16 + 1))
    for name in _op_names():
        assert name in in_chain, f"run_chain does not name {name}"
        assert name in in_rows or name in in_integer or name in f16, \
            f"run_rows does not name {name}"
    # what run_chain hands to run_integer_row, run_integer_row names
    handed = re.search(r"((?:case OP_\w+:\s*)+)run_integer_row\(code, v\);", run_chain).group(1)
    assert set(re.findall(r"OP_\w+", handed)) <= in_integer
    # and run_rows' last branch is run_integer_row's
    assert run_rows.rstrip().endswith("}") and "run_integer_row(code, v);" in run_rows
