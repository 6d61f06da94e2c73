"""64-bit values in the port as the reference computes them, on the CPU
against the JAX package.

The reference runs with jax's 64-bit values off (``jax_enable_x64`` is
False and nothing in the package turns it on), so an int64 value becomes
int32 by keeping its low 32 bits, a uint64 one uint32, and a float64 one
float32 rounded to nearest, where ``jnp.asarray`` converts it. The port
applies the same rule where values enter (``utils.dtypes.canonical_dtype``,
``canonicalize``, ``as_device_tensor``), and its kernels read a 64-bit
tensor source at load as its canonical dtype.

Parts:

- the fault table: each case gives the reference's dtype and values.
  Integers are held bit for bit against the reference's jitted XLA path
  and its op-by-op lowering with ``jnp`` leaves; floats bit for bit against
  that lowering and within 1e-4 of the XLA path. (The lowering of a numpy
  leaf under ``jax.disable_jit()`` keeps some ops in numpy, which computes
  in 64 bits; a ``jnp`` leaf is what the reference's dispatch makes of it.)
  On 884fa8b every case of ``FAULTS`` failed: the port returned int64 and
  float64 tensors (the int64 add went through float32 and lost its low
  bits), and ``convert_to(np.int64)`` ran instead of raising;
- the rule itself against ``jax.dtypes`` and ``jnp.asarray``; a Python int
  scalar outside int32 raises in both packages;
- the flagship and frame (a) on float64 and int64 frames, a float64
  ``CircularTensor``, ``cv2_compat`` with ``CV_64F``, ``from_jax`` of a
  pipeline with int64 numpy leaves, a CPU float64 tensor leaf against its
  numpy twin (all new here; each failed on 884fa8b by its dtype);
- each kernel's plain version on int64 and float64 sources equals the plain
  version on the canonicalized source bit for bit;
- the kernels' source switches: every source code is a case by name in the
  pointwise kernel's loaders, and has an instance in K1, K2 and the warp
  kernel (read from the sources).

Inputs are made from a seed with numpy, at small sizes.
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
from cvgpuspeedup_tpu.interop import cv2_compat as JcvGS
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
from cvgpuspeedup_tpu_torch.interop import cv2_compat as cvGS
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.utils import dtypes as tdt

CPU = torch.device("cpu")
CSRC = Path(__file__).resolve().parents[1] / "cvgpuspeedup_tpu_torch" / "csrc"
F32_TOL = 1e-4
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _i64(rng, shape):
    """int64 values whose low 32 bits span int32 and whose high bits vary."""
    low = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, shape, dtype=np.int64)
    return low + rng.integers(-3, 4, shape) * 2 ** 32


def _f64(rng, shape, scale=300.0):
    """float64 values that float32 rounds."""
    return rng.uniform(-scale, scale, shape)


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        f"{int((got != want).sum())} of {got.size} values differ"


def _xla(ops, *arrays):
    return np.asarray(J.execute_operations(*ops(J, *arrays), backend=J.ParBackend.XLA))


def _lowered(ops, *arrays):
    """The reference op by op with ``jnp`` leaves: what its dispatch makes of
    a host array."""
    with jax.disable_jit():
        return np.asarray(J.build_pipeline(*ops(J, *(jnp.asarray(a) for a in arrays))).lower())


def _port(ops, *arrays):
    return T.execute_operations(*ops(T, *arrays), device="cpu").numpy()


def _hold(ops, *arrays, port=None):
    """The port against both reference paths: the same dtype; integers bit
    for bit, floats bit for bit against the lowering and within 1e-4 of the
    XLA path (an infinity the same infinity)."""
    got = _port(ops, *arrays) if port is None else port
    xla, low = _xla(ops, *arrays), _lowered(ops, *arrays)
    assert got.dtype == xla.dtype == low.dtype, (got.dtype, xla.dtype, low.dtype)
    _bits_equal(got, low)
    if np.issubdtype(got.dtype, np.integer):
        _bits_equal(got, xla)
    else:
        assert np.array_equal(np.isinf(got), np.isinf(xla)) and np.array_equal(
            got[np.isinf(got)], xla[np.isinf(xla)])
        fin = np.isfinite(got)
        assert float(np.abs(got[fin] - xla[fin]).max(initial=0.0)) <= F32_TOL
    return got


# ---------------------------------------------------------------------------
# the fault table
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(64)
FAULTS = {
    # int64 keeps its low 32 bits: 2^40 + 5 is 5, -2^33 is 0
    "int64_add": (lambda M, a: (M.image(a), M.add(1), M.write()),
                  (np.concatenate([np.array([2 ** 40 + 5, 7, -2 ** 33]),
                                   _i64(_rng, 27)]).reshape(5, 2, 3),)),
    # the op saturates at int32's bounds
    "int64_multiply_saturates": (lambda M, a: (M.image(a), M.multiply(5000), M.write()),
                                 (_rng.integers(-2 ** 20, 2 ** 20, (4, 5, 3)),)),
    # float64 rounds to float32: past its range an infinity
    "float64_multiply": (lambda M, a: (M.image(a), M.multiply(1.0), M.write()),
                         (np.concatenate([[1e39, 1 / 3, 2.0, -1e39, 3.4028235677973366e38,
                                           -1e-30], _f64(_rng, 24)]).reshape(5, 2, 3),)),
    # a copy keeps float32's subnormals (1e-40) and flushes what lies below
    # them (1e-46) in both; arithmetic on a subnormal is another matter:
    # XLA flushes its result to 0, float32 input or not (ROADMAP.md section 3)
    "float64_copy": (lambda M, a: (M.image(a), M.write()),
                     (np.concatenate([[1e39, 1 / 3, 1e-40, -1e-42, 1e-46, 2.0 ** -149],
                                      _f64(_rng, 24)]).reshape(5, 2, 3),)),
    "convert_to_float64": (lambda M, a: (M.image(a), M.convert_to(np.float64, 0.3), M.write()),
                           (_rng.integers(0, 256, (6, 7, 3)).astype(np.uint8),)),
    "convert_to_float64_beta": (lambda M, a: (M.image(a), M.convert_to(np.float64, 0.3, -2.5),
                                              M.write()),
                                (_rng.integers(0, 256, (6, 7, 3)).astype(np.uint8),)),
    "float64_divide_split": (lambda M, a: (M.image(a), M.divide(7), M.split_tensor()),
                             (_f64(_rng, (2, 6, 7, 3)),)),
}


@pytest.mark.parametrize("case", list(FAULTS))
def test_the_fault_table(case):
    ops, arrays = FAULTS[case]
    got = _hold(ops, *arrays)
    assert got.dtype in (np.int32, np.float32)


def test_the_fault_tables_values():
    """The table's first rows by value: int32 [6, 8, 1] and float32
    [inf, 0.33333334, 2]."""
    ops, (a,) = FAULTS["int64_add"]
    assert _port(ops, a).reshape(-1)[:3].tolist() == [6, 8, 1]
    ops, (a,) = FAULTS["float64_multiply"]
    got = _port(ops, a).reshape(-1)
    assert got.dtype == np.float32 and got[0] == np.inf and got[1] == np.float32(1 / 3)
    ops, (a,) = FAULTS["int64_multiply_saturates"]
    got = _port(ops, a)
    assert got.dtype == np.int32 and got.max() == 2 ** 31 - 1 and got.min() == -2 ** 31


@pytest.mark.parametrize("alpha", [None, 2.0], ids=["plain", "alpha"])
def test_a_saturating_cast_to_int64_raises_in_both(alpha):
    """``convert_to(np.int64)``: the reference's jitted call raises
    ``OverflowError`` (its saturate bounds do not fit int32); the port's
    factory raises the same. ``Cast`` to int64 is a cast to int32 in both."""
    img = np.array([[[1e10], [-1e10], [301.0]]], np.float32)
    with pytest.raises(OverflowError):
        J.execute_operations(J.image(img), J.convert_to(np.int64, alpha), J.write(),
                             backend=J.ParBackend.XLA)
    with pytest.raises(OverflowError, match="int64"):
        T.convert_to(np.int64, alpha)
    with pytest.raises(OverflowError):
        from_jax(J.build_pipeline(J.image(img), J.convert_to(np.int64, alpha)))
    _hold(lambda M, a: (M.image(a), M.Cast(dst=np.dtype(np.int64)) if M is J
                        else M.Cast(dst=torch.int64), M.write()), img)


def test_a_float64_tensor_leaf_equals_its_numpy_twin():
    """``image(torch float64 tensor)``, ``multiply(3)``: float32, equal to the
    numpy twin's result and to the reference on that twin."""
    a = _f64(np.random.default_rng(3), (5, 6, 3), 1e3)
    ops = lambda M, x: (M.image(x), M.multiply(3), M.write())  # noqa: E731
    got = T.execute_operations(*ops(T, torch.from_numpy(a)), device="cpu").numpy()
    assert got.dtype == np.float32
    _bits_equal(got, _port(ops, a))
    _hold(ops, a, port=got)
    # an int64 tensor leaf likewise
    b = _i64(np.random.default_rng(4), (5, 6, 3))
    got = T.execute_operations(*ops(T, torch.from_numpy(b)), device="cpu").numpy()
    _bits_equal(got, _port(ops, b))
    _hold(ops, b, port=got)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int8, np.uint16, np.int16, np.uint32,
                                   np.int32, np.uint64, np.int64, np.float16, np.float32,
                                   np.float64])
def test_canonical_dtype_is_jaxs(dtype):
    want = jax.dtypes.canonicalize_dtype(dtype)
    assert tdt.canonical_dtype(dtype) == want
    assert tdt.canonical_dtype(tdt.to_torch_dtype(dtype)) == tdt.to_torch_dtype(want)


def test_canonicalize_converts_as_jnp_asarray():
    """Values: int64 and uint64 wrap, float64 rounds to nearest (an infinity
    past float32's range, subnormals kept), a tensor as its numpy twin."""
    rng = np.random.default_rng(5)
    for a in (_i64(rng, 64), rng.integers(0, 2 ** 63, 64, dtype=np.uint64),
              np.concatenate([_f64(rng, 58), [1e39, -1e39, 1e-40, 1e-46, 3.4028235e38,
                                              2.0 ** -149]])):
        want = np.asarray(jnp.asarray(a))
        _bits_equal(tdt.canonicalize(a), want)
        if a.dtype != np.uint64:
            _bits_equal(tdt.canonicalize(torch.from_numpy(a)).numpy(), want)
            _bits_equal(tdt.as_device_tensor(a, CPU).numpy(), want)
    # the port's own index tables keep int64
    assert tdt.as_device_tensor(np.arange(3), CPU, canonical=False).dtype == torch.int64


def test_a_python_int_outside_int32_raises_in_both():
    img = np.ones((2, 3, 3), np.float32)
    with pytest.raises(OverflowError):
        J.execute_operations(J.image(img), J.Mul(value=2 ** 40), J.write(),
                             backend=J.ParBackend.XLA)
    with pytest.raises(OverflowError):
        T.execute_operations(T.image(img), T.Mul(value=2 ** 40), T.write(), device="cpu")
    with pytest.raises(OverflowError):
        from_jax(J.build_pipeline(J.image(img), J.Mul(value=2 ** 40)))
    # inside int32 it is a value like any other
    _hold(lambda M, a: (M.image(a), M.Mul(value=2 ** 30), M.write()), img)


# ---------------------------------------------------------------------------
# the main paths, the ring, the shim, from_jax
# ---------------------------------------------------------------------------

RECTS = np.array([[1, 2, 20, 14], [9, 5, 13, 17], [-3, 4, 12, 10]], np.int32)


def _flagship(M, frame):
    return (M.resize_batch(frame, rects=RECTS, dsize=M.Size(12, 10)),
            M.convert_to(np.float32, 0.3), M.subtract((3.2, 0.6, 11.8)), M.divide(128.0),
            M.split_tensor())


def _frame_a(M, img):
    return (M.resize(M.image(img), M.Size(13, 9)), M.convert_to(np.float32, alpha=1 / 255.0),
            M.subtract(MEAN), M.divide(STD), M.split_tensor())


@pytest.mark.parametrize("dtype", ["f64", "i64"])
@pytest.mark.parametrize("path", ["flagship", "frame_a"])
def test_main_paths_on_64bit_frames(path, dtype):
    """The flagship and frame (a) on a float64 or int64 frame of image values
    (the int64 one with high bits set, which the rule drops): float32
    planes, as the reference's; the kernel's plain version on the same host
    frame gives them too, from a plan of the canonical source dtype."""
    rng = np.random.default_rng(6)
    shape = (24, 36, 3) if path == "flagship" else (21, 34, 3)
    if dtype == "f64":
        frame = rng.uniform(0.0, 255.0, shape)
    else:
        frame = rng.integers(0, 256, shape) + rng.integers(-3, 4, shape) * 2 ** 32
    ops, module = (_flagship, kbr) if path == "flagship" else (_frame_a, kfr)
    got = _hold(ops, frame)
    p = T.build_pipeline(*ops(T, frame))
    plan = module.build_plan(p)
    assert plan.src_dtype == tdt.to_torch_dtype(tdt.canonical_dtype(frame.dtype))
    _bits_equal(module.run(p, plan, CPU).numpy(), got)


def test_a_float64_circular_tensor_is_float32():
    """``CircularTensor(dtype=np.float64)`` holds float32, as the reference's
    ``jnp.zeros`` gives it; updates with float64 frames equal the
    reference's ring."""
    rng = np.random.default_rng(7)
    ring = T.CircularTensor(8, 6, 3, 3, dtype=np.float64, device="cpu")
    jring = J.CircularTensor(8, 6, 3, 3, dtype=np.float64)
    assert ring.tensor.dtype == torch.float32
    for _ in range(4):
        frame = _f64(rng, (6, 8, 3))
        ring.update(T.image(frame), T.multiply(0.5))
        jring.update(J.image(jnp.asarray(frame)), J.multiply(0.5))
    want = np.asarray(jring.tensor)
    assert want.dtype == np.float32
    _bits_equal(ring.tensor.numpy(), want)


def test_cv2_compat_cv_64f_is_float32():
    """``convertTo(CV_64F)`` through the shim: float32 in both."""
    rng = np.random.default_rng(8)
    frame = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
    rects = [[i, i, 20, 24] for i in range(3)]

    def pipeline(m):
        return (m.resize_batch(frame, rects, (16, 12), usedPlanes=3, backgroundValue=1.0,
                               interpolation=1),
                m.convertTo(cvGS.CV_64F, alpha=1 / 3.0), m.subtract((3.2, 0.6, 11.8)),
                m.split_tensor())

    got = cvGS.executeOperations(*pipeline(cvGS), device="cpu").numpy()
    want = np.asarray(JcvGS.executeOperations(*pipeline(JcvGS)))
    assert got.dtype == want.dtype == np.float32
    assert float(np.abs(got - want).max()) <= F32_TOL


def test_from_jax_carries_int64_numpy_leaves_as_int32():
    """A reference pipeline holding int64 numpy leaves (a frame, rects, a
    ring's ``first``): ``from_jax`` gives int32 leaves, and the port's result
    is the reference's."""
    rng = np.random.default_rng(9)
    ring = _i64(rng, (4, 5, 6, 3))
    jp = J.build_pipeline(J.circular_batch_read(ring, first=np.int64(-2)), J.multiply(3.0),
                          J.split_tensor())
    p = from_jax(jp)
    assert p.read.data.dtype == np.int32 and np.asarray(p.read.first).dtype == np.int32
    got = T.execute_operations(p.read, *p.compute, p.write, device="cpu").numpy()
    _hold(lambda M, a: (M.circular_batch_read(a, first=np.int64(-2)), M.multiply(3.0),
                        M.split_tensor()), ring, port=got)
    flagship = from_jax(J.build_pipeline(*_flagship(J, _f64(rng, (24, 36, 3)))))
    assert flagship.read.frame.dtype == np.float32


# ---------------------------------------------------------------------------
# the plain versions on 64-bit sources
# ---------------------------------------------------------------------------

PLAIN_HEADS = {
    "resize_batch": (kbr, lambda M, a: (M.resize_batch(a((24, 36, 3)), rects=RECTS,
                                                       dsize=M.Size(12, 10)),
                                        M.multiply(0.5), M.split_tensor())),
    "resize": (kfr, lambda M, a: (M.resize(M.image(a((21, 34, 3))), M.Size(13, 9)),
                                  M.multiply(0.5), M.split_tensor())),
    "warp": (kw, lambda M, a: (M.warp(M.image(a((20, 30, 3))),
                                      np.array([[0.8, 0.3, 1.0], [-0.3, 0.8, 8.0]]),
                                      M.Size(18, 12)), M.multiply(0.5), M.split_tensor())),
    "pointwise_border": (kp, lambda M, a: (M.make_border(
        M.crop(M.image(a((9, 14, 3))), M.Rect(-3, 1, 8, 6)), 1, 2, 2, 1,
        M.BorderMode.CONSTANT, value=(3e9, -9.0, 0.5)), M.write())),
    "pointwise_ring": (kp, lambda M, a: (M.circular_batch_read(a((3, 6, 10, 3)), first=-1),
                                         M.multiply(3.0), M.split_tensor())),
}


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64], ids=["i64", "f64"])
@pytest.mark.parametrize("head", list(PLAIN_HEADS))
def test_plain_versions_read_a_64bit_source_as_its_canonical_dtype(head, dtype):
    """Each kernel's plain version on an int64 or float64 CPU tensor equals
    the plain version on its ``.int()`` or ``.float()`` twin bit for bit; the
    plan reads the 64-bit tensor (its source type code) and its chain starts
    from the canonical dtype."""
    module, ops = PLAIN_HEADS[head]
    rng = np.random.default_rng(10)
    made = {}

    def src(shape):
        v = _i64(rng, shape) if dtype == torch.int64 else _f64(rng, shape, 1e3)
        made["t"] = torch.from_numpy(v)
        return made["t"]

    p = T.build_pipeline(*ops(T, src))
    plan = module.build_plan(p)
    assert plan.src_dtype == dtype
    got = module.run(p, plan, CPU)
    twin = T.build_pipeline(*ops(T, lambda shape: tdt.canonicalize(made["t"])))
    want = module.run(twin, module.build_plan(twin), CPU)
    assert plan.out_dtype == module.build_plan(twin).out_dtype
    _bits_equal(got.numpy(), want.numpy())


def test_the_divergent_plain_version_reads_a_float64_source_as_float32():
    """K6 takes a float64 group (read at load as float32) and an int64 group
    (its low 32 bits read at load as int32's, in the general instance). Both
    equal the float32 and int32 twins bit for bit, the int64 one through the
    plain version and through the eager merge."""
    rng = np.random.default_rng(11)
    ring = torch.from_numpy(_f64(rng, (4, 5, 6, 3)))
    seq = T.build_operation_sequence

    def seqs(r):
        return (seq(T.circular_batch_read(r, first=1), T.multiply(0.5), T.write_tensor()),
                seq(T.image(r), T.convert_to(np.float32), T.write_tensor()))

    ids = [1, 2, 2, 1]
    plan = kd.build_plan(seqs(ring), ids)
    assert {g.src_dtype for g in plan.groups} == {torch.float64}
    got = kd.run(seqs(ring), plan, CPU)
    _bits_equal(got.numpy(), kd.run(seqs(ring.float()), kd.build_plan(seqs(ring.float()), ids),
                                    CPU).numpy())
    assert not plan.general
    wide = torch.from_numpy(_i64(rng, (4, 5, 6, 3)))
    plan = kd.build_plan(seqs(wide), ids)
    assert {g.src_dtype for g in plan.groups} == {torch.int64} and plan.general
    twin = kd.build_plan(seqs(wide.int()), ids)
    assert [kd._SRC_WORDS[g.src_dtype] for g in (*plan.groups, *twin.groups)] == [8, 8, 7, 7]
    _bits_equal(kd.run(seqs(wide), plan, CPU).numpy(), kd.run(seqs(wide.int()), twin, CPU).numpy())
    got = T.launch_divergent_batch(ids, *seqs(wide))
    _bits_equal(got.numpy(), T.launch_divergent_batch(ids, *seqs(wide.int())).numpy())


# ---------------------------------------------------------------------------
# the kernels' sources
# ---------------------------------------------------------------------------


def _body(text, start):
    """The body of the function whose definition starts with ``start``."""
    depth, j = 0, text.index("{", text.index(start))
    for k in range(j, len(text)):
        depth += {"{": 1, "}": -1}.get(text[k], 0)
        if depth == 0:
            return text[j:k]
    raise AssertionError(f"no body after {start}")


def test_every_source_code_is_a_named_case():
    """``SRC_CODES`` matches ``chain.cuh``'s enum; the pointwise kernel's
    readers name every source type (a code without a case would read
    nothing), the 64-bit ones in the wide instances that the launch takes
    for them, and a border's value is cast for each; K1, K2 and the warp
    kernel launch an instance for each and take the codes up to PW_F64."""
    enum = dict(re.findall(r"(PW_[A-Z0-9]+) = (\d+)", (CSRC / "chain.cuh").read_text()))
    names = {torch.uint8: "PW_U8", torch.int8: "PW_I8", torch.uint16: "PW_U16",
             torch.int16: "PW_I16", torch.float32: "PW_F32", torch.float16: "PW_F16",
             torch.int32: "PW_I32", torch.int64: "PW_I64", torch.float64: "PW_F64"}
    assert {names[t]: str(c) for t, c in kbr.SRC_CODES.items()} == enum
    cuh = (CSRC / "pointwise.cuh").read_text()
    for fn in ("void load_run_typed", "void read_base_row", "float cast_to_type"):
        body = _body(cuh, fn)
        for name in names.values():
            assert f"case {name}:" in body, (fn, name)
    assert "const bool wide = h.src_type == PW_I64 || h.src_type == PW_F64;" in \
        (CSRC / "pointwise.cu").read_text()
    for src, fn in (("batch_resize.cu", "batch_resize"), ("frame_resize.cu", "frame_resize"),
                    ("warp.cu", "warp")):
        text = (CSRC / src).read_text()
        assert "src_type > PW_F64" in text and "out_type > PW_I32" in text
        for tag in ("i8", "u16", "i16", "f16", "i32", "i64", "f64"):
            assert f"cvgs::{fn}_{tag}(a)" in text, (src, tag)
    assert "h.src_type > PW_F64" in (CSRC / "pointwise.cu").read_text()
    sources = (CSRC / "sources.cuh").read_text()
    for tag, ctype, unit in (("i64", "long long", "source_int64.cu"),
                             ("f64", "double", "source_float64.cu")):
        assert f"CVGS_DECLARE({tag})" in sources
        assert f"CVGS_SOURCE({ctype}, {tag})" in (CSRC / unit).read_text()
    # K6's descriptor words: one per source dtype; the general instance's
    # reader names each but float32's, which it reads where no case matches
    kernel = (CSRC / "divergent_kernel.cuh").read_text()
    words = dict(re.findall(r"(S_[A-Z0-9]+) = (\d+)", kernel))
    assert words == {"S_F32": "0", "S_U8": "1", "S_F64": "2", "S_I8": "3", "S_U16": "4",
                     "S_I16": "5", "S_F16": "6", "S_I32": "7", "S_I64": "8"}
    assert {names[t].replace("PW_", "S_"): str(w) for t, w in kd._SRC_WORDS.items()} == words
    reader = _body(kernel, "void with_source")
    for word in words:
        assert (f"case {word}:" in reader) == (word != "S_F32"), word
