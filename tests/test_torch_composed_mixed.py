"""A ``BatchRead`` whose planes share one shape but differ in geometry, in
one launch of the composed kernel, on the CPU: which batches it takes, its
plain version against the JAX package and the port's eager lowering, the
plan's per-plane heads, and what it refuses.

- Routing, decided on the host: M1-M6 (``torch_composed_cases.mixed_cases``:
  cameras of three resolutions resized, ragged or not, regions of interest
  of three sizes resized, letterboxes of their own inner sizes and border
  widths, warps of crops of three sizes, crops of one size from the three
  cameras) over each source family (uint8, float32, int16 for the shared
  "any" instance, NV12 buffers converted into uint8 RGB per tap as C8) are
  taken by ``cuda_composed.build_plan`` as a mixed-geometry plan (its
  ``batch`` word ``MIXED``), and ``executor._select(..., CUDA)`` names
  ``cuda:composed``.
- Parity: each built with the JAX factories and carried across with
  ``from_jax``: ``composed_reference`` bit for bit the port's eager lowering
  and the reference's op-by-op lowering, and the reference's jitted XLA
  path within 1e-4 on the 0..255 scale (integer outputs bit for bit; an
  NV12 family within one uint8 step of its converted taps, as C8: XLA
  contracts the YUV sums into FMAs on the CPU).
- The plan: each plane's head (its base's size, its stages' and its core's
  sizes, its edge rule) and its own tap tables in the consts; new frames,
  origins and coefficients build no plan, one changed size one; ``work``
  sums each plane's own sectors and operations.
- Refusals: planes that differ in op type, border mode, warp type, chain
  structure, source dtype, channels or output size, and nested planes whose
  second levels differ, raise ``Unsupported`` naming what differs, which
  ``ParBackend.CUDA`` repeats (nested planes that differ in geometry alone
  are ``tests/test_torch_composed_nested_mixed.py``'s).
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import flatten
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.ops.resize import axis_taps, keeps_edge_weight
import torch_composed_cases as cc

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # only named: the routing is decided on shapes
F32_TOL = 1e-4               # against the jitted XLA path, on values of 0..255
CORES = {"m5": "warp", "m6": "none"}
N = len(cc.MIXED_SIZES)


def _backend(ops, backend=T.ParBackend.AUTO):
    return executor._select(T.build_pipeline(*ops), backend, CUDA).backend


def _arrays(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out]


def _bits(a):
    if a.dtype.kind == "f":
        return a.view(np.int32 if a.itemsize == 4 else np.int16)
    return a


def _tol(x, family: str, name: str) -> float:
    """The tolerance against the XLA path: 1e-4 on the 0..255 scale; for
    an NV12 family one uint8 step of a converted tap through the chain
    (x / 255, then / STD for a normalized output)."""
    if x.dtype.kind != "f":
        return 0.0
    if family == "nv12":
        return (1 / 255.0) * (1.0 if name.startswith("m4") else 1 / min(cc.STD)) + 1e-5
    return F32_TOL * max(1.0, float(np.abs(x).max()) / 255)


# --- routing -------------------------------------------------------------------


@pytest.mark.parametrize("family", cc.FAMILIES)
@pytest.mark.parametrize("name", cc.MIXED_NAMES)
def test_each_mixed_batch_takes_the_kernel(name, family):
    ops = cc.mixed_cases(T, cc.mixed_frames(family, 1))[name]
    plan = kc.build_plan(T.build_pipeline(*ops))
    assert plan.batch and plan.n_planes == N and plan.word("batch") == kc.MIXED
    assert plan.core == CORES.get(name[:2], "resize")
    assert plan.base == ("yuv" if family == "nv12" else "image")
    assert len(plan.planes) == N and [q.dsize for q in plan.planes] == [plan.dsize] * N
    assert (plan.word("used_off") >= 0) == ("ragged" in name)
    assert _backend(ops) == "cuda:composed"
    assert _backend(ops, T.ParBackend.CUDA) == "cuda:composed"


@pytest.mark.parametrize("family", cc.FAMILIES)
def test_each_family_has_its_mixed_instances(family):
    """A mixed-geometry batch launches its source kind's mixed-geometry
    instances (a resample's, a one-pixel read's: ``composed_kernel_mixed``,
    which ``launch_source`` launches for a ``CM_MIXED`` head), from the file
    of the kind's other instances, compiled into the library."""
    from cvgpuspeedup_tpu_torch.exec import _build

    f = cc.mixed_frames(family, 14)
    want = {"uint8": "composed.cu", "float32": "composed_f32.cu", "int16": "composed_any.cu",
            "nv12": "composed_nv12.cu"}[family]
    assert _build.PACKAGE_DIR / "csrc" / want in _build.SOURCES
    launch = (_build.PACKAGE_DIR / "csrc" / "composed.cuh").read_text().split(
        "void launch_source(")[1]
    assert "h.batch == CM_MIXED" in launch and "composed_kernel_mixed<Src, T, 1>" in launch
    for name, taps in (("m1_cameras_resized", 4), ("m5_warps_of_crops", 4),
                       ("m6_crops_of_cameras", 1)):
        plan = kc.build_plan(T.build_pipeline(*cc.mixed_cases(T, f)[name]))
        assert cc.instance(plan) == (want, taps)


def test_a_batch_of_one_geometry_keeps_its_plan():
    """Planes of equal sizes keep the plan of one head (``batch`` 1, no
    per-plane heads), as before."""
    f = cc.mixed_frames("uint8", 2, (cc.MIXED_SIZES[0],) * N)
    p = T.build_pipeline(*cc.mixed_cases(T, f)["m1_cameras_resized"])
    plan = kc.build_plan(p)
    assert plan.word("batch") == 1 and plan.planes == () and plan.for_plane(2) is plan
    assert len(plan.head_words()) == kc.HEAD_INTS
    # the same batch through a mixed plan of N equal heads (what chip_smoke.py
    # times to price the per-plane head) computes the same values
    forced = kc._mixed([plan] * N)
    assert forced.word("batch") == kc.MIXED and len(forced.head_words()) == N * kc.HEAD_INTS
    np.testing.assert_array_equal(_bits(_arrays(kc.run(p, forced, CPU))[0]),
                                  _bits(_arrays(kc.run(p, plan, CPU))[0]))


# --- parity ----------------------------------------------------------------------


@pytest.mark.parametrize("family", cc.FAMILIES)
@pytest.mark.parametrize("name", cc.MIXED_NAMES)
def test_plain_version_against_the_reference(name, family):
    """Bit for bit the port's eager lowering and the reference's op-by-op
    lowering; within the stated tolerance of its jitted XLA path."""
    jops = cc.mixed_cases(J, cc.mixed_frames(family, 3))[name]
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    plan = kc.build_plan(p)
    assert plan.word("batch") == kc.MIXED
    got = _arrays(kc.run(p, plan, CPU))
    eager = _arrays(T.execute_operations(p.read, *p.compute, p.write, device="cpu"))
    lowered = _arrays(jp.lower())
    xla = _arrays(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    for g, e, l, x in zip(got, eager, lowered, xla, strict=True):
        assert g.shape == x.shape and g.dtype == x.dtype, (g.shape, g.dtype, x.shape, x.dtype)
        np.testing.assert_array_equal(_bits(g), _bits(e))
        np.testing.assert_array_equal(_bits(g), _bits(l))
        assert np.abs(g.astype(np.float64) - x.astype(np.float64)).max() <= _tol(x, family, name)


@pytest.mark.parametrize("default", [-1.5, 300.7, (7.0, 260.0, -3.0)])
@pytest.mark.parametrize("used", [0, 1, N, N + 2, -1])
def test_a_ragged_mixed_batch_against_the_reference(used, default):
    """M2 with ``used_planes`` 0, 1, N, N + 2 and -1 and defaults on the
    float32 read value: the planes past it hold the default through the
    chain, as the reference's XLA path and lowering hold them."""
    f = cc.mixed_frames("uint8", 4)
    jops = cc.mixed_cases(J, f, used=used, default=default)["m2_cameras_resized_ragged"]
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    (got,) = _arrays(kc.run(p, kc.build_plan(p), CPU))
    (lowered,) = _arrays(jp.lower())
    (xla,) = _arrays(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    np.testing.assert_array_equal(_bits(got), _bits(lowered))
    assert np.abs(got.astype(np.float64) - xla).max() <= _tol(xla, "uint8", "m2")


@pytest.mark.parametrize("dtype", ["int8", "uint16", "float16", "int32", "float64"])
@pytest.mark.parametrize("name", cc.MIXED_NAMES)
def test_plain_version_equals_the_eager_lowering_on_other_dtypes(name, dtype):
    """The source dtypes beside the four families: the shared instance's
    other types, int32 (the float32 instance) and float64, read at load."""
    f = cc.mixed_frames(dtype, 5)
    f = {**f, "cams": [torch.from_numpy(c) for c in f["cams"]], "big": torch.from_numpy(f["big"])}
    ops = cc.mixed_cases(T, f)[name]
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    assert plan.word("batch") == kc.MIXED and str(plan.src_dtype) == f"torch.{dtype}"
    got = _arrays(kc.run(p, plan, CPU))
    for g, e in zip(got, _arrays(T.execute_operations(*ops, device="cpu")), strict=True):
        assert g.shape == e.shape and g.dtype == e.dtype
        np.testing.assert_array_equal(_bits(g), _bits(e))


# --- the plan ----------------------------------------------------------------------


def test_each_plane_s_head_holds_its_geometry():
    """The consts hold each plane's head first, ``HEAD_INTS`` words a plane
    (what the kernel's block copies), then the op tables, then each plane's
    tap tables, where its head points: its base's size, its core's source
    and output, its edge rule and taps from ``axis_taps`` of its sizes."""
    f = cc.mixed_frames("uint8", 6)
    p = T.build_pipeline(*cc.mixed_cases(T, f)["m1_cameras_resized"])
    plan = kc.build_plan(p)
    heads = plan.tables[:N * kc.HEAD_INTS].reshape(N, kc.HEAD_INTS)
    assert [tuple(int(v) for v in h) for h in heads] == [q.head for q in plan.planes]
    assert plan.head == plan.planes[0].head and tuple(plan.head_words()) == tuple(heads.ravel())
    dw, dh = cc.MIXED_DST
    offsets = []
    for z, (q, cam) in enumerate(zip(plan.planes, f["cams"])):
        h, w = cam.shape[:2]
        assert q.head[1:4] == (h, w, 3) and q.src_numel == cam.size
        assert (q.word("in_h"), q.word("in_w"), q.word("core_h"), q.word("core_w")) == (
            h, w, dh, dw)
        keep = keeps_edge_weight(h, w, T.Size(dw, dh))
        assert q.word("keep_edge") == int(keep)
        at = q.word("taps_off")
        tx, ty = axis_taps(w, dw, keep), axis_taps(h, dh, keep)
        np.testing.assert_array_equal(plan.tables[at:at + 2 * dw], np.concatenate(tx[:2]))
        np.testing.assert_array_equal(plan.tables[at + 2 * dw:at + 2 * (dw + dh)],
                                      np.concatenate(ty[:2]))
        offsets.append(at)
        assert q.word("in_ops_off") == N * kc.HEAD_INTS and q.word("batch") == kc.MIXED
    assert offsets == sorted(offsets) and len(set(offsets)) == N


@pytest.mark.parametrize("name", cc.MIXED_NAMES)
def test_new_values_build_no_plan(name):
    """New frames of the same sizes and moved values (origins, angles, the
    border value, ``used_planes``): one key, one plan, and the plan of the
    first values runs the second ones as the eager lowering."""
    p0 = T.build_pipeline(*cc.mixed_cases(T, cc.mixed_frames("uint8", 7))[name])
    ops1 = cc.mixed_cases(T, cc.mixed_frames("uint8", 8), 1)[name]
    p1 = T.build_pipeline(*ops1)
    k0, k1 = flatten(p0)[0], flatten(p1)[0]
    assert k0 == k1
    builds = executor.PLAN_BUILDS
    plan = executor._plan(p0, k0, T.ParBackend.AUTO, CUDA)
    assert executor._plan(p1, k1, T.ParBackend.AUTO, CUDA) is plan
    assert plan.backend == "cuda:composed" and executor.PLAN_BUILDS <= builds + 1
    got = _arrays(kc.run(p1, plan.kernel, CPU))
    for g, w in zip(got, _arrays(T.execute_operations(*ops1, device="cpu")), strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_one_changed_size_builds_one_plan():
    """A camera of another resolution is a new geometry: exactly one plan,
    which later calls at those sizes reuse."""
    sizes = list(cc.MIXED_SIZES)
    p0 = T.build_pipeline(*cc.mixed_cases(T, cc.mixed_frames("uint8", 9))["m1_cameras_resized"])
    executor._plan(p0, flatten(p0)[0], T.ParBackend.AUTO, CUDA)
    sizes[1] = (50, 66)
    builds = executor.PLAN_BUILDS
    plans = []
    for seed in (10, 11):
        f = cc.mixed_frames("uint8", seed, tuple(sizes))
        p = T.build_pipeline(*cc.mixed_cases(T, f)["m1_cameras_resized"])
        plans.append(executor._plan(p, flatten(p)[0], T.ParBackend.AUTO, CUDA))
    assert executor.PLAN_BUILDS == builds + 1 and plans[0] is plans[1]
    assert plans[0].kernel.planes[1].head[1:3] == (50, 66)


@pytest.mark.parametrize("family", ["uint8", "nv12"])
@pytest.mark.parametrize("name", ["m1_cameras_resized", "m5_warps_of_crops",
                                  "m6_crops_of_cameras"])
def test_work_sums_the_planes(name, family):
    """``work`` of a mixed batch: each plane's own sectors (a resize's and
    a one-pixel read's from its tap tables, a warp's from the plain
    version's positions) and operations, the sum of the one-plane batches
    of its cameras; a held plane reads nothing."""
    f = cc.mixed_frames(family, 12)
    ops = cc.mixed_cases(T, f)[name]
    p = T.build_pipeline(*ops)
    whole = kc.work(kc.prepare(p, kc.build_plan(p), CPU))
    parts = []
    for plane in ops[0].ops:
        q = T.build_pipeline(T.batch_read([plane]), *ops[1:])
        parts.append(kc.work(kc.prepare(q, kc.build_plan(q), CPU)))
    assert whole == tuple(sum(w[k] for w in parts) for k in range(3))
    ragged = T.build_pipeline(T.batch_read(list(ops[0].ops), used_planes=1, default=0.0),
                              *ops[1:])
    out_bytes, src, _ = kc.work(kc.prepare(ragged, kc.build_plan(ragged), CPU))
    assert out_bytes == whole[0] and src == parts[0][1]


# --- refusals ----------------------------------------------------------------------


def _refused():
    rng = np.random.default_rng(13)
    a = rng.integers(0, 256, (29, 37, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    m = cc.rotation((18, 14), 10.0)
    persp = np.vstack([m, [0.0, 0.0, 1.0]])
    dst = T.Size(16, 12)

    def lb(img, t, mode=T.BorderMode.CONSTANT):
        return T.make_border(T.resize(T.image(img), T.Size(16, 10 - 2 * t)), 3 + t, 3 + t, 0, 0,
                             mode, 114)

    # nested planes whose second levels differ: a resize beside a warp
    nested = [T.resize(T.resize(T.image(a), T.Size(30, 20)), dst),
              T.warp(T.resize(T.image(b), T.Size(30, 20)), m, dst)]
    return {
        "op types": [T.resize(T.image(a), dst), T.resize(T.crop(T.image(b), T.Rect(1, 1, 30, 20)),
                                                         dst)],
        "border mode": [lb(a, 0), lb(b, 1, T.BorderMode.REFLECT)],
        "warp type": [T.warp(T.image(a), m, dst),
                      T.warp(T.image(b), persp, dst, warp_type=T.WarpType.PERSPECTIVE)],
        "chain structure": [T.resize(T.fuse(T.image(a), T.multiply(2.0)), dst),
                            T.resize(T.fuse(T.image(b), T.add(2.0)), dst)],
        "source dtype": [T.resize(T.image(a), dst), T.resize(T.image(b.astype(np.float32)), dst)],
        "channels": [T.resize(T.image(b), dst), T.resize(T.image(gray), dst)],
        "output size": [T.resize(T.image(a), dst), T.resize(T.image(b), T.Size(16, 14))],
        "nested": nested,
    }


@pytest.mark.parametrize("what", list(_refused()))
def test_what_differs_is_named(what):
    """Planes that differ in more than geometry (nested planes whose
    second levels differ among them) raise ``Unsupported`` naming it;
    ``ParBackend.CUDA`` repeats the composed kernel's reason; the batch
    stays eager."""
    planes = _refused()[what]
    ops = (T.batch_read(planes), T.split_tensor())
    p = T.build_pipeline(*ops)
    match = ("planes 0 and 1 of a BatchRead differ in op types \\(ResizeRead and WarpRead\\)"
             if what == "nested" else f"planes 0 and 1 of a BatchRead differ in {what}")
    with pytest.raises(kc.Unsupported, match=match):
        kc.build_plan(p)
    with pytest.raises(ValueError, match=f"cuda:composed: {match}"):
        _backend(ops, T.ParBackend.CUDA)
    if what != "output size":  # planes of two output sizes stack nowhere
        assert _backend(ops) == "torch"
