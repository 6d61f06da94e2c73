"""A ``BatchRead`` of nested planes (a second resampling node, or a fused
read above the core) that share one shape but differ in geometry, in one
launch of the composed kernel, on the CPU: which batches it takes, its
plain version against the JAX package and the port's eager lowering, and
the plan's per-plane heads, each with its own middle image, second-level
tap tables and staging choice (``stage2``).

- Routing, decided on the host: NM1-NM4
  (``torch_composed_cases.nested_mixed_cases``: top views of cameras of
  three sizes resized, ragged; normalized letterboxes of regions of three
  sizes; cameras resized to half their size and rotated; crops of three
  sizes of a downscale resized to a square) over each source family are
  taken by ``cuda_composed.build_plan`` as a mixed-geometry nested plan
  (``plan.core2``, ``plan.word("batch") == MIXED``), and
  ``executor._select(..., CUDA)`` names ``cuda:composed``.
- Parity: each built with the JAX factories and carried across with
  ``from_jax``: ``composed_reference`` bit for bit the port's eager lowering
  and the reference's op-by-op lowering, and the reference's jitted XLA
  path within 1e-4 on the 0..255 scale (an NV12 family within one uint8
  step of its converted taps, as C8).
- The plan: each plane's head (``NESTED_INTS`` words) first in the consts,
  then the op tables and FusedRead2's, then each plane's two tap tables; its
  own ``mid_h``, ``mid_w``, ``taps2_off`` and ``stage2`` (NM4 holds both
  values); new values build no plan, a changed size one; ``work`` sums the
  planes.
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
N = len(cc.MIXED_SIZES)
#: each case's two levels: (core, core2)
LEVELS = {"nm1": ("warp", "resize"), "nm2": ("resize", "none"), "nm3": ("resize", "warp"),
          "nm4": ("resize", "resize")}


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
    if family == "nv12":
        return (1 / 255.0) * (1.0 if name.startswith("nm2") else 1 / min(cc.STD)) + 1e-5
    return F32_TOL * max(1.0, float(np.abs(x).max()) / 255)


def _plan(name, family="uint8", seed=1, **kw):
    ops = cc.nested_mixed_cases(T, cc.mixed_frames(family, seed), **kw)[name]
    p = T.build_pipeline(*ops)
    return p, kc.build_plan(p)


# --- routing ---------------------------------------------------------------------


@pytest.mark.parametrize("family", cc.FAMILIES)
@pytest.mark.parametrize("name", cc.NESTED_MIXED_NAMES)
def test_each_nested_mixed_batch_takes_the_kernel(name, family):
    ops = cc.nested_mixed_cases(T, cc.mixed_frames(family, 1))[name]
    plan = kc.build_plan(T.build_pipeline(*ops))
    assert (plan.core, plan.core2) == LEVELS[name[:3]]
    assert plan.batch and plan.n_planes == N and plan.word("batch") == kc.MIXED
    assert len(plan.planes) == N and all(len(q.head) == kc.NESTED_INTS for q in plan.planes)
    assert len(plan.head_words()) == N * kc.NESTED_INTS
    assert plan.base == ("yuv" if family == "nv12" else "image")
    assert (plan.word("used_off") >= 0) == ("ragged" in name)
    assert _backend(ops) == "cuda:composed"
    assert _backend(ops, T.ParBackend.CUDA) == "cuda:composed"


@pytest.mark.parametrize("family", cc.FAMILIES)
def test_each_family_has_its_nested_mixed_instances(family):
    """A nested batch of mixed geometry launches its source kind's mixed
    nested instances (``composed_kernel_nested_mixed``, the staged one
    where any plane stages), which ``launch_nested`` launches for a
    ``CM_MIXED`` head, from the file of the kind's other nested instances,
    and the C entry accepts and checks a ``CM_MIXED`` head plane by plane
    (and a divergent batch's ``CM_DIVERGENT`` one)."""
    from cvgpuspeedup_tpu_torch.exec import _build

    csrc = _build.PACKAGE_DIR / "csrc"
    want, src = {"uint8": ("composed_nested.cu", "uint8_t"),
                 "float32": ("composed_nested_f32.cu", "float"),
                 "int16": ("composed_nested_any.cu", "kc::AnyType"),
                 "nv12": ("composed_nested_nv12.cu", "kc::Nv12")}[family]
    assert csrc / want in _build.SOURCES
    assert f"kc::launch_nested<{src}>(a)" in (csrc / want).read_text()
    launch = (csrc / "composed_nested.cuh").read_text().split("void launch_nested(")[1]
    for instance in ("composed_kernel_nested_mixed<Src, false>",
                     "composed_kernel_nested_mixed_staged<Src>",
                     "composed_kernel_nested_mixed<Src, true>"):
        assert instance in launch
    assert "n.h.batch == CM_MIXED" in launch
    entry = (csrc / "composed_nested.cu").read_text().split("cvgs_composed_nested(")[1]
    assert "h.batch > CM_DIVERGENT" in entry and "same_nested(n, p)" in entry
    for name in cc.NESTED_MIXED_NAMES:
        plan = _plan(name, family, 14)[1]
        assert plan.core2 and plan.base == ("yuv" if family == "nv12" else "image")


# --- parity ----------------------------------------------------------------------


@pytest.mark.parametrize("family", cc.FAMILIES)
@pytest.mark.parametrize("name", cc.NESTED_MIXED_NAMES)
def test_plain_version_against_the_reference(name, family):
    """Bit for bit the port's eager lowering and the reference's op-by-op
    lowering; within the stated tolerance of its jitted XLA path."""
    jops = cc.nested_mixed_cases(J, cc.mixed_frames(family, 3))[name]
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    plan = kc.build_plan(p)
    assert plan.core2 and plan.word("batch") == kc.MIXED
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
def test_a_ragged_nested_mixed_batch_against_the_reference(used, default):
    """NM1 with ``used_planes`` 0, 1, N, N + 2 and -1 and defaults on the
    float32 read value: the planes past it hold the default through the
    chain, as the reference's XLA path and lowering hold them."""
    f = cc.mixed_frames("uint8", 4)
    jops = cc.nested_mixed_cases(J, f, used=used, default=default)[
        "nm1_top_views_of_cameras_of_3_sizes_ragged"]
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    (got,) = _arrays(kc.run(p, kc.build_plan(p), CPU))
    (lowered,) = _arrays(jp.lower())
    (xla,) = _arrays(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    np.testing.assert_array_equal(_bits(got), _bits(lowered))
    assert np.abs(got.astype(np.float64) - xla).max() <= _tol(xla, "uint8", "nm1")


@pytest.mark.parametrize("dtype", ["int8", "uint16", "float16", "int32", "float64"])
@pytest.mark.parametrize("name", cc.NESTED_MIXED_NAMES)
def test_plain_version_equals_the_eager_lowering_on_other_dtypes(name, dtype):
    """The source dtypes beside the four families: the shared instance's
    other types, int32 (the float32 instance) and float64, read at load."""
    f = cc.mixed_frames(dtype, 5)
    f = {**f, "cams": [torch.from_numpy(c) for c in f["cams"]], "big": torch.from_numpy(f["big"])}
    ops = cc.nested_mixed_cases(T, f)[name]
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    assert plan.word("batch") == kc.MIXED and str(plan.src_dtype) == f"torch.{dtype}"
    got = _arrays(kc.run(p, plan, CPU))
    for g, e in zip(got, _arrays(T.execute_operations(*ops, device="cpu")), strict=True):
        assert g.shape == e.shape and g.dtype == e.dtype
        np.testing.assert_array_equal(_bits(g), _bits(e))


# --- the plan ----------------------------------------------------------------------


def test_each_plane_s_head_holds_its_geometry():
    """The consts hold each plane's nested head first (``NESTED_INTS`` words
    a plane, what the kernel's block copies), then the op tables and
    FusedRead2's, then each plane's core taps and second-level taps, where
    its head points: NM4's middle image (a crop of its own size), its
    second resample's edge rule and taps from ``axis_taps`` of that size,
    and its own ``stage2`` (``tap_share`` of those taps)."""
    f = cc.mixed_frames("uint8", 6)
    p = T.build_pipeline(*cc.nested_mixed_cases(T, f)["nm4_roi_crops_of_a_downscale"])
    plan = kc.build_plan(p)
    heads = plan.tables[:N * kc.NESTED_INTS].reshape(N, kc.NESTED_INTS)
    assert [tuple(int(v) for v in h) for h in heads] == [q.head for q in plan.planes]
    assert plan.head == plan.planes[0].head and tuple(plan.head_words()) == tuple(heads.ravel())
    side = cc.NM4_SIDE
    mw, mh = cc.NM4_MID
    at = N * kc.NESTED_INTS
    assert {q.word("in_ops_off") for q in plan.planes} == {at}
    assert len({q.word("mid_ops_off") for q in plan.planes}) == 1
    offsets = []
    for z, (q, cam, (cw, ch)) in enumerate(zip(plan.planes, f["cams"], cc.NM4_CROPS)):
        h, w = cam.shape[:2]
        assert q.head[1:4] == (h, w, 3) and q.src_numel == cam.size
        assert (q.word("in_h"), q.word("in_w"), q.word("core_h"), q.word("core_w")) == (h, w, mh, mw)
        assert (q.word("mid_h"), q.word("mid_w")) == (ch, cw)
        assert (q.word("core2_h"), q.word("core2_w")) == (side, side)
        keep = keeps_edge_weight(ch, cw, T.Size(side, side))
        assert q.word("keep_edge2") == int(keep)
        t2 = q.word("taps2_off")
        tx, ty = axis_taps(cw, side, keep), axis_taps(ch, side, keep)
        np.testing.assert_array_equal(plan.tables[t2:t2 + 2 * side], np.concatenate(tx[:2]))
        np.testing.assert_array_equal(plan.tables[t2 + 2 * side:t2 + 4 * side],
                                      np.concatenate(ty[:2]))
        taps2 = plan.tables[t2:t2 + 6 * side]
        share = kc.tap_share(taps2, side, side, keep)
        assert q.word("stage2") == int(share <= kc.STAGE_SHARE)
        assert q.word("taps_off") < t2 and q.word("batch") == kc.MIXED
        offsets.append((q.word("taps_off"), t2))
    flat = [o for pair in offsets for o in pair]
    assert flat == sorted(flat) and len(set(flat)) == 2 * N


def test_one_batch_holds_both_stage2_values():
    """NM4's crops: a crop smaller than the output is an upscale whose
    tiles share taps (``stage2`` 1), a larger one a downscale (0); the
    host's mirror of the kernel gives each plane's blocks its own form."""
    for family in cc.FAMILIES:
        p, plan = _plan("nm4_roi_crops_of_a_downscale", family, 7)
        stage = [q.word("stage2") for q in plan.planes]
        assert stage == [1, 0, 1], (family, stage)
        forms = kc.nested_tiles(kc.prepare(p, plan, CPU))[..., 0]
        assert (forms[1] == kc.TILE_FORMS.index("per_tap")).all()
        assert (forms[[0, 2]] == kc.TILE_FORMS.index("staged")).all()
    stage = {name: {q.word("stage2") for q in _plan(name)[1].planes}
             for name in cc.NESTED_MIXED_NAMES}
    assert stage == {"nm1_top_views_of_cameras_of_3_sizes_ragged": {0},
                     "nm2_normalized_letterboxes_of_rois": {0},
                     "nm3_half_size_resize_then_rotate": {1},
                     "nm4_roi_crops_of_a_downscale": {0, 1}}


@pytest.mark.parametrize("name", cc.NESTED_MIXED_NAMES)
def test_new_values_build_no_plan(name):
    """New frames of the same sizes and moved values (maps, origins,
    angles, the border value, ``used_planes``): one key, one plan, and the
    plan of the first values runs the second ones as the eager lowering."""
    p0 = T.build_pipeline(*cc.nested_mixed_cases(T, cc.mixed_frames("uint8", 7))[name])
    ops1 = cc.nested_mixed_cases(T, cc.mixed_frames("uint8", 8), 1)[name]
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
    which later calls at those sizes reuse, its middle image the camera's
    own."""
    name = "nm1_top_views_of_cameras_of_3_sizes_ragged"
    sizes = list(cc.MIXED_SIZES)
    p0 = T.build_pipeline(*cc.nested_mixed_cases(T, cc.mixed_frames("uint8", 9))[name])
    executor._plan(p0, flatten(p0)[0], T.ParBackend.AUTO, CUDA)
    sizes[1] = (50, 66)
    builds = executor.PLAN_BUILDS
    plans = []
    for seed in (10, 11):
        f = cc.mixed_frames("uint8", seed, tuple(sizes))
        p = T.build_pipeline(*cc.nested_mixed_cases(T, f)[name])
        plans.append(executor._plan(p, flatten(p)[0], T.ParBackend.AUTO, CUDA))
    assert executor.PLAN_BUILDS == builds + 1 and plans[0] is plans[1]
    q = plans[0].kernel.planes[1]
    assert q.head[1:3] == (50, 66) and (q.word("mid_h"), q.word("mid_w")) == (50, 66)


@pytest.mark.parametrize("family", ["uint8", "nv12"])
@pytest.mark.parametrize("name", cc.NESTED_MIXED_NAMES)
def test_work_sums_the_planes(name, family):
    """``work`` of a nested mixed batch: each plane's own sectors and
    operations (its core values the second level's taps need), the sum of
    the one-plane batches of its planes (NM2's regions of one frame: a
    sector two planes read counts once); a held plane reads nothing."""
    f = cc.mixed_frames(family, 12)
    ops = cc.nested_mixed_cases(T, f)[name]
    planes = list(ops[0].ops)
    whole_ops = (T.batch_read(planes), *ops[1:])
    p = T.build_pipeline(*whole_ops)
    whole = kc.work(kc.prepare(p, kc.build_plan(p), CPU))
    parts = []
    for plane in planes:
        q = T.build_pipeline(T.batch_read([plane]), *ops[1:])
        parts.append(kc.work(kc.prepare(q, kc.build_plan(q), CPU)))
    total = tuple(sum(w[k] for w in parts) for k in range(3))
    if name.startswith("nm2"):
        assert whole[::2] == total[::2]
        assert max(w[1] for w in parts) <= whole[1] < total[1]
    else:
        assert whole == total
    ragged = T.build_pipeline(T.batch_read(planes, used_planes=1, default=0.0), *ops[1:])
    out_bytes, src, _ = kc.work(kc.prepare(ragged, kc.build_plan(ragged), CPU))
    assert out_bytes == whole[0] and src == parts[0][1]


@pytest.mark.parametrize("name", ["n2_resize_then_rotate", "n3_two_level_downscale",
                                  "n5_letterbox_of_a_normalized_resize",
                                  "n6_top_views_of_8_cameras_ragged"])
def test_a_batch_of_one_geometry_keeps_its_plan(name):
    """Nested planes of one geometry keep the plan of one head (no
    per-plane heads), as before; the same batch through a mixed plan of
    equal heads (what ``chip_smoke.py`` times to price the plane head in
    shared memory) computes the same values."""
    ops = cc.nested_cases(T, cc.nested_frames(36, 48, 15))[name]
    if not name.startswith("n6"):
        ops = (T.batch_read([ops[0]]), *ops[1:])
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    assert plan.core2 and plan.planes == () and plan.word("batch") == 1
    forced = kc._mixed([plan] * plan.n_planes)
    assert forced.word("batch") == kc.MIXED
    assert len(forced.head_words()) == plan.n_planes * kc.NESTED_INTS
    for g, w in zip(_arrays(kc.run(p, forced, CPU)), _arrays(kc.run(p, plan, CPU)), strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
