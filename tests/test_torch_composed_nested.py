"""The composed kernel's nested plans on the CPU: a second resampling node
(``resize(warp)``, ``warp(resize)``, ``resize(resize)``, crops and borders
between the two) or a fused read above the core, and batches of such
planes, in one launch.

- Routing, decided on the host: N1-N6 (``torch_composed_cases.nested_cases``)
  and the other two-level trees (``more_nested_cases``) are taken by
  ``cuda_composed.build_plan`` as nested plans (``plan.core2``) and
  ``executor._select(..., CUDA)`` names ``cuda:composed``.
- Parity: built with the JAX factories and carried across with
  ``from_jax``: ``composed_reference`` bit for bit the reference's op-by-op
  lowering and within 1e-4 of its jitted XLA path (uint8 within 1); bit for
  bit (as int32 bits) the port's eager lowering on seven source dtypes;
  warp maps with a subnormal coefficient at either level as int32 bits.
- The block: the second level's values inside a plane's stride; new frames,
  maps, origins, border values and ``used_planes`` build no plan; ``work``
  counts the sectors the inner taps under the outer taps a result uses read.
"""

import jax.numpy as jnp
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
H, W = 36, 48
#: each case's two levels: (core, core2)
LEVELS = {"n1": ("warp", "resize"), "n2": ("resize", "warp"), "n3": ("resize", "resize"),
          "n4": ("resize", "resize"), "n5": ("resize", "none"), "n6": ("warp", "resize")}


def _backend(ops, backend=T.ParBackend.AUTO):
    return executor._select(T.build_pipeline(*ops), backend, CUDA).backend


def _arrays(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out]


def _bits(a):
    if a.dtype.kind == "f":
        return a.view(np.int32 if a.itemsize == 4 else np.int16)
    return a


def _more(M):
    return cc.more_nested_cases(M, jnp.asarray(300.0, jnp.float32) if M is J else 300.0)


# --- routing ----------------------------------------------------------------------


@pytest.mark.parametrize("name", cc.NESTED_NAMES)
def test_each_nested_case_takes_the_kernel(name):
    ops = cc.nested_cases(T, cc.nested_frames(H, W))[name]
    plan = kc.build_plan(T.build_pipeline(*ops))
    assert (plan.core, plan.core2) == LEVELS[name[:2]]
    assert plan.batch == (name[:2] == "n6")
    assert len(plan.head) == kc.NESTED_INTS
    assert _backend(ops) == "cuda:composed"
    assert _backend(ops, T.ParBackend.CUDA) == "cuda:composed"


@pytest.mark.parametrize("name", list(cc.more_nested_cases(T)))
def test_each_other_nested_composition_takes_the_kernel(name):
    ops = cc.more_nested_cases(T)[name]
    assert kc.build_plan(T.build_pipeline(*ops)).core2
    assert _backend(ops) == "cuda:composed"


def test_the_plan_is_made_on_shapes_alone():
    """Meta tensors at full width: N3's plan reads shapes and dtypes, each
    level's edge rule from its own source's size."""
    big = torch.empty((2160, 3840, 3), dtype=torch.uint8, device="meta")
    ops = (T.resize(T.resize(T.image(big), T.Size(1920, 1080)), T.Size(640, 360)),
           *cc.normalize(T), T.split_tensor())
    assert _backend(ops) == "cuda:composed"
    plan = kc.build_plan(T.build_pipeline(*ops))
    assert plan.dsize == T.Size(640, 360) and plan.out_ch == 3
    assert (plan.word("in_h"), plan.word("in_w"), plan.word("core_h")) == (2160, 3840, 1080)
    assert (plan.word("mid_h"), plan.word("mid_w")) == (1080, 1920)
    assert plan.word("keep_edge") == 1 and plan.word("keep_edge2") == 1


def test_a_refusal_names_its_reason():
    """``ParBackend.CUDA`` raises with the composed kernel's refusal."""
    img = np.zeros((36, 48, 3), np.uint8)
    m = cc.rotation((24, 18), 10.0)
    ops = (T.resize(T.warp(T.resize(T.image(img), T.Size(30, 20)), m, T.Size(30, 20)),
                    T.Size(15, 10)),)
    with pytest.raises(ValueError, match="cuda:composed: a third resampling node"):
        _backend(ops, T.ParBackend.CUDA)


# --- parity -----------------------------------------------------------------------


def _against_the_reference(jops, tol_u8=0.0):
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    got = _arrays(kc.run(p, kc.build_plan(p), CPU))
    lowered = _arrays(jp.lower())
    xla = _arrays(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    for g, l, x in zip(got, lowered, xla, strict=True):
        assert g.shape == x.shape and g.dtype == x.dtype, (g.shape, g.dtype, x.shape, x.dtype)
        np.testing.assert_array_equal(g, l)
        if g.dtype.kind == "f":
            tol = F32_TOL * max(1.0, float(np.abs(x).max()) / 255)
        else:
            tol = tol_u8
        assert np.abs(g.astype(np.float64) - x.astype(np.float64)).max() <= tol
    return got


@pytest.mark.parametrize("size", [(36, 48), (54, 96)])
@pytest.mark.parametrize("name", cc.NESTED_NAMES)
def test_plain_version_against_the_reference(name, size):
    """Bit for bit the reference's op-by-op lowering; within 1e-4 of its
    jitted XLA path, which contracts multiply-adds into FMAs on the CPU."""
    _against_the_reference(cc.nested_cases(J, cc.nested_frames(*size, 11))[name])


@pytest.mark.parametrize("name", list(cc.more_nested_cases(T)))
def test_plain_version_of_the_other_nested_compositions_against_the_reference(name):
    """As above; an NV12 conversion into uint8 within 1 of the XLA path (its
    FMAs move the conversion's rounding)."""
    _against_the_reference(_more(J)[name], 1.0 if "nv12" in name else 0.0)


def _as_dtype(x, dtype):
    """A uint8 frame's values as ``dtype``, as ``test_torch_composed.py``
    spreads them; subnormal float32 below 2^-126 in half the values."""
    v = torch.from_numpy(x).int()
    if dtype == "sub_f32":
        mask = torch.from_numpy(np.random.default_rng(12).random(x.shape) < 0.5)
        return torch.where(mask, v.float() * 1e-39, v.float())
    d = getattr(torch, dtype)
    if d == torch.float16:
        return (v.float() / 7).half()
    if d == torch.float64:
        return v.double() * 1.5 - 100.25
    return (v * {torch.uint8: 1, torch.int16: -97, torch.uint16: 251}.get(d, 65537) + 3).to(d)


@pytest.mark.parametrize("dtype", ["uint8", "int16", "uint16", "float16", "int32", "float64",
                                   "sub_f32"])
@pytest.mark.parametrize("name", cc.NESTED_NAMES)
def test_plain_version_equals_the_eager_lowering_bit_for_bit(name, dtype):
    f = cc.nested_frames(H, W, 13)
    f = {"hd": _as_dtype(f["hd"], dtype), "big": _as_dtype(f["big"], dtype),
         "cams": [_as_dtype(c, dtype) for c in f["cams"]]}
    ops = cc.nested_cases(T, f)[name]
    if dtype == "sub_f32":  # a chain whose products flush
        ops = (ops[0], T.multiply(1e-3), *ops[1:])
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    assert plan.src_dtype == f["hd"].dtype
    got = _arrays(kc.run(p, plan, CPU))
    eager = _arrays(T.execute_operations(*ops, device="cpu"))
    for g, e in zip(got, eager, strict=True):
        assert g.shape == e.shape and g.dtype == e.dtype
        np.testing.assert_array_equal(_bits(g), _bits(e))


@pytest.mark.parametrize("name", list(cc.subnormal_map_cases(T, cc.subnormal_source())))
def test_a_warp_map_with_a_subnormal_coefficient_at_either_level(name):
    """The host's numpy terms keep the subnormal coefficient, so a row or
    column reads the infinite border with weight 0 (NaN there): the plain
    version, recomputing the terms from the block at either level, equals
    the reference's XLA path and the port's eager lowering as int32 bits."""
    src = cc.subnormal_source()
    jops = cc.subnormal_map_cases(J, jnp.asarray(src))[name]
    want = np.asarray(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    ops = cc.subnormal_map_cases(T, torch.from_numpy(src))[name]
    p = T.build_pipeline(*ops)
    got = kc.composed_reference(kc.prepare(p, kc.build_plan(p), CPU)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    eager = T.execute_operations(*ops, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), eager.view(np.int32))
    assert np.isnan(want).any()  # the border's weight-0 tap: the case bites


# --- runtime values and the block -----------------------------------------------------


@pytest.mark.parametrize("name", cc.NESTED_NAMES)
def test_new_values_build_no_plan(name):
    """New frames, maps, origins, border value and used_planes: one plan,
    and the plan of the first values runs the second ones as the eager
    lowering."""
    p0, p1 = (T.build_pipeline(*cc.nested_cases(T, cc.nested_frames(H, W, 15 + v), v)[name])
              for v in (0, 1))
    k0, k1 = flatten(p0)[0], flatten(p1)[0]
    assert k0 == k1
    builds = executor.PLAN_BUILDS
    plan = executor._plan(p0, k0, T.ParBackend.AUTO, CUDA)
    assert executor._plan(p1, k1, T.ParBackend.AUTO, CUDA) is plan
    assert plan.backend == "cuda:composed" and executor.PLAN_BUILDS <= builds + 1
    got = _arrays(kc.run(p1, plan.kernel, CPU))
    want = _arrays(T.execute_operations(
        *cc.nested_cases(T, cc.nested_frames(H, W, 16), 1)[name], device="cpu"))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    a0, a1 = (kc.prepare(p, plan.kernel, CPU) for p in (p0, p1))
    assert not torch.equal(a0.block, a1.block) or name[:2] == "n3"


def test_the_block_holds_each_level_s_values_in_a_plane_s_stride():
    """N6: the second level (a resize) has no values, so plane z's words
    are the core's warp coefficients and border, at coef_off + z *
    plane_stride past the 8 planes' addresses; then used_planes and the
    default. N5: the outer border's value, then FusedRead2's scalar. N4:
    the crop between the two resizes is a below stage, its origin the
    block's first words."""
    f = cc.nested_frames(H, W, 17)
    cases = cc.nested_cases(T, f)
    p = T.build_pipeline(*cases["n6_top_views_of_8_cameras_ragged"])
    plan = kc.build_plan(p)
    a = kc.prepare(p, plan, CPU)
    fblk, blk = a.block.view(torch.float32), a.block
    stride, off = plan.word("plane_stride"), plan.word("coef_off")
    assert off == 2 * cc.N6_PLANES and stride == 9 + 3  # 8 addresses; coefficients and border
    for z, o in enumerate(p.read.ops):
        want = torch.as_tensor(o.source.coeffs, dtype=torch.float32).reshape(-1)
        assert torch.equal(fblk[off + z * stride:off + z * stride + want.numel()], want)
    assert int(blk[plan.word("used_off")]) == cc.N6_USED
    assert plan.word("default_off") == plan.word("used_off") + 1
    assert plan.n_block == plan.word("default_off") + 3 + 4
    # N5: the outer border's value, then FusedRead2's scalar (1/255)
    p = T.build_pipeline(*cases["n5_letterbox_of_a_normalized_resize"])
    plan = kc.build_plan(p)
    a = kc.prepare(p, plan, CPU)
    (border,) = plan.stage_list(2)
    assert border[0] == kc.STAGE_BORDER and border[6] == 0
    assert torch.equal(a.block.view(torch.float32)[:3], torch.full((3,), 0.447))
    assert plan.word("mid_fp_off") == 3 and plan.word("mid_n_ops") == 1
    assert float(a.block.view(torch.float32)[3]) == np.float32(1 / 255.0)
    assert plan.value_dtype == torch.float32 and plan.mid_dtype == torch.float32
    # N4: the crop between the two resizes is a below stage of the middle
    p = T.build_pipeline(*cases["n4_crop_of_a_downscale_resized"])
    plan = kc.build_plan(p)
    assert plan.stage_list(3) == [] and len(plan.stage_list(4)) == 1
    a = kc.prepare(p, plan, CPU)
    assert a.block[:2].tolist() == [W // 4, H // 4]


@pytest.mark.parametrize("name", ["n3_two_level_downscale", "n4_crop_of_a_downscale_resized"])
@pytest.mark.parametrize("size", [(36, 48), (54, 96), (60, 90)])
def test_work_counts_the_sectors_of_the_inner_taps_the_outer_taps_use(name, size):
    """Two resizes: the source rows (and columns) read are the inner taps
    (by their edge rule, a second tap of weight 0 dropped) under the outer
    taps a result uses (the same rule), through the crop between them; the
    sectors of their pairings, counted from ``axis_taps`` alone."""
    f = cc.nested_frames(*size, 18)
    ops = cc.nested_cases(T, f)[name]
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    a = kc.prepare(p, plan, CPU)
    h, w = size
    big_w = f["big"].shape[1]
    out = plan.dsize
    mid_h, mid_w = plan.word("mid_h"), plan.word("mid_w")
    keep_in = keeps_edge_weight(2 * h, 2 * w, T.Size(w, h))
    keep_out = keeps_edge_weight(mid_h, mid_w, out)

    def reads(i0, i1, wt, keep):
        return np.unique(np.concatenate([i0, i1[(wt != 0) | (not keep)]]))

    def axis(src_len, core_len, mid_len, out_len, shift):
        """The core's positions the outer taps need, and the base's."""
        outer = reads(*axis_taps(mid_len, out_len, keep_out), keep_out) + shift
        i0, i1, wt = axis_taps(src_len, core_len, keep_in)
        return outer, reads(i0[outer], i1[outer], wt[outer], keep_in)

    dy, dx = (h // 4, w // 4) if name[:2] == "n4" else (0, 0)
    core_rows, rows = axis(2 * h, h, mid_h, out.height, dy)
    core_cols, cols = axis(2 * w, w, mid_w, out.width, dx)
    first = ((rows[:, None] * big_w + cols[None, :]) * 3).reshape(-1)
    want = np.unique(np.concatenate([first // 32, (first + 2) // 32])).size * 32
    out_bytes, src_bytes, flops = kc.work(a)
    assert out_bytes == 3 * out.width * out.height * 4
    assert src_bytes == want == kc._walked_sectors(a)
    # each core value the outer taps need once (12 lerps a channel), then
    # per output value the outer lerps and the chain's 3 rows
    assert kc._core_evals(a) == core_rows.size * core_cols.size
    assert flops == 3 * core_rows.size * core_cols.size * 12 + 3 * out.width * out.height * (
        12 + 3)


def _all_nested():
    out = {}
    for size in ((36, 48), (54, 96)):
        for values in (0, 1):
            f = cc.nested_frames(*size, 7 + values)
            for name, ops in cc.nested_cases(T, f, values).items():
                out[f"{name}_{size[0]}_{values}"] = ops
    out.update(cc.more_nested_cases(T))
    return out


@pytest.mark.parametrize("name", list(_all_nested()))
def test_each_axis_walked_alone_reads_the_sectors_the_taps_read(name):
    """Where both levels are resizes or one-pixel reads, ``work()`` walks
    each axis alone through both levels' tap tables and stages
    (``_read_sectors``); it reads exactly the base positions of the plain
    version's taps that a result needs (``_walked_sectors``); a level that
    is a warp counts from those positions themselves."""
    p = T.build_pipeline(*_all_nested()[name])
    a = kc.prepare(p, kc.build_plan(p), CPU)
    if "warp" in (a.plan.core, a.plan.core2):
        assert kc.work(a)[1] == kc._walked_sectors(a) > 0
        return
    assert kc._read_sectors(a) == kc._walked_sectors(a) > 0
    assert kc.work(a)[1] == kc._read_sectors(a)
