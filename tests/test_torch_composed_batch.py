"""A ``BatchRead`` of per-plane read trees in one launch of the composed
kernel, on the CPU: which batches it takes, and its plain version against
the JAX package and the port's eager lowering.

- Routing, decided on the host: B1-B7 (``torch_composed_cases.batch_cases``:
  cameras resized, ragged or not, regions of interest resized, letterboxes,
  warps of crops, crops of one frame with ``used_planes``, bare cameras) and
  the batches that stayed eager before (resizes, crops with ``used_planes``,
  crops of fused reads) are taken by ``cuda_composed.build_plan``, and
  ``executor._select(..., CUDA)`` names ``cuda:composed``.
- Parity: B1-B7 built with the JAX factories and carried across with
  ``from_jax``: ``composed_reference`` bit for bit the reference's op-by-op
  lowering and within 1e-4 of its jitted XLA path (uint8 bit for bit);
  ``used_planes`` 0, 2, N, N + 3 and -1 with the defaults -1.5, 300.7, NaN
  and one per channel on a uint8 read value against the XLA path (its
  convert saturates, NaN to 0: ROADMAP §3); bit for bit the port's eager
  lowering on every source dtype of ``test_torch_composed.py``.
- The block: one plane's words and a per-plane stride, each array read once
  however many planes read it; new frames, origins, matrices, border values
  and ``used_planes`` build no plan; ``work`` counts the planes read.
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
import torch_composed_cases as cc

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # only named: the routing is decided on shapes
F32_TOL = 1e-4               # against the jitted XLA path, on values of 0..255
N = len(cc.PLANE_SRC)
CORES = {"b5": "warp", "b6": "none", "b7": "none"}


def _backend(ops, backend=T.ParBackend.AUTO):
    return executor._select(T.build_pipeline(*ops), backend, CUDA).backend


def _arrays(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out]


def _bits(a):
    if a.dtype.kind == "f":
        return a.view(np.int32 if a.itemsize == 4 else np.int16)
    return a


def _img(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _moved():
    """The batches that ran eagerly on the card before, now one launch."""
    img = _img((36, 48, 3), 4)
    return {
        "a_batch_of_resizes": (T.batch_read([T.resize(T.image(img), T.Size(8, 8))] * 2),
                               T.split_tensor()),
        "a_batch_of_crops_with_used_planes": (
            T.batch_read([T.crop(T.image(img), T.Rect(0, 0, 8, 8))] * 3, used_planes=2,
                         default=0.0), T.split_tensor()),
        "a_batch_of_crops_of_fused_reads": (
            T.batch_read([T.crop(T.fuse(T.image(img), T.multiply(2.0)), T.Rect(0, 0, 8, 8))] * 2),
            T.split_tensor()),
    }


# --- routing -------------------------------------------------------------------


@pytest.mark.parametrize("name", cc.BATCH_NAMES)
def test_each_batch_takes_the_kernel(name):
    ops = cc.batch_cases(T, cc.cameras(1))[name]
    plan = kc.build_plan(T.build_pipeline(*ops))
    assert plan.batch and plan.n_planes == N
    assert plan.core == CORES.get(name[:2], "resize")
    assert (plan.word("used_off") >= 0) == ("ragged" in name)
    assert _backend(ops) == "cuda:composed"
    assert _backend(ops, T.ParBackend.CUDA) == "cuda:composed"


@pytest.mark.parametrize("name", list(_moved()))
def test_the_batches_that_stayed_eager_take_the_kernel(name):
    ops = _moved()[name]
    kc.build_plan(T.build_pipeline(*ops))
    assert _backend(ops) == "cuda:composed"
    got = _arrays(kc.run(T.build_pipeline(*ops), kc.build_plan(T.build_pipeline(*ops)), CPU))
    for g, e in zip(got, _arrays(T.execute_operations(*ops, device="cpu")), strict=True):
        np.testing.assert_array_equal(g, e)


def test_a_refused_batch_names_its_reason():
    """``ParBackend.CUDA`` raises with each kernel's refusal (what
    ``describe_backend`` reports); the composed kernel's says which planes
    differ and in what (planes that differ in geometry alone it takes:
    ``test_torch_composed_mixed.py``)."""
    img = _img((36, 48, 3), 5)
    ops = (T.batch_read([T.resize(T.image(img), T.Size(8, 8)),
                         T.resize(T.crop(T.image(img), T.Rect(0, 0, 30, 30)), T.Size(8, 8))]),
           T.split_tensor())
    with pytest.raises(ValueError, match=r"cuda:composed: planes 0 and 1 of a BatchRead differ "
                                         r"in op types \(ImageRead and CropRead\) "
                                         r"\(ResizeRead\(ImageRead\)"):
        _backend(ops, T.ParBackend.CUDA)


def test_warp_batch_of_bare_images_keeps_the_warp_kernel():
    img = _img((36, 48, 3), 6)
    m = cc.rotation((24, 18), 10.0)
    for used in (None, 1):
        ops = (T.warp_batch([img, img], [m, m], T.Size(16, 8), used_planes=used),
               T.split_tensor())
        assert _backend(ops) == "cuda:warp"
        kc.build_plan(T.build_pipeline(*ops))  # the composed kernel would take it too


# --- parity ----------------------------------------------------------------------


def _against_the_reference(jops, lowered=True):
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    got = _arrays(kc.run(p, kc.build_plan(p), CPU))
    xla = _arrays(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    low = _arrays(jp.lower()) if lowered else xla
    for g, l, x in zip(got, low, xla, strict=True):
        assert g.shape == x.shape and g.dtype == x.dtype, (g.shape, g.dtype, x.shape, x.dtype)
        if lowered:
            np.testing.assert_array_equal(g, l)
        if g.dtype.kind == "f":
            finite = np.isfinite(x)
            np.testing.assert_array_equal(np.isfinite(g), finite)
            tol = F32_TOL * max(1.0, float(np.abs(x[finite]).max(initial=0)) / 255)
            assert np.abs(g[finite].astype(np.float64) - x[finite].astype(np.float64)).max(
                initial=0) <= tol
        else:
            np.testing.assert_array_equal(g, x)
    return got


@pytest.mark.parametrize("values", [0, 1])
@pytest.mark.parametrize("name", cc.BATCH_NAMES)
def test_plain_version_against_the_reference(name, values):
    _against_the_reference(cc.batch_cases(J, cc.cameras(11 + values), values)[name])


@pytest.mark.parametrize("default", [-1.5, 300.7, float("nan"), (7.0, 260.0, -3.0)])
@pytest.mark.parametrize("used", [0, 2, N, N + 3, -1])
def test_used_planes_and_defaults_on_a_uint8_read(used, default):
    """The crops of B6 stored as they are read (uint8): planes from
    ``used_planes`` on hold the default cast to uint8 by the XLA path's
    convert (saturating, NaN to 0), one value or one per channel."""
    f = cc.cameras(12)
    jops = cc.batch_cases(J, f, used=used, default=default)["b6_crops_of_a_frame_ragged"]
    got = _against_the_reference((jops[0], J.write_tensor()), lowered=False)[0]
    assert got.dtype == np.uint8 and got.shape == (N, 12, 12, 3)
    held = got[max(used, 0):]
    want = np.clip(np.nan_to_num(np.trunc(np.broadcast_to(np.asarray(default), (3,))), nan=0),
                   0, 255).astype(np.uint8)
    assert (held == want).all()


@pytest.mark.parametrize("used", [0, 2, N, N + 3, -1])
def test_used_planes_of_a_float_read(used):
    """B2: the default of a resized (float32) read, NaN through the chain."""
    jops = cc.batch_cases(J, cc.cameras(13), used=used, default=float("nan"))
    got = _against_the_reference(jops["b2_cameras_resized_ragged"])[0]
    assert np.isnan(got[max(used, 0):]).all() and np.isfinite(got[:max(used, 0)]).all()


def _as_dtype(x, dtype):
    """A uint8 frame's values as ``dtype``, as ``test_torch_composed.py``
    spreads them."""
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
@pytest.mark.parametrize("name", cc.BATCH_NAMES)
def test_plain_version_equals_the_eager_lowering_bit_for_bit(name, dtype):
    f = cc.cameras(14)
    f = {"cams": [_as_dtype(c, dtype) for c in f["cams"]], "big": _as_dtype(f["big"], dtype)}
    ops = cc.batch_cases(T, f)[name]
    if dtype == "sub_f32":  # a chain whose products flush
        ops = (ops[0], T.multiply(1e-3), *ops[1:])
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    assert plan.src_dtype == f["big"].dtype
    got = _arrays(kc.run(p, plan, CPU))
    eager = _arrays(T.execute_operations(*ops, device="cpu"))
    for g, e in zip(got, eager, strict=True):
        assert g.shape == e.shape and g.dtype == e.dtype
        np.testing.assert_array_equal(_bits(g), _bits(e))


# --- the block and runtime values ---------------------------------------------------


@pytest.mark.parametrize("name", cc.BATCH_NAMES)
def test_new_values_build_no_plan(name):
    """New frames and moved values (origins, angles, the border value,
    ``used_planes``): the same structure, one plan, and the plan of the
    first values runs the second ones as the eager lowering."""
    p0 = T.build_pipeline(*cc.batch_cases(T, cc.cameras(15), 0)[name])
    ops1 = cc.batch_cases(T, cc.cameras(16), 1)[name]
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
    a0 = kc.prepare(T.build_pipeline(*cc.batch_cases(T, cc.cameras(15), 1)[name]), plan.kernel,
                    CPU)
    a1 = kc.prepare(p0, plan.kernel, CPU)
    moved = name[:2] not in ("b1", "b7")  # B1 and B7 hold no value but their frames
    assert torch.equal(a0.block[2 * N:], a1.block[2 * N:]) != moved  # past the addresses


def test_the_block_holds_one_plane_s_words_and_a_stride():
    """Plane z's crop origin lies ``z * plane_stride`` words past plane 0's,
    where the head's crop stage points; the two arrays are one entry of
    ``srcs`` each; used_planes and the default close the block."""
    f = cc.cameras(17)
    p = T.build_pipeline(*cc.batch_cases(T, f)["b3_rois_resized"])
    plan = kc.build_plan(p)
    a = kc.prepare(p, plan, CPU)
    assert len(a.srcs) == 2 and a.plane_src == cc.PLANE_SRC
    (crop,) = plan.stage_list(1) or plan.stage_list(0)
    stride = plan.word("plane_stride")
    assert stride == 2 and crop[4] == 2 * N  # after the N addresses
    origins = [(int(a.block[crop[4] + z * stride]), int(a.block[crop[5] + z * stride]))
               for z in range(N)]
    ops = cc.batch_cases(T, f)["b3_rois_resized"][0].ops
    assert origins == [(int(o.source.x), int(o.source.y)) for o in ops]
    assert plan.word("used_off") == -1
    ragged = kc.build_plan(T.build_pipeline(*cc.batch_cases(T, f)["b2_cameras_resized_ragged"]))
    assert ragged.word("default_off") == ragged.word("used_off") + 1
    assert ragged.n_block == ragged.word("default_off") + 3 + 4


def test_sources_are_read_in_place():
    """Tensor cameras reach the launch as they are: no stack, no copy; an
    array that several planes read is one entry of ``srcs``."""
    cams = [torch.from_numpy(c) for c in cc.cameras(18)["cams"]]
    ops = (T.batch_read([T.resize(T.image(cams[k]), T.Size(24, 16)) for k in cc.PLANE_SRC]),
           T.split_tensor())
    a = kc.prepare(T.build_pipeline(*ops), kc.build_plan(T.build_pipeline(*ops)), CPU)
    assert [s.data_ptr() for s in a.srcs] == [c.data_ptr() for c in cams]


@pytest.mark.parametrize("used", [0, 2, N, -1])
def test_work_counts_the_planes_read(used):
    """B2's bytes: the output, and each array's sectors once for the planes
    below ``used_planes`` (plane 4 reads array 0 again); a held plane
    counts its output and its chain alone."""
    f = cc.cameras(19)
    p = T.build_pipeline(*cc.batch_cases(T, f, used=used)["b2_cameras_resized_ragged"])
    a = kc.prepare(p, kc.build_plan(p), CPU)
    one = T.build_pipeline(*cc.batch_cases(T, f)["b1_cameras_resized"])
    whole = kc.work(kc.prepare(one, kc.build_plan(one), CPU))
    out_bytes, src, flops = kc.work(a)
    assert out_bytes == whole[0] == N * 3 * 16 * 24 * 4
    read = min(max(used, 0), N)
    arrays = len({cc.PLANE_SRC[z] for z in range(read)})
    assert src == whole[1] * arrays // 2
    per_plane = 3 * 16 * 24
    assert flops == read * per_plane * (12 + 3) + (N - read) * per_plane * 3
