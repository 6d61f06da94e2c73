"""Batches whose planes differ in geometry through the composed kernel on
the card: what ``chip_smoke.py`` phases 3 and 4 check of M1-M5 at full
width, at the test sizes of ``torch_composed_cases.mixed_cases`` (M1-M6)
and at ten times their cameras' sides. Needs a CUDA device and skips
without one. On a machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_composed_mixed.py

Every output must equal the plain version bit for bit (float32 as int32
bits), in one launch of the mixed-geometry instances, and the eager path
on the card (``ParBackend.TORCH``), which shares no plan with the kernel.
"""

import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import executor
import torch_composed_cases as cc

pytestmark = pytest.mark.gpu

#: the cameras at ten times the sides of ``cc.MIXED_SIZES`` (NV12: even)
LARGE = {"image": ((290, 370), (480, 640), (410, 230)),
         "nv12": ((280, 360), (480, 640), (400, 220))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _frames(cuda, family, seed, large=False):
    sizes = LARGE["nv12" if family == "nv12" else "image"] if large else None
    f = cc.mixed_frames(family, seed, sizes)
    return {"family": family, "cams": [torch.from_numpy(c).to(cuda) for c in f["cams"]],
            "big": torch.from_numpy(f["big"]).to(cuda)}


def _bits(t):
    if t.dtype.is_floating_point:
        return t.view(torch.int32 if t.element_size() == 4 else torch.int16)
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _same(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    bad = int((_bits(got) != _bits(want)).sum())
    assert bad == 0, f"{bad} of {got.numel()} values differ"


def _launch(cuda, ops):
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    assert plan.word("batch") == kc.MIXED and len(plan.planes) == plan.n_planes
    a = kc.prepare(p, plan, cuda)
    before = kc.LAUNCHES
    got = kc.composed(a)
    assert kc.LAUNCHES == before + 1
    return a, got


@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("family", cc.FAMILIES)
@pytest.mark.parametrize("name", cc.MIXED_NAMES)
def test_a_mixed_batch_equals_its_plain_version(cuda, name, family, large):
    """One launch, each plane from its own address, bit for bit the plain
    version and the eager path on the card."""
    f = _frames(cuda, family, 31, large)
    ops = cc.mixed_cases(T, f)[name]
    a, got = _launch(cuda, ops)
    assert [s.data_ptr() for s in a.srcs] == [c.data_ptr() for c in f["cams"]] or \
        name[:2] in ("m3", "m4")
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("dtype", ["int8", "uint16", "float16", "int32", "float64"])
@pytest.mark.parametrize("name", ["m1_cameras_resized", "m5_warps_of_crops",
                                  "m6_crops_of_cameras"])
def test_other_source_dtypes(cuda, name, dtype):
    f = _frames(cuda, dtype, 32, True)
    ops = cc.mixed_cases(T, f)[name]
    a, got = _launch(cuda, ops)
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("default", [-1.5, 300.7, float("nan"), (7.0, 260.0, -3.0)])
@pytest.mark.parametrize("used", [0, 1, 3, 5, -1])
def test_a_mixed_ragged_batch_holds_the_default(cuda, used, default):
    """M2's resizes through the chain (float32) and M6's crops stored as
    read (uint8): planes from used_planes on hold the default, cast to the
    read value's dtype, bit for bit the plain version and the eager path."""
    f = _frames(cuda, "uint8", 33)
    cases = cc.mixed_cases(T, f, used=used, default=default)
    crops = T.batch_read(list(cases["m6_crops_of_cameras"][0].ops), used_planes=used,
                         default=default)
    for ops in ((crops, T.write_tensor()), cases["m2_cameras_resized_ragged"]):
        a, got = _launch(cuda, ops)
        _same(got, kc.composed_reference(a))
        _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("family", cc.FAMILIES)
def test_a_mixed_batch_is_one_launch_and_new_values_build_no_plan(cuda, family):
    """Each of M1-M6 twice through execute_operations, the second call with
    new frames of the same sizes and new origins, angles, border value and
    used_planes: ``cuda:composed`` in one launch each, no plan on the
    second, the eager path's values bit for bit."""
    for name in cc.MIXED_NAMES:
        for values in (0, 1):
            f = _frames(cuda, family, 34 + values, True)
            ops = cc.mixed_cases(T, f, values)[name]
            builds, launches = executor.PLAN_BUILDS, kc.LAUNCHES
            got = T.execute_operations(*ops)
            assert T.last_backend() == "cuda:composed", name
            assert kc.LAUNCHES == launches + 1
            if values:
                assert executor.PLAN_BUILDS == builds, name
            _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("name", ["m2_cameras_resized_ragged", "m4_letterboxes",
                                  "m5_warps_of_crops", "m6_crops_of_cameras"])
def test_a_mixed_batch_into_a_strided_unaligned_view(cuda, name):
    f = _frames(cuda, "uint8", 36, True)
    p = T.build_pipeline(*cc.mixed_cases(T, f)[name])
    a = kc.prepare(p, kc.build_plan(p), cuda)
    want = kc.composed_reference(a)
    storage = torch.full((*want.shape[:-1], want.shape[-1] + 5), 7.0, device=cuda)
    view = storage[..., 1:1 + want.shape[-1]]
    assert kc.composed(a, out=view) is view
    _same(view, want)
    assert bool((storage[..., :1] == 7).all() and (storage[..., 1 + want.shape[-1]:] == 7).all())


def test_a_plane_head_the_entry_refuses(cuda):
    """The C entry checks every plane's head against plane 0's structure: a
    plane head whose core differs is refused before anything launches."""
    f = _frames(cuda, "uint8", 37)
    p = T.build_pipeline(*cc.mixed_cases(T, f)["m1_cameras_resized"])
    plan = kc.build_plan(p)
    bad = kc._with_words(plan.planes[1].head, core=kc.CORES.index("warp"))
    planes = (plan.planes[0], kc.dataclasses.replace(plan.planes[1], head=bad), *plan.planes[2:])
    plan = kc.dataclasses.replace(plan, planes=planes, device_consts={})
    with pytest.raises(RuntimeError, match="composed launch failed"):
        kc.composed(kc.prepare(p, plan, cuda))
