"""Batches of nested planes that differ in geometry through the composed
kernel's mixed nested instances on the card: what ``chip_smoke.py`` phases
3 and 4 check of NM1-NM4 at full width, at the test sizes of
``torch_composed_cases.nested_mixed_cases`` and at ten times their cameras'
sides. Needs a CUDA device and skips without one. On a machine with a card
and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_composed_nested_mixed.py

Every output must equal the plain version bit for bit (float32 as int32
bits), in one launch, and the eager path on the card (``ParBackend.TORCH``),
which shares no plan with the kernel.
"""

import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.ops.memory import BatchRead
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
    assert plan.core2 and plan.word("batch") == kc.MIXED and len(plan.planes) == plan.n_planes
    a = kc.prepare(p, plan, cuda)
    before = kc.LAUNCHES
    got = kc.composed(a)
    assert kc.LAUNCHES == before + 1
    return a, got


@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("family", cc.FAMILIES)
@pytest.mark.parametrize("name", cc.NESTED_MIXED_NAMES)
def test_a_nested_mixed_batch_equals_its_plain_version(cuda, name, family, large):
    """One launch, each plane from its own address and its own head, bit
    for bit the plain version and the eager path on the card."""
    f = _frames(cuda, family, 41, large)
    ops = cc.nested_mixed_cases(T, f)[name]
    a, got = _launch(cuda, ops)
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("name", ["nm1_top_views_of_cameras_of_3_sizes_ragged",
                                  "nm3_half_size_resize_then_rotate",
                                  "nm4_roi_crops_of_a_downscale"])
def test_every_plane_staged_or_per_tap(cuda, name, stage):
    """Each plane's ``stage2`` set to 0 or 1 (the per-tap or the staged
    mixed instance, every block of a plane in the form its word asks for,
    per tap past the budget): bit for bit the plain version."""
    f = _frames(cuda, "uint8", 42, True)
    p = T.build_pipeline(*cc.nested_mixed_cases(T, f)[name])
    t = kc._tree(p)
    plan = kc._mixed([kc.dataclasses.replace(q, head=kc._with_words(q.head, stage2=stage))
                      for q in (kc._plane_plan(t, plane, p) for plane in t.planes)])
    assert [q.word("stage2") for q in plan.planes] == [stage] * plan.n_planes
    a = kc.prepare(p, plan, cuda)
    _same(kc.composed(a), kc.composed_reference(a))


@pytest.mark.parametrize("dtype", ["int8", "uint16", "float16", "int32", "float64"])
@pytest.mark.parametrize("name", cc.NESTED_MIXED_NAMES)
def test_other_source_dtypes(cuda, name, dtype):
    f = _frames(cuda, dtype, 43, True)
    ops = cc.nested_mixed_cases(T, f)[name]
    a, got = _launch(cuda, ops)
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("default", [-1.5, 300.7, float("nan"), (7.0, 260.0, -3.0)])
@pytest.mark.parametrize("used", [0, 1, 3, 5, -1])
def test_a_ragged_nested_mixed_batch_holds_the_default(cuda, used, default):
    """NM1's top views and NM4's crops with ``used_planes`` and defaults:
    planes from used_planes on hold the default through the chain, bit for
    bit the plain version and the eager path."""
    f = _frames(cuda, "uint8", 44)
    cases = cc.nested_mixed_cases(T, f, used=used, default=default)
    rois = cases["nm4_roi_crops_of_a_downscale"]
    rois = (T.batch_read(list(rois[0].ops), used_planes=used, default=default), *rois[1:])
    for ops in (cases["nm1_top_views_of_cameras_of_3_sizes_ragged"], rois):
        a, got = _launch(cuda, ops)
        _same(got, kc.composed_reference(a))
        _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("family", cc.FAMILIES)
def test_one_launch_and_new_values_build_no_plan(cuda, family):
    """Each of NM1-NM4 twice through execute_operations, the second call
    with new frames of the same sizes and new maps, origins, angles, border
    value and used_planes: ``cuda:composed`` in one launch each, no plan on
    the second, the eager path's values bit for bit."""
    for name in cc.NESTED_MIXED_NAMES:
        for values in (0, 1):
            f = _frames(cuda, family, 45 + values, True)
            ops = cc.nested_mixed_cases(T, f, values)[name]
            builds, launches = executor.PLAN_BUILDS, kc.LAUNCHES
            got = T.execute_operations(*ops)
            assert T.last_backend() == "cuda:composed", name
            assert kc.LAUNCHES == launches + 1
            if values:
                assert executor.PLAN_BUILDS == builds, name
            _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("name", cc.NESTED_MIXED_NAMES)
def test_into_a_strided_unaligned_view(cuda, name):
    f = _frames(cuda, "uint8", 47, True)
    p = T.build_pipeline(*cc.nested_mixed_cases(T, f)[name])
    a = kc.prepare(p, kc.build_plan(p), cuda)
    want = kc.composed_reference(a)
    storage = torch.full((*want.shape[:-1], want.shape[-1] + 5), 7.0, device=cuda)
    view = storage[..., 1:1 + want.shape[-1]]
    assert kc.composed(a, out=view) is view
    _same(view, want)
    assert bool((storage[..., :1] == 7).all() and (storage[..., 1 + want.shape[-1]:] == 7).all())


@pytest.mark.parametrize("name", ["n3_two_level_downscale", "n6_top_views_of_8_cameras_ragged",
                                  "n2_resize_then_rotate", "n5_letterbox_of_a_normalized_resize"])
def test_a_batch_of_one_geometry_through_the_mixed_instances(cuda, name):
    """A nested plan of one geometry (N2, N3, N5, N6 as a one-plane batch
    where they are not one) launched through the mixed nested instances,
    every plane given its head: bit for bit the by-value instances (what
    ``chip_smoke.py`` times to price the plane head in shared memory)."""
    f = cc.nested_frames(90, 120, 48)
    f = {"hd": torch.from_numpy(f["hd"]).to(cuda), "big": torch.from_numpy(f["big"]).to(cuda),
         "cams": [torch.from_numpy(c).to(cuda) for c in f["cams"]]}
    ops = cc.nested_cases(T, f)[name]
    if not isinstance(ops[0], BatchRead):
        ops = (T.batch_read([ops[0]]), *ops[1:])
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    by_value = kc.composed(kc.prepare(p, plan, cuda))
    mixed = kc._mixed([plan] * plan.n_planes)
    assert mixed.word("batch") == kc.MIXED
    _same(kc.composed(kc.prepare(p, mixed, cuda)), by_value)


def test_a_plane_head_the_entry_refuses(cuda):
    """The C entry checks every nested plane's head against plane 0's
    structure: a plane head whose second level differs is refused before
    anything launches."""
    f = _frames(cuda, "uint8", 49)
    p = T.build_pipeline(*cc.nested_mixed_cases(T, f)["nm4_roi_crops_of_a_downscale"])
    plan = kc.build_plan(p)
    bad = kc._with_words(plan.planes[1].head, core2=kc.CORES.index("warp"))
    planes = (plan.planes[0], kc.dataclasses.replace(plan.planes[1], head=bad), *plan.planes[2:])
    plan = kc.dataclasses.replace(plan, planes=planes, device_consts={})
    with pytest.raises(RuntimeError, match="composed launch failed"):
        kc.composed(kc.prepare(p, plan, cuda))
