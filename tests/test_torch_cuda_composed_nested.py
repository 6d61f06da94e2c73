"""The composed kernel's nested instances on the card (a second resampling
node, or a fused read above the core): N1-N6 at 36x48 and at a quarter of
the full width, what ``chip_smoke.py`` phases 3 and 4 check at full width,
and the other nested trees (``more_nested_cases``), among them a warp at
a quarter scale whose blocks pass the staging budget and evaluate the
core per tap, and an upscale whose blocks share their taps.
Needs a CUDA device and skips without one. On a machine with a card and
without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_composed_nested.py

Every output must equal the plain version and the eager path on the card
(``ParBackend.TORCH``, which shares no plan with the kernel) bit for bit
(float32 as int32 bits), in one launch.
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import executor
import torch_composed_cases as cc

pytestmark = pytest.mark.gpu

H, W = 270, 480  # a quarter of 1080p on each side


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _frames(cuda, h, w, seed):
    f = cc.nested_frames(h, w, seed)
    return {"hd": torch.from_numpy(f["hd"]).to(cuda), "big": torch.from_numpy(f["big"]).to(cuda),
            "cams": [torch.from_numpy(c).to(cuda) for c in f["cams"]]}


def _bits(t):
    if t.dtype.is_floating_point:
        return t.view(torch.int32 if t.element_size() == 4 else torch.int16)
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _same(got, want):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        bad = int((_bits(g) != _bits(w)).sum())
        assert bad == 0, f"{bad} of {g.numel()} values differ"


def _launch(cuda, ops):
    p = T.build_pipeline(*ops)
    plan = kc.build_plan(p)
    assert plan.core2, "a nested plan"
    a = kc.prepare(p, plan, cuda)
    before = kc.LAUNCHES
    got = kc.composed(a)
    assert kc.LAUNCHES == before + 1
    return a, got


@pytest.mark.parametrize("size", [(36, 48), (H, W)])
@pytest.mark.parametrize("name", cc.NESTED_NAMES)
def test_kernel_equals_its_plain_version_and_the_eager_path(cuda, name, size):
    ops = cc.nested_cases(T, _frames(cuda, *size, 1))[name]
    a, got = _launch(cuda, ops)
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("name", list(cc.more_nested_cases(T)))
def test_the_other_nested_compositions(cuda, name):
    """Host leaves: the base and every value reach the card in prepare."""
    ops = cc.more_nested_cases(T)[name]
    a, got = _launch(cuda, ops)
    assert a.srcs[0].device == cuda
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int16, torch.float16, torch.int32,
                                   torch.float64, torch.int64, torch.int8, torch.float32])
@pytest.mark.parametrize("name", ["n1_top_view_resized", "n2_resize_then_rotate",
                                  "n5_letterbox_of_a_normalized_resize"])
def test_source_dtypes(cuda, name, dtype):
    f = _frames(cuda, 72, 96, 2)
    for k in ("hd", "big"):
        f[k] = ((f[k].int() * 3 + 100).to(dtype) if dtype not in (torch.float16, torch.int8)
                else (f[k].float() / 7).half() if dtype == torch.float16
                else (f[k].int() - 128).to(dtype))
    ops = cc.nested_cases(T, f)[name]
    a, got = _launch(cuda, ops)
    assert a.srcs[0].dtype == dtype
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


def test_subnormal_float32_sources_and_coefficients(cuda):
    """Subnormal values flushed as operands and results, kept by copies; a
    warp map with a subnormal coefficient at either level: the kernel equals
    its plain version and the eager path as int32 bits."""
    f = _frames(cuda, 72, 96, 3)
    rng = np.random.default_rng(4)
    for k in ("hd", "big"):
        x = f[k].float() * 1e-39
        mask = torch.from_numpy(rng.random(tuple(x.shape)) < 0.5).to(cuda)
        f[k] = torch.where(mask, x, x * 1e-6)
    for name in ("n1_top_view_resized", "n2_resize_then_rotate", "n3_two_level_downscale"):
        ops = cc.nested_cases(T, f)[name]
        ops = (ops[0], T.multiply(1e20), ops[-1])
        a, got = _launch(cuda, ops)
        _same(got, kc.composed_reference(a))
        _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))
    src = torch.from_numpy(cc.subnormal_source()).to(cuda)
    for ops in cc.subnormal_map_cases(T, src).values():
        a, got = _launch(cuda, ops)
        _same(got, kc.composed_reference(a))
        _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


def test_one_launch_a_call_and_new_values_build_no_plan(cuda):
    """Each of N1-N6 twice through execute_operations, the second call with
    new frames, maps, origins, border value and used_planes: one launch
    each, no plan on the second, the eager path's values bit for bit."""
    for name in cc.NESTED_NAMES:
        outs = []
        for values in (0, 1):
            ops = cc.nested_cases(T, _frames(cuda, H, W, 5 + values), values)[name]
            builds, launches = executor.PLAN_BUILDS, kc.LAUNCHES
            outs.append(T.execute_operations(*ops))
            assert T.last_backend() == "cuda:composed", name
            assert kc.LAUNCHES == launches + 1
            if values:
                assert executor.PLAN_BUILDS == builds, name
            _same(outs[-1], T.execute_operations(*ops, backend=T.ParBackend.TORCH))
        assert not torch.equal(outs[0], outs[1]), name


@pytest.mark.parametrize("name", ["n1_top_view_resized", "n4_crop_of_a_downscale_resized",
                                  "n5_letterbox_of_a_normalized_resize",
                                  "n6_top_views_of_8_cameras_ragged"])
def test_out_into_a_strided_unaligned_view(cuda, name):
    """An output whose rows lie 5 elements apart past the row and whose
    first element lies 4 bytes off 16: nothing written outside the view."""
    p = T.build_pipeline(*cc.nested_cases(T, _frames(cuda, H, W, 6))[name])
    a = kc.prepare(p, kc.build_plan(p), cuda)
    want = kc.composed_reference(a)
    storage = torch.full((*want.shape[:-1], want.shape[-1] + 5), 7.0, device=cuda)
    view = storage[..., 1:1 + want.shape[-1]]
    assert view.data_ptr() % 16 == 4
    assert kc.composed(a, out=view) is view
    _same(view, want)
    assert bool((storage[..., :1] == 7).all() and (storage[..., 1 + want.shape[-1]:] == 7).all())


@pytest.mark.parametrize("dst", [(97, 61), (3, 250), (301, 1)])
def test_ragged_rows(cuda, dst):
    """Outputs whose rows end inside a block (widths off 64, 3 pixels, one
    row): two resizes and a warp of a resize."""
    f = _frames(cuda, H, W, 7)
    size = T.Size(*dst)
    for ops in ((T.resize(T.resize(T.image(f["big"]), T.Size(301, 167)), size),
                 *cc.normalize(T), T.split_tensor()),
                (T.warp(T.resize(T.image(f["hd"]), T.Size(200, 120)),
                        cc.rotation((100, 60), 7.0), size), T.split_tensor())):
        a, got = _launch(cuda, ops)
        _same(got, kc.composed_reference(a))
        _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("used", [0, 3, 8, -1])
def test_a_ragged_batch_holds_the_default(cuda, used):
    f = _frames(cuda, 36, 48, 8)
    ops = cc.nested_cases(T, f)["n6_top_views_of_8_cameras_ragged"]
    read = ops[0]
    ops = (T.batch_read(list(read.ops), used_planes=used, default=(-1.5, 300.7, float("nan"))),
           *ops[1:])
    a, got = _launch(cuda, ops)
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("name", ["n1_top_view_resized", "n2_resize_then_rotate",
                                  "n3_two_level_downscale", "n6_top_views_of_8_cameras_ragged"])
def test_either_form_on_every_block(cuda, name, stage):
    """A plan's stage2 word set to 0 (every block evaluates the core at
    each tap) or 1 (every block whose footprint fits stages it): each
    equals the plain version bit for bit."""
    p = T.build_pipeline(*cc.nested_cases(T, _frames(cuda, H, W, 9))[name])
    plan = kc.build_plan(p)
    at = kc.HEAD_INTS + 2 * kc.kp.HEAD_INTS + kc._MID_WORDS.index("stage2")
    plan = kc.dataclasses.replace(plan, head=plan.head[:at] + (stage,) + plan.head[at + 1:],
                                  device_consts={})
    a = kc.prepare(p, plan, cuda)
    _same(kc.composed(a), kc.composed_reference(a))
