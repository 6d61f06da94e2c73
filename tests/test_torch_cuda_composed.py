"""The composed-read kernel on the card, at a quarter of the full width:
what ``chip_smoke.py`` phases 3 and 4 check at full width. Needs a CUDA
device and skips without one. On a machine with a card and without jax,
run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_composed.py

Every output must equal the plain version bit for bit (float32 as int32
bits), in one launch; on other source dtypes and subnormal float32 ones
also the eager path on the card (``ParBackend.TORCH``), which shares no
plan with the kernel.
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


def _on(cuda, f):
    return {k: torch.from_numpy(v).to(cuda) for k, v in f.items()}


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
    a = kc.prepare(p, kc.build_plan(p), cuda)
    before = kc.LAUNCHES
    got = kc.composed(a)
    assert kc.LAUNCHES == before + 1
    return a, got


@pytest.mark.parametrize("name", cc.NAMES)
def test_kernel_equals_its_plain_version(cuda, name):
    f = _on(cuda, cc.frames(H, W, 1))
    a, got = _launch(cuda, cc.cases(T, f)[name])
    _same(got, kc.composed_reference(a))


@pytest.mark.parametrize("name", list(cc.more_cases(T)))
def test_the_other_compositions(cuda, name):
    """Host leaves: the base and every value reach the card in prepare."""
    a, got = _launch(cuda, cc.more_cases(T)[name])
    assert a.srcs[0].device == cuda
    _same(got, kc.composed_reference(a))


def test_a_batch_of_crops_of_two_frames(cuda):
    f1, f2 = (torch.from_numpy(cc.frames(H, W, s)["hd"]).to(cuda) for s in (8, 9))
    ops = (T.batch_read([T.crop(T.image(f1), T.Rect(1, 2, 100, 80)),
                         T.crop(T.image(f2), T.Rect(300, 150, 100, 80)),
                         T.crop(T.image(f1), T.Rect(-20, 250, 100, 80))]),
           T.convert_to(np.float32, alpha=0.5), T.split_tensor())
    a, got = _launch(cuda, ops)
    assert len(a.srcs) == 2 and a.plane_src == (0, 1, 0)
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int16, torch.float16, torch.int32,
                                   torch.float64, torch.int64])
@pytest.mark.parametrize("name", ["c1_roi_crop_resize", "c4_warp_of_a_crop", "c6_crop_batch",
                                  "c7_crop_of_fused_gray", "c3_letterbox"])
def test_source_dtypes(cuda, name, dtype):
    f = _on(cuda, cc.frames(H, W, 2))
    for k in ("hd", "big"):
        f[k] = ((f[k].int() * 3 + 100).to(dtype) if dtype != torch.float16
                else (f[k].float() / 7).half())
    ops = cc.cases(T, f)[name]
    a, got = _launch(cuda, ops)
    assert a.srcs[0].dtype == dtype
    _same(got, kc.composed_reference(a))
    _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


def test_subnormal_float32_source(cuda):
    """Subnormal values flushed as operands and results, kept by copies: the
    kernel equals its plain version as int32 bits."""
    f = _on(cuda, cc.frames(H, W, 3))
    rng = np.random.default_rng(4)
    for k in ("hd", "big"):
        x = f[k].float() * 1e-39
        mask = torch.from_numpy(rng.random(tuple(x.shape)) < 0.5).to(cuda)
        f[k] = torch.where(mask, x, x * 1e-6)
    for name in ("c1_roi_crop_resize", "c4_warp_of_a_crop", "c7_crop_of_fused_gray"):
        ops = cc.cases(T, f)[name]
        ops = (*ops[:-1][:1], T.multiply(1e20), ops[-1])
        a, got = _launch(cuda, ops)
        _same(got, kc.composed_reference(a))
        _same(got, T.execute_operations(*ops, backend=T.ParBackend.TORCH))


def test_main_path_is_one_launch_and_new_values_build_no_plan(cuda):
    f = _on(cuda, cc.frames(H, W, 5))
    for name in cc.NAMES:
        outs = []
        for values in (0, 1):
            builds, launches = executor.PLAN_BUILDS, kc.LAUNCHES
            outs.append(T.execute_operations(*cc.cases(T, f, values)[name]))
            assert T.last_backend() == "cuda:composed", name
            assert kc.LAUNCHES == launches + 1
            if values:
                assert executor.PLAN_BUILDS == builds, name
        eager = T.execute_operations(*cc.cases(T, f, 1)[name], backend=T.ParBackend.TORCH)
        _same(outs[1], eager)
        moved = name[:2] in ("c1", "c3", "c4", "c6", "c7")  # the cases whose values move
        assert torch.equal(outs[0], outs[1]) != moved, name


@pytest.mark.parametrize("shift", [0, 4])
def test_out_view_on_and_off_16_bytes(cuda, shift):
    f = _on(cuda, cc.frames(H, W, 6))
    p = T.build_pipeline(*cc.cases(T, f)["c1_roi_crop_resize"])
    a = kc.prepare(p, kc.build_plan(p), cuda)
    want = kc.composed_reference(a)
    storage = torch.full((want.numel() + 16,), 7.0, device=cuda)
    start = shift // 4
    view = storage[start:start + want.numel()].view(want.shape)
    assert view.data_ptr() % 16 == shift
    assert kc.composed(a, out=view) is view
    _same(view, want)
    assert bool((storage[:start] == 7).all() and (storage[start + want.numel():] == 7).all())


def test_out_into_a_strided_slot_of_another_dtype(cuda):
    f = _on(cuda, cc.frames(H, W, 7))
    ops = cc.cases(T, f)["c7_crop_of_fused_gray"]
    p = T.build_pipeline(*ops[:-2], T.split_tensor())
    a = kc.prepare(p, kc.build_plan(p), cuda)
    want = kc.composed_reference(a)  # uint8 gray, planar (1, h, w)
    slots = torch.full((1, 3, *want.shape[1:]), -1, dtype=torch.int16, device=cuda)
    view = slots[:, 1]
    assert kc.composed(a, out=view) is view
    _same(view, want.to(torch.int16))
    assert bool((slots[:, [0, 2]] == -1).all())
