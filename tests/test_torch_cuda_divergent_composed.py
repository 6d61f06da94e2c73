"""Divergent batches through the composed kernel on the card: what
``chip_smoke.py`` phases 3 and 4 check of DV1-DV4 at full width, at the
test sizes of ``torch_composed_cases.divergent_cases`` and at eight times
their sides, and every source dtype as a group. Needs a CUDA device and
skips without one. On a machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_divergent_composed.py

Every output must equal the plain version bit for bit (float32 as int32
bits), in one launch of the composed kernel, and the eager merge on the
card (``ParBackend.TORCH``), which shares no plan with the kernel.
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import executor
import torch_composed_cases as cc

pytestmark = pytest.mark.gpu

#: every source dtype the composed kernel reads
DTYPES = ("uint8", "int8", "uint16", "int16", "float16", "float32", "int32", "int64", "float64")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _on(cuda, f):
    return {k: ([torch.from_numpy(x).to(cuda) for x in v] if isinstance(v, list)
                else torch.from_numpy(v).to(cuda)) for k, v in f.items()}


def _seqs(ops):
    return tuple(T.build_operation_sequence(*o) for o in ops)


def _bits(t):
    if t.dtype.is_floating_point:
        return t.view(torch.int32 if t.element_size() == 4 else torch.int16)
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _same(got, want):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        bad = int((_bits(g) != _bits(w)).sum())
        assert bad == 0, f"{bad} of {g.numel()} values differ"


def _launch(cuda, ids, seqs):
    plan = kc.build_divergent_plan(seqs, ids)
    a = kc.prepare(seqs, plan, cuda)
    before = kc.LAUNCHES
    got = kc.composed(a)
    assert kc.LAUNCHES == before + 1
    return a, got


def _one_pixel_pair(f):
    """``crop_batch`` of the uint8 frame beside ``crop_batch`` of the
    sensor frame (frames of ``cc.divergent_frames`` at scale 4): the
    one-pixel instances over two sources."""
    rects = [T.Rect(9 * k, 5 * k, 40, 30) for k in range(4)] * 2
    return [1, 2] * 4, _seqs((
        (T.crop_batch(T.image(f["big"]), rects), T.convert_to(np.float32, alpha=1 / 255.0),
         T.split_tensor()),
        (T.crop_batch(T.image(f["sensor"]), rects), T.convert_to(np.float32, alpha=1 / 4095.0),
         T.split_tensor())))


@pytest.mark.parametrize("scale", [1, 8])
@pytest.mark.parametrize("name", cc.DIVERGENT_NAMES)
def test_a_divergent_batch_equals_its_plain_version(cuda, name, scale):
    """One launch, each plane from its own head and address, bit for bit
    the plain version and the eager merge on the card."""
    f = _on(cuda, cc.divergent_frames(41, scale))
    ids, ops = cc.divergent_cases(T, f)[name]
    seqs = _seqs(ops)
    a, got = _launch(cuda, ids, seqs)
    _same(got, kc.composed_reference(a))
    _same(got, T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_source_dtype_as_a_group(cuda, dtype):
    """DV2's regions of a uint8 frame beside regions of a sensor frame of
    each dtype (the general instances where the two differ, the kind's
    mixed ones where both are uint8), and the one-pixel pair: bit for bit
    the plain version and the eager merge."""
    f = _on(cuda, cc.divergent_frames(42, 4, dtype))
    ids, ops = cc.divergent_cases(T, f)["dv2_rois_of_two_sensors"]
    seqs = _seqs(ops)
    a, got = _launch(cuda, ids, seqs)
    _same(got, kc.composed_reference(a))
    _same(got, T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.TORCH))
    ids, seqs = _one_pixel_pair(f)
    a, got = _launch(cuda, ids, seqs)
    _same(got, kc.composed_reference(a))
    _same(got, T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.TORCH))


def test_nv12_groups_of_two_structures(cuda):
    """Two NV12 groups (a resize, a crop then a resize, each converted into
    uint8 per tap): the NV12 kind's mixed instances, bit for bit."""
    rng = np.random.default_rng(44)
    bufs = [torch.from_numpy(rng.integers(0, 256, (72, 64), dtype=np.uint8)).to(cuda)
            for _ in range(4)]

    def rgb(b):
        return T.fuse(T.read_yuv(b), T.convert_yuv_to_rgb(out_dtype=np.uint8))

    dst = T.Size(16, 12)
    seqs = _seqs((
        (T.batch_read([T.resize(rgb(b), dst) for b in bufs]), T.split_tensor()),
        (T.batch_read([T.resize(T.crop(rgb(b), T.Rect(4 * k, 2, 40, 30)), dst)
                       for k, b in enumerate(bufs)]), T.split_tensor())))
    a, got = _launch(cuda, [1, 2, 2, 1], seqs)
    _same(got, kc.composed_reference(a))
    _same(got, T.launch_divergent_batch([1, 2, 2, 1], *seqs, backend=T.ParBackend.TORCH))


def test_nv12_groups_of_two_dtypes_keep_the_eager_merge(cuda):
    """An NV12 letterbox into uint8 beside an NV12 resize normalised to
    float32: the NV12 instances store with one row, so the composed plan
    refuses it, and the divergent kernel does too (a border); AUTO runs the
    eager merge, bit for bit ``ParBackend.TORCH``'s values."""
    rng = np.random.default_rng(45)
    bufs = [torch.from_numpy(rng.integers(0, 256, (72, 64), dtype=np.uint8)).to(cuda)
            for _ in range(4)]

    def rgb(b):
        return T.fuse(T.read_yuv(b), T.convert_yuv_to_rgb(out_dtype=np.uint8))

    seqs = _seqs((
        (T.batch_read([T.make_border(T.resize(rgb(b), T.Size(16, 8)), 2, 2, 0, 0,
                                     T.BorderMode.CONSTANT, 114.0) for b in bufs]),
         T.convert_to(np.uint8), T.split_tensor()),
        (T.batch_read([T.resize(rgb(b), T.Size(16, 12)) for b in bufs]),
         T.convert_to(np.float32, alpha=1 / 255.0), T.split_tensor())))
    ids = [1, 2, 2, 1]
    with pytest.raises(kc.Unsupported, match="NV12 groups whose chains end in"):
        kc.build_divergent_plan(seqs, ids)
    got = T.launch_divergent_batch(ids, *seqs)
    assert T.last_backend() == "torch:divergent"
    _same(got, T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("name", cc.DIVERGENT_NAMES)
def test_launch_divergent_batch_is_one_launch_and_new_values_build_no_plan(cuda, name):
    """Each case twice through ``launch_divergent_batch``, the second call
    with new frames of the same sizes and new origins, angles, border value
    and ``used_planes``: ``cuda:composed:divergent`` in one launch of the
    composed kernel each, counted under ``cuda:composed``, no plan on the
    second, the eager merge's values bit for bit."""
    for values in (0, 1):
        f = _on(cuda, cc.divergent_frames(45 + values, 4))
        ids, ops = cc.divergent_cases(T, f, values)[name]
        seqs = _seqs(ops)
        builds, counts = executor.PLAN_BUILDS, executor.launch_counts()
        got = T.launch_divergent_batch(ids, *seqs)
        assert T.last_backend() == "cuda:composed:divergent", name
        after = executor.launch_counts()
        assert after["cuda:composed"] == counts["cuda:composed"] + 1
        assert after["cuda:divergent"] == counts["cuda:divergent"]
        if values:
            assert executor.PLAN_BUILDS == builds, name
        _same(got, T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.TORCH))


def test_explicit_cuda_takes_the_composed_plan_or_raises_with_both_reasons(cuda):
    f = _on(cuda, cc.divergent_frames(47))
    ids, ops = cc.divergent_cases(T, f)["dv1_letterboxes_and_warps"]
    seqs = _seqs(ops)
    T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.CUDA)
    assert T.last_backend() == "cuda:composed:divergent"
    narrow = T.build_operation_sequence(T.image(np.zeros((8, 4, 5, 3), np.float32)),
                                        T.split_tensor())
    with pytest.raises(ValueError, match="cuda:divergent: .*; cuda:composed:divergent: "):
        T.launch_divergent_batch(ids, seqs[0], narrow, backend=T.ParBackend.CUDA)


def test_a_plane_head_the_entry_refuses(cuda):
    """The C entry checks every plane's head: one with a plane stride (not
    a divergent head) is refused before anything launches."""
    f = _on(cuda, cc.divergent_frames(48))
    ids, ops = cc.divergent_cases(T, f)["dv2_rois_of_two_sensors"]
    seqs = _seqs(ops)
    plan = kc.build_divergent_plan(seqs, ids)
    bad = kc._with_words(plan.planes[3].head, plane_stride=7)
    planes = (*plan.planes[:3], kc.dataclasses.replace(plan.planes[3], head=bad),
              *plan.planes[4:])
    plan = kc.dataclasses.replace(plan, planes=planes, device_consts={})
    with pytest.raises(RuntimeError, match="composed launch failed"):
        kc.composed(kc.prepare(seqs, plan, cuda))
