"""Divergent batches with a nested group through the composed kernel's
nested instances on the card: what ``chip_smoke.py`` phases 3 to 5 check of
DVN1-DVN4, at the test sizes of ``torch_composed_cases.
divergent_nested_cases`` and at ``chip_smoke.py``'s full width, the lift of
a plane without a second resample of its own, and every source dtype as a
nested group. Needs a CUDA device and skips without one. On a machine with
a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_divergent_nested.py

Every output must equal the plain version bit for bit (float32 as int32
bits), in one launch of the composed kernel that the profiler names as
``cuda_composed.divergent_instance`` predicts, and the eager merge on the
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


def _launch(cuda, ids, seqs, lift=None):
    plan = kc.build_divergent_plan(seqs, ids, lift)
    a = kc.prepare(seqs, plan, cuda)
    before = kc.LAUNCHES
    got = kc.composed(a)
    assert kc.LAUNCHES == before + 1
    return a, got


def _small(cuda, name, seed, values=0, **frames):
    f = _on(cuda, cc.divergent_nested_frames(seed, **frames))
    return cc.divergent_nested_cases(T, f, values)[name]


def _full(cuda, name, seed, values=0):
    """``chip_smoke.py``'s DVN case at full width: eight 1080p cameras and
    NV12 buffers, the 12-bit sensor frame."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    cams = [torch.from_numpy(rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)).to(cuda)
            for _ in range(8)]
    nv12 = [torch.from_numpy(rng.integers(0, 256, (1620, 1920), dtype=np.uint8)).to(cuda)
            for _ in range(8)]
    sensor = torch.from_numpy(rng.integers(0, 4096, (*chip_smoke.DV_SENSOR, 3)).astype(
        np.uint16)).to(cuda)
    return chip_smoke.divergent_nested_cases(T, cams, nv12, sensor, values)[name]


def _kernel_name(fn):
    """The device kernel one call of ``fn`` runs, as the profiler names it,
    without namespaces."""
    import re

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    names = {re.sub(r"\(anonymous namespace\)::|kc::", "", e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return {m.group(0) for n in names for m in [re.search(r"\w+<[^>]*>", n)] if m}


@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("name", cc.DIVERGENT_NESTED_NAMES)
def test_a_nested_divergent_batch_equals_its_plain_version(cuda, name, size):
    """One launch, each plane from its own head and address, bit for bit
    the plain version and the eager merge on the card."""
    ids, ops = _small(cuda, name, 41) if size == "small" else _full(cuda, name, 41)
    seqs = _seqs(ops)
    a, got = _launch(cuda, ids, seqs)
    assert len(a.plan.head) == kc.NESTED_INTS
    _same(got, kc.composed_reference(a))
    _same(got, T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.TORCH))


@pytest.mark.parametrize("name", cc.DIVERGENT_NESTED_NAMES)
def test_the_profiler_names_the_predicted_instance(cuda, name):
    """The kernel the launch runs is the instance
    ``kc.divergent_instance`` predicts from the plan (the C entry's
    routing): uint8 per tap, uint8 staged, the general staged one, NV12 per
    tap."""
    ids, ops = _small(cuda, name, 42)
    seqs = _seqs(ops)
    a = kc.prepare(seqs, kc.build_divergent_plan(seqs, ids), cuda)
    assert _kernel_name(lambda: kc.composed(a)) == {kc.divergent_instance(a.plan)}


@pytest.mark.parametrize("name", cc.DIVERGENT_NESTED_NAMES)
def test_launch_divergent_batch_is_one_launch_and_new_values_build_no_plan(cuda, name):
    """Each case twice through ``launch_divergent_batch``, the second call
    with new frames of the same sizes and new maps, angles, origins, border
    values and ``used_planes``: ``cuda:composed:divergent`` in one launch of
    the composed kernel each, counted under ``cuda:composed``, none of the
    divergent kernel, no plan on the second, the eager merge's values."""
    for values in (0, 1):
        ids, ops = _small(cuda, name, 45 + values, values)
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_source_dtype_as_a_nested_group(cuda, dtype):
    """Uint8 letterboxes (one level, lifted) beside regions of a sensor
    frame of each dtype resized twice (nested): the general nested
    instances where the two differ, the uint8 ones where both are uint8;
    bit for bit the plain version and the eager merge."""
    f = _on(cuda, cc.divergent_nested_frames(43, dtype))
    cases = cc.divergent_nested_cases(T, f)
    ids = [1, 2] * 4
    seqs = _seqs((cases["dvn1_top_views_beside_letterboxes"][1][0],
                  cases["dvn3_normalized_letterboxes_beside_a_12bit_sensor"][1][1]))
    a, got = _launch(cuda, ids, seqs)
    _same(got, kc.composed_reference(a))
    _same(got, T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.TORCH))
    assert _kernel_name(lambda: kc.composed(a)) == {kc.divergent_instance(a.plan)}


def _edge_cameras(cuda, seed):
    """Eight float32 cameras (27x48) of values in 0..255, a sixteenth of them
    NaN, an infinity or a subnormal of either sign."""
    rng = np.random.default_rng(seed)
    edges = np.array([np.nan, np.inf, -np.inf, 1e-40, -3e-39, 1e-45, -0.0], np.float32)
    out = []
    for _ in range(8):
        c = (rng.random((27, 48, 3)) * 255).astype(np.float32)
        mask = rng.random(c.shape) < 1 / 16
        c[mask] = rng.choice(edges, int(mask.sum()))
        out.append(torch.from_numpy(c).to(cuda))
    return out


@pytest.mark.parametrize("lift", kc.LIFTS)
def test_the_lift_copies_nan_infinities_and_subnormals(cuda, lift):
    """Letterboxes whose exact 3:1 resize copies its taps beside top views,
    over float32 cameras of NaN, infinities and subnormals, no chain: the
    letterboxes' planes through the identity resize bit for bit the plain
    version (subnormals kept); the letterboxes alone through each lift bit
    for bit their own one-level launch."""
    cams = _edge_cameras(cuda, 44)
    persp = dict(warp_type=T.WarpType.PERSPECTIVE, default=0.0)
    boxes = (T.batch_read([T.make_border(T.resize(T.image(c), T.Size(16, 9)), 3, 4, 0, 0,
                                         T.BorderMode.CONSTANT, 114.0) for c in cams]),
             T.split_tensor())
    tops = (T.batch_read([T.resize(T.warp(T.image(c), cc.top_view(48, 27, k), T.Size(48, 27),
                                          **persp), T.Size(16, 16))
                          for k, c in enumerate(cams)]), T.split_tensor())
    ids = [1, 1, 2, 2] * 2
    a, got = _launch(cuda, ids, _seqs((boxes, tops)))
    _same(got, kc.composed_reference(a))
    assert bool(got.isnan().any()) and bool(((got != 0) & (got.abs() < 2.0 ** -126)).any())
    one = _seqs((boxes,))
    _, own = _launch(cuda, [1] * 8, one)
    a, got = _launch(cuda, [1] * 8, one, lift)
    _same(got, own)
    _same(got, kc.composed_reference(a))


@pytest.mark.parametrize("lift", kc.LIFTS)
@pytest.mark.parametrize("name", cc.DIVERGENT_NAMES[:3])
def test_a_one_level_batch_lifted_equals_its_own_launch(cuda, name, lift):
    """DV1-DV3 with every plane carried through the nested instances (an
    identity resize; an empty FusedRead2): bit for bit their own one-level
    launch (DV4's one-pixel planes have no nested instance: the plan
    refuses to lift them)."""
    f = _on(cuda, cc.divergent_frames(46, 4))
    ids, ops = cc.divergent_cases(T, f)[name]
    seqs = _seqs(ops)
    _, own = _launch(cuda, ids, seqs)
    a, got = _launch(cuda, ids, seqs, lift)
    assert len(a.plan.head) == kc.NESTED_INTS
    _same(got, own)


def test_an_int32_fused_read2_beside_a_second_resample(cuda):
    """A FusedRead2 alone whose chain ends in int32, lifted to the identity
    resize (its value's bits kept), beside top views: bit for bit."""
    f = _on(cuda, cc.divergent_nested_frames(47))
    (iw, ih), (t, b, l, r) = cc.letterbox(64, 36, 16)
    boxes = T.batch_read([T.make_border(T.fuse(T.resize(T.image(c), T.Size(iw, ih)),
                                               T.convert_to(np.int32, alpha=3.0, beta=-200.0)),
                                        t, b, l, r, T.BorderMode.CONSTANT, -7.0)
                          for c in f["wide"]])
    tops = cc.divergent_nested_cases(T, f)["dvn1_top_views_beside_letterboxes"][1][1][0]
    seqs = _seqs(((boxes, T.convert_to(np.float32, alpha=0.5), T.split_tensor()),
                  (tops, T.convert_to(np.float32, alpha=0.5), T.split_tensor())))
    a, got = _launch(cuda, [1, 2] * 4, seqs)
    _same(got, kc.composed_reference(a))
    _same(got, T.launch_divergent_batch([1, 2] * 4, *seqs, backend=T.ParBackend.TORCH))


def test_a_one_level_group_beside_fused_read2s_alone(cuda):
    """Letterboxes (one level, an empty FusedRead2) beside N5's letterboxes
    (a FusedRead2 alone): the FusedRead2 instance, bit for bit."""
    f = _on(cuda, cc.divergent_nested_frames(48))
    cases = cc.divergent_nested_cases(T, f)
    boxes = cases["dvn1_top_views_beside_letterboxes"][1][0]
    fused = cases["dvn3_normalized_letterboxes_beside_a_12bit_sensor"][1][0]
    ids = [1, 2, 2, 1] * 2
    seqs = _seqs(((boxes[0], T.split_tensor()), fused))
    a, got = _launch(cuda, ids, seqs)
    assert a.plan.core2 == "none"
    _same(got, kc.composed_reference(a))
    assert _kernel_name(lambda: kc.composed(a)) == {kc.divergent_instance(a.plan)}


def test_a_plane_head_the_entry_refuses(cuda):
    """The nested C entry checks every plane's head: one with a plane
    stride (not a divergent head), or a nested plane whose second level
    differs in kind from plane 0's (a FusedRead2 alone beside a second
    resample), is refused before anything launches."""
    ids, ops = _small(cuda, "dvn1_top_views_beside_letterboxes", 49)
    seqs = _seqs(ops)
    plan = kc.build_divergent_plan(seqs, ids)
    for words in (dict(plane_stride=7), dict(core2=kc.CORES.index("none"))):
        bad = kc._with_words(plan.planes[3].head, **words)
        planes = (*plan.planes[:3], kc.dataclasses.replace(plan.planes[3], head=bad),
                  *plan.planes[4:])
        broken = kc.dataclasses.replace(plan, planes=planes, device_consts={})
        with pytest.raises(RuntimeError, match="composed launch failed"):
            kc.composed(kc.prepare(seqs, broken, cuda))
