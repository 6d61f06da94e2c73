"""Divergent batches split between the divergent kernel's body and the
composed kernel's in one launch, on the card: what ``chip_smoke.py``
phases 3 and 4 check of DK1-DK4 at full width, here at the test sizes of
``torch_composed_cases.split_cases`` (every composed form and every
output element type among them), rings of int8, uint16 and float16, and
what no route takes. Needs a CUDA device and skips without one. On a
machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_divergent_split.py

Every output must equal the plain version (the eager merge on the card)
bit for bit (float as its bits), in one launch of the split kernel: each
of its 10 instances (the composed part's form x its source kind: the
uint8 body, and the general one over float32 cameras or two sources), a
large batch off both parts' tiles, K6's part holding plane 0 with another
dtype than the composed part's, and every output element type through
K6's run-time store.
"""

import ctypes

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_divergent_split as ks
from cvgpuspeedup_tpu_torch.exec import executor
import torch_composed_cases as cc

pytestmark = pytest.mark.gpu

NAMES = cc.SPLIT_NAMES + cc.SPLIT_MORE


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


def _one_launch(a):
    before = (ks.LAUNCHES, kd.LAUNCHES, kc.LAUNCHES)
    got = ks.divergent_split(a)
    assert (ks.LAUNCHES - before[0], kd.LAUNCHES - before[1], kc.LAUNCHES - before[2]) == \
        (1, 0, 0)
    return got


@pytest.mark.parametrize("frames", ["host", "device"])
@pytest.mark.parametrize("name", NAMES)
def test_the_kernel_against_its_plain_version(cuda, name, frames):
    """One launch of the split kernel, bit for bit the eager merge on the
    card, with host arrays and with every frame on the card."""
    f = cc.split_frames(71)
    ids, ops = cc.split_cases(T, f if frames == "host" else _on(cuda, f))[name]
    seqs = _seqs(ops)
    plan = ks.build_split_plan(seqs, ids)
    a = ks.prepare(seqs, plan, cuda)
    _same(_one_launch(a), ks.split_reference(a))


@pytest.mark.parametrize("dtype", ["int8", "uint16", "float16"])
def test_rings_of_other_dtypes(cuda, dtype):
    """DK1 with its ring of int8, uint16 and float16 (K6's general body
    reads every source type)."""
    for name in ("dk1_ring_beside_letterboxes", "dk1_ring_descending"):
        ids, ops = cc.split_cases(T, _on(cuda, cc.split_frames(72, dtype)))[name]
        seqs = _seqs(ops)
        a = ks.prepare(seqs, ks.build_split_plan(seqs, ids), cuda)
        _same(_one_launch(a), ks.split_reference(a))


@pytest.mark.parametrize("name", NAMES)
def test_launch_divergent_batch_is_one_launch_and_builds_no_plan(cuda, name):
    """Twice through ``launch_divergent_batch``, the second call with new
    frames and every runtime value moved: ``cuda:divergent:split``, one
    launch a call and none of the other kernels, no plan on the second,
    each bit for bit the eager merge (``ParBackend.TORCH``)."""
    executor.clear_cache()
    counts = executor.launch_counts()
    builds = executor.PLAN_BUILDS
    for values in (0, 1):
        ids, ops = cc.split_cases(T, _on(cuda, cc.split_frames(73 + values)), values)[name]
        seqs = _seqs(ops)
        got = T.launch_divergent_batch(ids, *seqs)
        assert T.last_backend() == "cuda:divergent:split"
        _same(got, T.launch_divergent_batch(ids, *seqs, backend=T.ParBackend.TORCH))
    after = executor.launch_counts()
    assert {k: after[k] - counts[k] for k in after if after[k] != counts[k]} == \
        {"cuda:divergent:split": 2}
    assert executor.PLAN_BUILDS - builds == 2  # the kernel's and the eager merge's: none more


def test_cuda_raises_on_what_no_route_takes(cuda):
    """``ParBackend.CUDA`` on a batch that no route takes raises, naming
    the three refusals; AUTO runs the eager merge."""
    cams = [torch.randint(0, 256, (20, 24, 3), dtype=torch.uint8, device=cuda) for _ in range(4)]
    seq = T.build_operation_sequence
    resized = seq(T.batch_read([T.resize(T.image(c), T.Size(8, 6)) for c in cams]),
                  T.split_tensor())
    other = seq(T.batch_read([T.resize(T.image(c), T.Size(8, 7)) for c in cams]),
                T.split_tensor())
    ring = seq(T.circular_batch_read(torch.stack(cams), first=1), T.split_tensor())
    with pytest.raises(ValueError, match="cuda:divergent: .*; cuda:composed:divergent: .*; "
                                         "cuda:divergent:split: .*must stack"):
        T.launch_divergent_batch([1, 3, 2, 1], resized, other, ring, backend=T.ParBackend.CUDA)
    with pytest.raises(ValueError, match="gives planes of"):  # the eager merge raises too
        T.launch_divergent_batch([1, 3, 2, 1], resized, other, ring)


def test_the_c_entry_refuses_bad_arguments(cuda):
    """The C entry checks its arguments as ``cvgs_divergent`` does, and the
    composed part's heads: no plane of the composed part, a negative store
    row and a block whose composed words overlap K6's descriptors are
    refused, and the wrapper raises."""
    ids, ops = cc.split_cases(T, cc.split_frames(74))["dk1_ring_beside_letterboxes"]
    seqs = _seqs(ops)
    plan = ks.build_split_plan(seqs, ids)
    a = ks.prepare(seqs, plan, cuda)
    n, width = plan.n_planes, kc.HEAD_INTS
    empty = plan.composed.tables[:n * (width + 1)].copy()
    empty[:n * width] = 0
    negative = plan.composed.tables[:n * (width + 1)].copy()
    negative[n * width + 1] = -1  # plane 1 is the composed part's
    for words in (empty, negative):
        bad = ks.SplitPlan(plane_ids=plan.plane_ids, k6=plan.k6, composed=plan.composed,
                           consts=plan.consts, cm_consts_off=plan.cm_consts_off)
        bad.device_consts["head"] = (ctypes.c_int * words.size)(*words.tolist())
        with pytest.raises(RuntimeError, match="divergent_split launch failed"):
            ks.divergent_split(ks.Launch(plan=bad, seqs=a.seqs, block=a.block, consts=a.consts,
                                         k6=a.k6, composed=a.composed, cm_off=a.cm_off))
    with pytest.raises(RuntimeError, match="divergent_split launch failed"):
        ks.divergent_split(ks.Launch(plan=plan, seqs=a.seqs, block=a.block, consts=a.consts,
                                     k6=a.k6, composed=a.composed, cm_off=a.cm_off - 4))


def test_a_large_batch(cuda):
    """DK4's and DK8's structures over cameras and NV12 buffers of eight
    times the test sides (512x288): one launch, bit for bit the plain
    version."""
    rng = np.random.default_rng(75)
    f = cc.split_frames(75)
    f["wide"] = [rng.integers(0, 256, (288, 512, 3), dtype=np.uint8) for _ in range(8)]
    f["nv12"] = [rng.integers(0, 256, (432, 512), dtype=np.uint8) for _ in range(8)]
    for name in ("dk4_nv12_beside_top_views", "dk8_staged_warps_into_a_u16_batch"):
        ids, ops = cc.split_cases(T, _on(cuda, f))[name]
        seqs = _seqs(ops)
        a = ks.prepare(seqs, ks.build_split_plan(seqs, ids), cuda)
        _same(_one_launch(a), ks.split_reference(a))


#: the split batches whose composed part, over float32 cameras and frame,
#: runs the general body in each form (the uint8 body's are NAMES')
ANY_FORMS = {"dk1_ring_beside_letterboxes": "resample", "dk6_float_part_into_a_u8_batch":
             "one_pixel", "dk9_fused2_into_a_f16_batch": "fused2",
             "dk4_nv12_beside_top_views": "per_tap", "dk8_staged_warps_into_a_u16_batch": "staged"}


@pytest.mark.parametrize("name", sorted(ANY_FORMS))
def test_the_general_instances(cuda, name):
    """Each form's general instance (AnyImage): the composed part's cameras
    and frame as float32, bit for bit the plain version."""
    f = cc.split_frames(76)
    f["wide"] = [c.astype(np.float32) for c in f["wide"]]
    f["big"] = f["big"].astype(np.float32)
    ids, ops = cc.split_cases(T, _on(cuda, f), 0, (name,))[name]
    seqs = _seqs(ops)
    plan = ks.build_split_plan(seqs, ids)
    assert (plan.kind, plan.form) == ("any", ANY_FORMS[name])
    assert ks.instance(plan).endswith(("<AnyImage, 1>", "<AnyImage, 4>", "<AnyImage, false>",
                                       "<AnyImage, true>", "<AnyImage>"))
    a = ks.prepare(seqs, plan, cuda)
    _same(_one_launch(a), ks.split_reference(a))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_a_batch_off_both_parts_tiles(cuda, dtype):
    """A ring of 8 planes of 241x403 beside the cameras resized to it: 3,416
    blocks, a width off both parts' tiles; the composed part's uint8 body,
    or over float32 cameras the general one."""
    ids, ops = cc.split_large(T, np.float32)
    seqs = _seqs(ops)
    if dtype == np.float32:
        seqs = (seqs[0], T.build_operation_sequence(
            T.batch_read([T.resize(T.image(torch.from_numpy(c.astype(np.float32)).to(cuda)),
                                   T.Size(403, 241)) for c in cc.split_frames(94)["wide"]]),
            T.convert_to(np.float32, alpha=1 / 255.0), T.split_tensor()))
    plan = ks.build_split_plan(seqs, ids)
    assert sum(p.blocks for p in plan.tiles()) == 2 * 4 * 7 * 61
    assert plan.kind == ("uint8" if dtype == np.uint8 else "any")
    a = ks.prepare(seqs, plan, cuda)
    _same(_one_launch(a), ks.split_reference(a))


@pytest.mark.parametrize("dtype", cc.SPLIT_OUT_DTYPES)
def test_every_output_type_through_the_run_time_store(cuda, dtype):
    """K6's part at plane 0 (a ring of the batch's dtype) stores into each
    output element type through its run-time store, beside letterboxes
    converted into it."""
    ids, ops = cc.split_ring_beside_letterboxes(T, _on(cuda, cc.split_frames(77)), dtype)
    seqs = _seqs(ops)
    plan = ks.build_split_plan(seqs, ids)
    assert plan.out_dtype == getattr(torch, dtype) and plan.parts[0] == 0
    a = ks.prepare(seqs, plan, cuda)
    _same(_one_launch(a), ks.split_reference(a))
