"""The divergent kernel (K6) on every source dtype: groups of int8, uint16,
int16, float16, int32 and int64 sources, each kind that reads an image
(a ring from two ``first`` s, a batched stack, a ragged ``BatchRead`` of
images, ``resize_batch`` of one frame, a stack resize, affine and
perspective ``warp_batch`` es, ragged), and batches that mix groups of
different source dtypes.

Each batch is built with the JAX package's factories and carried across
with ``from_jax``. An int64 source, which ``from_jax`` would make int32, is
given to the port's factories as a host array (made int32 before its copy)
and as a tensor (whose int64 elements the kernel reads at load), and to the
reference's as a ``jnp`` value (int32, its low 32 bits: a numpy leaf keeps
64 bits in some of its ops outside jit). A group that is not plane 0's ends
its chain in the batch's dtype: the reference's merge scatters a group of
another dtype through JAX's type promotion (``.at[].set``), which rounds an
int32 batch's other planes through float32 (ROADMAP §3). Each case asserts:

- ``kd.build_plan`` takes it and ``executor._select_divergent`` picks
  ``cuda:divergent`` for a CUDA device, without touching one (AUTO and
  CUDA), and the plan runs the general instance (``plan.general``);
- each group's type word, in the plan and in the descriptor ``prepare``
  writes;
- the port's eager merge (``launch_divergent_batch`` on CPU tensors) and the
  kernel's plain version equal the reference's merge rebuilt op by op
  (``test_torch_divergent.reference_merge``) bit for bit;
- against the reference's jitted XLA merge: float32 within 1e-4 on the
  values' scale, uint8 within 1 and float16 within one of its steps (XLA-CPU
  contracts the lerps into FMAs, ROADMAP §3), every other integer output
  bit for bit.

int32 and int64 copy groups hold values within 200 of int32's bounds and
past 2^24 (``test_torch_int32.int32_values``), which a float32 conversion
would round.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.parallel import mesh as pmesh
from test_torch_divergent import reference_merge
from test_torch_int32 import int32_values

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # nothing touches it: the choice is made on shapes and dtypes
N, H, W = 6, 6, 9
DSIZE = (8, 6)  # the resampled groups' (W, H)
#: the source dtypes K6 reads beside uint8, float32 and float64; "int64"
#: is a host array, "int64_tensor" a tensor
DTYPES = ("int8", "uint16", "int16", "float16", "int32", "int64", "int64_tensor")
#: each dtype's descriptor word as the kernel reads it (a host int64 array
#: reaches the card as int32)
WORDS = {"int8": 3, "uint16": 4, "int16": 5, "float16": 6, "int32": 7, "int64": 7,
         "int64_tensor": 8, "uint8": 1, "float32": 0}
#: a ragged group's default per dtype: cast to the read's dtype, truncated
#: and saturated (int32 and int64 past int32's range). The reference casts a
#: default as XLA converts (saturating) when it is a device array, as numpy
#: does (wrapping) when it is a host one outside jit: it gets a jnp value
DEFAULTS = {"int8": -130.5, "uint16": 70000.5, "int16": -1.5, "float16": 0.1, "int32": 3e9,
            "int64": -2.5e9, "int64_tensor": -2.5e9}
#: a chain's scale that brings a dtype's values to a few hundred
ALPHA = {"int8": 1.5, "uint16": 1 / 128.0, "int16": 1 / 96.0, "float16": 0.25, "int32": 2.0 ** -23,
         "int64": 2.0 ** -23, "int64_tensor": 2.0 ** -23, "uint8": 0.5, "float32": 0.5}


def values(dtype, shape, seed):
    """Source values of ``dtype`` over its whole range; int32 and int64 near
    int32's bounds and past 2^24, int64 with high bits that vary (its low 32
    bits are what the reference keeps)."""
    rng = np.random.default_rng(seed)
    if dtype in ("int32", "int64", "int64_tensor"):
        v = int32_values(shape, seed)
        if dtype == "int32":
            return v
        return v.astype(np.int64) + rng.integers(-3, 4, shape) * 2 ** 32
    if dtype == "float16":
        return (rng.integers(-2000, 2000, shape) / 4).astype(np.float16)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


def rotation(center, angle, scale):
    """``cv2.getRotationMatrix2D``."""
    a = math.radians(angle)
    al, be = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])


PERSPECTIVE = np.array([[0.9, 0.05, 1.0], [0.02, 0.85, 0.5], [1e-2, 2e-2, 1.0]])


def kind_case(F, kind, dtype):
    """``(plane ids, sequences)`` of one kind over a source of ``dtype``,
    built with the factories of ``F``: an int64 source as a ``jnp`` value
    for the reference's, a host array or (``int64_tensor``) a tensor for
    the port's. Plane 0's group gives the batch its dtype: the source's own
    for the copy kinds (a group beside it goes through float32 and back),
    float32 for the resampling ones (a copy group of the same source into
    float32 beside them)."""
    src = "int64" if dtype == "int64_tensor" else dtype

    def leaf(a):
        if F is J:
            return jnp.asarray(a) if src == "int64" else a
        return torch.from_numpy(a) if dtype == "int64_tensor" else a

    stack = leaf(values(src, (N, H, W, 3), 1))
    seq = F.build_operation_sequence
    to_f32 = F.convert_to(np.float32, alpha=ALPHA[dtype])
    default = (jnp.float32 if F is J else np.float32)(DEFAULTS[dtype])
    if kind in ("ring_first3", "ring_first_minus5", "stack", "batch_read_ragged"):
        back = F.convert_to({"int64": np.int32}.get(src, np.dtype(src)))
        other = seq(F.image(stack), to_f32, F.multiply(3.0), back, F.write_tensor())
    if kind in ("ring_first3", "ring_first_minus5"):
        first = 3 if kind == "ring_first3" else -5
        return [1, 2, 1, 2, 2, 1], (
            seq(F.circular_batch_read(stack, first=first), F.write_tensor()),
            seq(F.circular_batch_read(stack, first=first, ascendent=False), to_f32,
                F.multiply(3.0), back, F.write_tensor()))
    if kind == "stack":
        return [1, 2, 2, 1, 2, 1], (seq(F.image(stack), F.write_tensor()), other)
    if kind == "batch_read_ragged":
        imgs = [leaf(values(src, (H, W, 3), 10 + z)) for z in range(N)]
        return [1, 1, 2, 1, 1, 2], (
            seq(F.batch_read([F.image(im) for im in imgs], used_planes=3, default=default),
                F.write_tensor()), other)
    copy = seq(F.image(leaf(values(src, (N, DSIZE[1], DSIZE[0], 3), 2))), to_f32,
               F.write_tensor())
    dsize = F.Size(*DSIZE)
    if kind == "resize_batch":
        frame = leaf(values(src, (20, 24, 3), 3))
        rects = np.array([[3 * z - 2, 2 * z, 9, 7] for z in range(N)], np.int32)
        first = seq(F.resize_batch(frame, rects=rects, dsize=dsize, background=(5.0, 6.0, 7.0),
                                   aspect_ratio=F.AspectRatio.PRESERVE_AR, used_planes=5),
                    to_f32, F.write_tensor())
    elif kind == "stack_resize":
        sizes = [(7, 5), (12, 16), (5, 11), (6, 8), (9, 9), (4, 13)]
        imgs = [leaf(values(src, (h, w, 3), 20 + z)) for z, (h, w) in enumerate(sizes)]
        first = seq(F.resize_batch(imgs, dsize=dsize), to_f32, F.write_tensor())
    else:
        persp = kind == "warp_perspective_ragged"
        imgs = [leaf(values(src, (10, 12, 3), 30 + z)) for z in range(N)]
        mats = [PERSPECTIVE] * N if persp else [rotation((6, 5), 9.0 * z - 20, 0.9)
                                                for z in range(N)]
        first = seq(F.warp_batch([F.image(im) for im in imgs], mats, dsize,
                                 warp_type=F.WarpType.PERSPECTIVE if persp else F.WarpType.AFFINE,
                                 border_value=2.0, used_planes=4, default=default),
                    to_f32, F.write_tensor())
    return [1, 2, 1, 1, 2, 1], (first, copy)


KINDS = ("ring_first3", "ring_first_minus5", "stack", "batch_read_ragged", "resize_batch",
         "stack_resize", "warp_affine_ragged", "warp_perspective_ragged")
#: each kind's group kinds in the plan
PLAN_KINDS = {"ring_first3": ["circ", "circ"], "ring_first_minus5": ["circ", "circ"],
              "stack": ["image", "image"], "batch_read_ragged": ["image", "image"],
              "resize_batch": ["crop_resize", "image"], "stack_resize": ["resize", "image"],
              "warp_affine_ragged": ["warp", "image"], "warp_perspective_ragged": ["warp", "image"]}


def mixed_case(F, name):
    """Batches of groups of different source dtypes: a uint16 ring beside
    uint8 crops into a uint8 batch, a float16 stack beside a float32 warp
    into a float16 batch."""
    seq = F.build_operation_sequence
    if name == "u16_ring_u8_crops_into_u8":
        ring = values("uint16", (N, H, W, 3), 4)
        frame = values("uint8", (20, 24, 3), 5)
        rects = np.array([[2 * z, z, 8, 6] for z in range(N)], np.int32)
        return [1, 2, 1, 2, 2, 1], (
            seq(F.circular_batch_read(ring, first=-2), F.convert_to(np.uint8, alpha=1 / 257.0),
                F.write_tensor()),
            seq(F.resize_batch(frame, rects=rects, dsize=F.Size(W, H)),
                F.convert_to(np.float32, alpha=0.5), F.write_tensor()))
    stack = values("float16", (N, H, W, 3), 6)
    imgs = [values("uint8", (10, 12, 3), 40 + z).astype(np.float32) for z in range(N)]
    return [1, 2, 2, 1, 2, 1], (
        seq(F.image(stack), F.write_tensor()),
        seq(F.warp_batch([F.image(im) for im in imgs],
                         [rotation((6, 5), 7.0 * z, 1.1) for z in range(N)], F.Size(W, H)),
            F.multiply(0.75), F.write_tensor()))


MIXED = {"u16_ring_u8_crops_into_u8": (["uint16", "uint8"], torch.uint8),
         "f16_stack_f32_warp_into_f16": (["float16", "float32"], torch.float16)}


def _host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_bits(actual, expected, msg):
    a, e = _host(actual), _host(expected)
    assert a.shape == e.shape and a.dtype == e.dtype, f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}"
    bad = int((_bits(a) != _bits(e)).sum())
    assert bad == 0, f"{msg}: {bad} values differ in their bits"


def _assert_xla(actual, expected, msg):
    a, e = _host(actual), _host(expected)
    assert a.shape == e.shape and a.dtype == e.dtype, f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}"
    if a.dtype == np.float32:
        d = np.abs(a.astype(np.float64) - e).max() / max(1.0, np.abs(e).max() / 255)
        assert d <= 1e-4, f"{msg}: max |diff| {d} on the 0..255 scale"
    elif a.dtype == np.float16:
        d = np.abs(a.astype(np.float64) - e) / np.maximum(np.abs(e.astype(np.float64)), 2.0 ** -14)
        assert d.max() <= 2.0 ** -10, f"{msg}: {d.max()} float16 steps"
    elif a.dtype == np.uint8:
        assert np.abs(a.astype(np.int32) - e).max() <= 1, msg
    else:
        _assert_bits(a, e, msg)


def check(ids, jseqs, tseqs, words, out_dtype):
    """Every assertion of the module docstring; returns the plan."""
    plan = kd.build_plan(tseqs, ids)
    assert plan.general and plan.out_dtype == out_dtype
    for backend in (T.ParBackend.AUTO, T.ParBackend.CUDA):
        assert executor._select_divergent(tseqs, ids, backend, CUDA).backend == "cuda:divergent"
    a = kd.prepare(tseqs, plan, CPU)
    desc = a.block[a.desc_off:].view(len(plan.groups), kd.DESC_INTS)
    assert [kd._SRC_WORDS[g.src_dtype] for g in plan.groups] == words
    assert desc[:, 4].tolist() == words
    eager = T.launch_divergent_batch(ids, *tseqs, device="cpu")
    assert T.last_backend() == "torch:divergent"
    want = reference_merge(ids, *jseqs)
    _assert_bits(eager, want, "eager vs the reference op by op")
    _assert_bits(kd.divergent(a), want, "plain version vs the reference op by op")
    _assert_xla(eager, J.launch_divergent_batch(ids, *jseqs, backend=J.ParBackend.XLA),
                "eager vs the reference's XLA merge")
    return plan


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_group_of_each_source_dtype(dtype, kind):
    ids, jseqs = kind_case(J, kind, dtype)
    if dtype in ("int64", "int64_tensor"):  # from_jax would make the int64 arrays int32
        tseqs = kind_case(T, kind, dtype)[1]
    else:
        tseqs = tuple(from_jax(s) for s in jseqs)
    copy = kind in ("ring_first3", "ring_first_minus5", "stack", "batch_read_ragged")
    canonical = {"int64": "int32", "int64_tensor": "int32"}.get(dtype, dtype)
    plan = check(ids, jseqs, tseqs, [WORDS[dtype]] * 2,
                 getattr(torch, canonical) if copy else torch.float32)
    assert [g.kind for g in plan.groups] == PLAN_KINDS[kind]
    if kind == "batch_read_ragged":  # the default, cast to the read's dtype
        assert plan.groups[0].held == getattr(torch, canonical)


@pytest.mark.parametrize("name", list(MIXED))
def test_groups_of_different_source_dtypes_in_one_batch(name):
    ids, jseqs = mixed_case(J, name)
    dtypes, out_dtype = MIXED[name]
    check(ids, jseqs, tuple(from_jax(s) for s in jseqs), [WORDS[d] for d in dtypes], out_dtype)


def test_a_copy_keeps_int32_bits_past_2_24():
    """An int32 ring and an int64 tensor ring copied: every element equals the
    source (the int64 one's low 32 bits), values within 200 of int32's
    bounds among them, through the plain version and the eager merge."""
    v = values("int64_tensor", (N, H, W, 3), 7)
    for ring in (torch.from_numpy(v.astype(np.int32)), torch.from_numpy(v)):
        read = T.circular_batch_read(ring, first=2)
        seqs = (T.build_operation_sequence(read, T.write_tensor()),)
        plan = kd.build_plan(seqs, [1] * N)
        got = kd.run(seqs, plan, CPU)
        low = torch.from_numpy(v.astype(np.int32)).roll(-2, dims=0)
        assert got.dtype == torch.int32 and torch.equal(got, low)
        assert torch.equal(T.launch_divergent_batch([1] * N, *seqs, device="cpu"), low)
        assert int(low.abs().max()) > 2 ** 31 - 200


@pytest.mark.parametrize("dtype", ["uint32", "bool"])
def test_only_uint32_and_bool_sources_are_refused(dtype):
    stack = np.ones((N, H, W, 3), dtype)
    seqs = (T.build_operation_sequence(T.image(torch.from_numpy(stack.astype(np.uint8)).to(
        getattr(torch, dtype))), T.write_tensor()),)
    with pytest.raises(kd.Unsupported, match=f"source dtype {dtype}"):
        kd.build_plan(seqs, [1] * N)


@pytest.mark.parametrize("nsh", [2, 4])
@pytest.mark.parametrize("dtype", ["uint16", "int32", "int64_tensor"])
def test_every_rank_of_a_sharded_batch_reaches_the_kernel(dtype, nsh):
    """What ``execute_divergent_sharded`` runs on each rank of a mesh of
    ``nsh`` (``_local_pipeline`` of every sequence: the ring a rank view,
    the stack and rects sliced, the frame shared) is routed to
    ``cuda:divergent``, and the ranks' plain versions joined equal the
    unsharded batch bit for bit."""
    src = "int64" if dtype == "int64_tensor" else dtype

    def leaf(a):
        return torch.from_numpy(a)

    ring = leaf(values(src, (8, H, W, 3), 8))
    frame = leaf(values(src, (20, 24, 3), 9))
    rects = np.array([[2 * z, z, 9, 7] for z in range(8)], np.int32)
    seq = T.build_operation_sequence
    to_f32 = T.convert_to(np.float32, alpha=ALPHA[dtype])
    seqs = (seq(T.circular_batch_read(ring, first=-3), to_f32, T.write_tensor()),
            seq(T.image(ring), to_f32, T.add(1.0), T.write_tensor()),
            seq(T.resize_batch(frame, rects=rects, dsize=T.Size(W, H)), to_f32,
                T.write_tensor()))
    ids = [1 + z % 3 for z in range(8)]
    whole = T.launch_divergent_batch(ids, *seqs, device="cpu")
    ln = 8 // nsh
    parts = []
    for i in range(nsh):
        local = tuple(pmesh._local_pipeline(s, i, nsh, len(ids)) for s in seqs)
        mine = ids[i * ln:(i + 1) * ln]
        assert executor._select_divergent(local, mine, T.ParBackend.AUTO, CUDA).backend == \
            "cuda:divergent"
        plan = kd.build_plan(local, mine)
        assert plan.general and {g.src_dtype for g in plan.groups} == {getattr(torch, src)}
        parts.append(kd.run(local, plan, CPU))
    _assert_bits(torch.cat(parts), whole, "the ranks joined vs the unsharded batch")
