"""Batch sharding on the card: what ``chip_smoke.py``'s sharding phase checks
at full size, here at reduced sizes. Every rank of a mesh runs its local
pipeline (``parallel/mesh.py::_local_pipeline``, the function both sharded
entry points use) on the one card. Needs a CUDA device and skips without
one. On a machine with a card and without jax, run it alone:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_mesh.py

Each rank must be one launch of its kernel, equal to the kernel's plain
version on the card bit for bit; no rank after the first may build a plan
(a divergent batch: one per distinct local routing), neither may a second
round with new rects, ``first`` and ``used_planes``; the ranks' outputs,
joined on the plane axis, must equal the unsharded kernel's bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.parallel import mesh as pmesh

pytestmark = pytest.mark.gpu

KERNELS = {"batch_resize": (kbr, kbr.batch_resize_reference), "warp": (kw, kw.warp_reference),
           "pointwise": (kp, kp.pointwise_reference)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _u8(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


def rotation(center, angle, scale):
    """``cv2.getRotationMatrix2D``."""
    a = math.radians(angle)
    al, be = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])


def _hold_ranks(make, nsh, kernel, cuda, dim=0):
    """Two rounds of the pipeline ``make(k)``, each unsharded and rank by
    rank on the card."""
    module, plain = KERNELS[kernel]
    builds = None
    for k in range(2):
        p = make(k)
        whole = executor.run_pipeline(p, device=cuda)
        outs = []
        for i in range(nsh):
            loc = pmesh._local_pipeline(p, i, nsh)
            launches = module.LAUNCHES
            out = executor.run_pipeline(loc, device=cuda)
            assert executor.last_backend() == f"cuda:{kernel}"
            assert module.LAUNCHES == launches + 1
            if builds is None:
                builds = executor.PLAN_BUILDS
            assert executor.PLAN_BUILDS == builds, f"round {k} rank {i} built a plan"
            want = plain(module.prepare(loc, module.build_plan(loc), cuda))
            assert torch.equal(out, want), f"round {k} rank {i} against the plain version"
            outs.append(out)
        assert torch.equal(torch.cat(outs, dim), whole), f"round {k}: ranks against unsharded"


@pytest.mark.parametrize("nsh", [2, 5])
def test_flagship_ranks(cuda, nsh):
    rng = np.random.default_rng(1)
    frame = torch.from_numpy(_u8(rng, (270, 480, 3))).to(cuda)

    def make(k):
        rects = np.array([[7 * i + 5 * k, 3 * i + k, 60, 120] for i in range(20)], np.int32)
        return T.build_pipeline(
            T.resize_batch(frame, rects=rects, dsize=T.Size(32, 64), used_planes=13 - 4 * k,
                           background=3.0),
            T.convert_to(np.float32, alpha=0.3), T.subtract((3.2, 0.6, 11.8)), T.split_tensor())

    _hold_ranks(make, nsh, "batch_resize", cuda)


@pytest.mark.parametrize("nsh", [2, 4, 8])
def test_warp_batch_ranks(cuda, nsh):
    frame = torch.from_numpy(_u8(np.random.default_rng(2), (96, 160, 3))).to(cuda)

    def make(k):
        mats = [rotation((80, 48), 3.0 * i - 10 + 2 * k, 1.0 + 0.04 * i) for i in range(8)]
        return T.build_pipeline(
            T.warp_batch([frame] * 8, mats, T.Size(64, 32), used_planes=7 - 2 * k, default=3.0),
            T.convert_to(np.float32, alpha=1 / 255.0), T.split_tensor())

    _hold_ranks(make, nsh, "warp", cuda)


@pytest.mark.parametrize("nsh", [2, 4, 8])
def test_ring_ranks(cuda, nsh):
    ring = torch.from_numpy(_u8(np.random.default_rng(3), (16, 16, 32, 3))).to(cuda)

    def make(k):
        return T.build_pipeline(T.circular_batch_read(ring, first=(3, -5)[k]),
                                T.convert_to(np.float32, alpha=0.3),
                                T.subtract((1.0, 2.0, 3.0)), T.split_tensor())

    _hold_ranks(make, nsh, "pointwise", cuda)


@pytest.mark.parametrize("nsh", [2, 4])
def test_transposed_image_ranks(cuda, nsh):
    batch = torch.from_numpy(_u8(np.random.default_rng(4), (8, 16, 32, 3))).to(cuda)
    _hold_ranks(lambda k: T.build_pipeline(T.image(batch.roll(k, 0)), T.multiply(0.5 + k),
                                           T.split_tensor_transposed()),
                nsh, "pointwise", cuda, dim=1)


def _d1(k, n=16):
    ring = _u8(np.random.default_rng(5), (n, 32, 64, 3))
    read = T.circular_batch_read(ring, first=(3, -5)[k])
    seq = T.build_operation_sequence
    return [1 if z % 2 == 0 else 2 for z in range(n)], (
        seq(read, T.convert_to(np.float32, alpha=0.3), T.subtract((1.0, 2.0, 3.0)),
            T.write_tensor()),
        seq(read, T.convert_to(np.float32, alpha=0.5), T.multiply((2.0, 1.0, 0.5)),
            T.write_tensor()))


def _d3(k, n=8):
    rng = np.random.default_rng(6)
    frame = _u8(rng, (270, 480, 3))
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    rects = np.array([[13 * z + 7 * k, 9 * z + 7 * k, 60, 120] for z in range(n)], np.int32)
    seq = T.build_operation_sequence
    return [1 if z % 3 else 2 for z in range(n)], (
        seq(T.resize_batch(frame, rects=rects, dsize=T.Size(64, 128)),
            T.convert_to(np.float32, alpha=0.5), T.subtract((1.0, 2.0, 3.0)), T.write_tensor()),
        seq(T.image(flat), T.multiply(2.0), T.write_tensor()))


@pytest.mark.parametrize("nsh", [2, 4, 8])
@pytest.mark.parametrize("row", ["d1", "d3"])
def test_divergent_ranks(cuda, row, nsh):
    make = {"d1": _d1, "d3": _d3}[row]
    executor.clear_cache()
    seen, builds = set(), None
    for k in range(2):
        ids, seqs = make(k)
        whole = T.launch_divergent_batch(ids, *seqs, device=cuda)
        ln = len(ids) // nsh
        outs = []
        for i in range(nsh):
            local = tuple(pmesh._local_pipeline(s, i, nsh, len(ids)) for s in seqs)
            local_ids = ids[i * ln:(i + 1) * ln]
            if builds is None:
                builds = executor.PLAN_BUILDS
            launches = kd.LAUNCHES
            out = T.launch_divergent_batch(local_ids, *local, device=cuda)
            seen.add(tuple(local_ids))
            assert T.last_backend() == "cuda:divergent" and kd.LAUNCHES == launches + 1
            assert executor.PLAN_BUILDS == builds + len(seen), "a plan per distinct routing"
            want = kd.divergent_reference(kd.prepare(local, kd.build_plan(local, local_ids), cuda))
            assert torch.equal(out, want), f"round {k} rank {i} against the plain version"
            outs.append(out)
        assert torch.equal(torch.cat(outs), whole), f"round {k}: ranks against unsharded"
