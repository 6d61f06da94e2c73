"""Batch sharding: the port's ``parallel/mesh.py`` against the JAX package's,
case by case as ``tests/test_parallel.py`` pins the reference.

Each case is built with the JAX factories from numpy inputs made from a
seed, run through the reference's ``execute_sharded`` on the conftest's
8-device CPU mesh (``ParBackend.XLA``), and carried across unsharded with
``from_jax``. The port shards it with the rank-local function both entry
points use (``_local_pipeline``), for ranks 0..7 in this process, and runs
each rank through the executor (the eager path on the CPU) and through its
kernel's plain version (``cuda_*.run`` on CPU tensors, after the kernel's
``build_plan`` took the local pipeline). The ranks' outputs, joined on the
write layout's plane axis, must equal the port's unsharded output bit for
bit, and the reference's sharded output within 1e-4 on the 0..255 scale
(uint8 within 1: the reference's jitted XLA-CPU path contracts
multiply-adds into FMAs, ROADMAP §3). The reference's Pallas-interpret cases
become the plain version against the reference's sharded XLA output.

``test_two_processes_over_gloo`` runs the entry points themselves in two
processes of one gloo group (``tests/torch_mesh_worker.py``).
"""

import time

import cv2
import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu.parallel import mesh as jmesh
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import flatten
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.ops.memory import TensorTSplit
from cvgpuspeedup_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")
NSH = 8
F32_TOL = 1e-4        # against the reference's sharded XLA output, on values of 0..255
GLOO_TIMEOUT_S = 60   # both processes, spawned, started and through every case


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == NSH, "conftest must set 8 virtual CPU devices"
    return jmesh.make_mesh(NSH)


def _rng(seed):
    return np.random.default_rng(seed)


def _u8(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


def _close(port, ref, msg=""):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (msg, port.shape, port.dtype,
                                                                 ref.shape, ref.dtype)
    diff = np.abs(port.astype(np.float64) - ref.astype(np.float64)).max()
    if port.dtype.kind == "f":
        tol = F32_TOL * max(1.0, float(np.abs(ref).max()) / 255)
    else:
        tol = 1
    assert diff <= tol, (msg, diff, tol)


def _ranks(p):
    """The port's local pipelines of ranks 0..7; every one has the same
    structure key, so one plan serves them all."""
    locs = [pmesh._local_pipeline(p, i, NSH) for i in range(NSH)]
    assert len({flatten(loc)[0] for loc in locs}) == 1
    return locs


def _shard(jops, mesh8, kernel):
    """Hold the port's ranks 0..7 of the pipeline ``jops()`` against its
    unsharded output (bit for bit, through the executor and through the
    kernel's plain version) and the reference's sharded output. Returns
    ``(local pipelines, unsharded output)``."""
    p = from_jax(J.build_pipeline(*jops()))
    dim = 1 if isinstance(p.write, TensorTSplit) else 0
    whole = executor.run_pipeline(p, device="cpu")
    locs = _ranks(p)
    ln = int(whole.shape[dim]) // NSH
    eager = torch.cat([executor.run_pipeline(loc, device="cpu") for loc in locs], dim)
    plans = [kernel.build_plan(loc) for loc in locs]
    assert all(plan.n_planes == ln for plan in plans)
    plain = torch.cat([kernel.run(loc, plan, CPU) for loc, plan in zip(locs, plans)], dim)
    assert torch.equal(eager, whole) and torch.equal(plain, whole)
    ref = jmesh.execute_sharded(*jops(), mesh=mesh8, backend=J.ParBackend.XLA)
    _close(whole, ref, "against the reference's sharded output")
    return locs, whole


def test_public_names_are_the_references():
    assert pmesh.__all__ == jmesh.__all__
    for name in pmesh.__all__:
        assert callable(getattr(pmesh, name))


def _flagship(frame, rects, **kw):
    return lambda: [
        J.resize_batch(frame, rects=rects, dsize=J.Size(64, 128), **kw),
        J.convert_to(np.float32, alpha=0.3),
        J.subtract((3.2, 0.6, 11.8)),
        J.divide((128.0, 128.0, 128.0)),
        J.split_tensor(),
    ]


def test_sharded_flagship_matches_single(mesh8):
    rng = _rng(1)
    frame = _u8(rng, (296, 384, 3))
    rects = np.array([[i, i, 60, 120] for i in range(16)], np.int32)
    locs, _ = _shard(_flagship(frame, rects), mesh8, kbr)
    for i, loc in enumerate(locs):
        assert loc.read.frame is locs[0].read.frame, "the frame is shared, not copied"
        np.testing.assert_array_equal(loc.read.rects, rects[2 * i:2 * i + 2])


def test_sharded_ragged_used_planes(mesh8):
    """Global used_planes is rebased per shard (planes 0..10 active of 16)."""
    rng = _rng(2)
    frame = _u8(rng, (296, 384, 3))
    rects = np.array([[i, i, 40, 80] for i in range(16)], np.int32)

    def ops():
        return [J.resize_batch(frame, rects=rects, dsize=J.Size(32, 64), used_planes=11,
                               background=5.0)]

    locs, whole = _shard(ops, mesh8, kbr)
    assert [int(loc.read.used_planes) for loc in locs] == [2, 2, 2, 2, 2, 1, 0, 0]
    assert bool((whole[11:] == 5.0).all())


def test_sharded_batched_image_pipeline(mesh8):
    batch = _u8(_rng(3), (8, 16, 32, 3))
    _shard(lambda: [J.image(batch), J.convert_to(np.float32, alpha=2.0), J.split_tensor()],
           mesh8, kp)


def test_sharded_transposed_layout(mesh8):
    batch = _u8(_rng(4), (8, 16, 32, 3))
    locs, whole = _shard(lambda: [J.image(batch), J.split_tensor_transposed()], mesh8, kp)
    assert tuple(whole.shape) == (3, 8, 16, 32)
    assert tuple(executor.run_pipeline(locs[3], device="cpu").shape) == (3, 1, 16, 32)


def test_sharded_warp_batch(mesh8):
    """BatchRead (warp_batch) sharding: per-plane matrices go with their
    planes, the shared source frame stays one object."""
    frame = _u8(_rng(5), (64, 128, 3))
    mats = [np.array([[1.0, 0.0, float(i)], [0.0, 1.0, float(i) / 2]], np.float32)
            for i in range(8)]
    _shard(lambda: [J.warp_batch([jax.device_put(frame)] * 8, mats, J.Size(32, 16)),
                    J.convert_to(np.float32, alpha=0.5)], mesh8, kw)
    shared = torch.from_numpy(frame)
    p = T.build_pipeline(T.warp_batch([shared] * 8, mats, T.Size(32, 16)))
    for loc in _ranks(p):
        assert len(loc.read.ops) == 1 and loc.read.ops[0].source.data is shared


def test_sharded_warp_batch_ragged(mesh8):
    frame = jax.device_put(_u8(_rng(6), (64, 128, 3)))
    mats = [np.array([[1.0, 0.0, float(i)], [0.0, 1.0, 0.0]], np.float32) for i in range(8)]
    locs, whole = _shard(lambda: [J.warp_batch([frame] * 8, mats, J.Size(32, 16),
                                               used_planes=5, default=7.0)], mesh8, kw)
    assert [int(loc.read.used_planes) for loc in locs] == [1, 1, 1, 1, 1, 0, 0, 0]
    assert bool((whole[5:] == 7.0).all())


@pytest.mark.parametrize("ascendent", [True, False])
@pytest.mark.parametrize("first", [0, 3, 15])
def test_sharded_circular_batch_read(mesh8, first, ascendent):
    """The ring stays whole on every rank, ``first`` moves by the rank's
    plane offset; every rotation matches the unsharded modular view."""
    ring = _u8(_rng(7), (16, 8, 16, 3))
    locs, _ = _shard(lambda: [J.circular_batch_read(ring, first=first, ascendent=ascendent),
                              J.convert_to(np.float32, alpha=1.0)], mesh8, kp)
    for i, loc in enumerate(locs):
        assert isinstance(loc.read, pmesh._LocalRingView) and loc.read.num_planes == 2
        assert loc.read.data is locs[0].read.data, "the ring is shared, not copied"
        assert int(loc.read.first) == (first + 2 * i if ascendent else first - 2 * i)


def test_sharded_pallas_interpret_bitexact(mesh8):
    """The reference runs its Pallas emitter inside shard_map here; the
    port's counterpart is K1's plain version on each rank's planes, ragged
    tail included, against the reference's sharded XLA output."""
    rng = _rng(8)
    frame = _u8(rng, (296, 384, 3))
    rects = np.array([[i, i, 60, 120] for i in range(16)], np.int32)
    _, whole = _shard(_flagship(frame, rects, used_planes=13, background=7.0), mesh8, kbr)
    tail = whole[13:]  # the background through the chain, on every plane of the tail
    assert torch.equal(tail, tail[:1].expand_as(tail))
    assert all(tail[0, c].unique().numel() == 1 for c in range(3))


def test_plane_count_must_divide(mesh8):
    frame = _u8(_rng(9), (296, 384, 3))
    rects = np.array([[0, 0, 8, 8]] * 6, np.int32)
    with pytest.raises(ValueError):
        jmesh.execute_sharded(J.resize_batch(frame, rects=rects, dsize=J.Size(8, 8)), mesh=mesh8)
    p = T.build_pipeline(T.resize_batch(frame, rects=rects, dsize=T.Size(8, 8)))
    with pytest.raises(ValueError, match="must divide"):
        pmesh._local_pipeline(p, 0, NSH)


def test_sharded_warp_batch_pallas_kernel(mesh8):
    """The reference's sharded Pallas batch warp becomes the warp kernel's
    plain version on each rank's planes, against the sharded XLA output."""
    frame = jax.device_put(_u8(_rng(10), (96, 384, 3)))
    mats = [cv2.getRotationMatrix2D((192, 48), 3.0 * i - 10, 1.0 + 0.05 * i) for i in range(8)]
    _shard(lambda: [J.warp_batch([frame] * 8, mats, J.Size(128, 64)), J.multiply(0.5),
                    J.split_tensor()], mesh8, kw)


def _divergent_case(n=16):
    rng = _rng(11)
    frame = _u8(rng, (296, 384, 3))
    rects = np.array([[5 * z, 3 * z, 60, 120] for z in range(n)], np.int32)
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    ring = _u8(rng, (n, 128, 64, 3))
    seqs = (
        J.build_operation_sequence(J.resize_batch(frame, rects=rects, dsize=J.Size(64, 128)),
                                   J.convert_to(np.float32, alpha=0.5), J.write_tensor()),
        J.build_operation_sequence(J.image(flat), J.multiply(2.0), J.write_tensor()),
        J.build_operation_sequence(J.circular_batch_read(ring, first=5),
                                   J.convert_to(np.float32, alpha=0.25), J.write_tensor()),
    )
    return [1 + (z % 3) for z in range(n)], seqs


def test_sharded_divergent(mesh8):
    """A divergent batch: each rank runs its slice of the plane ids over its
    local sequences (rects and stacks sliced, the frame shared, the ring a
    rank view) in one call, with one plan per distinct local routing."""
    ids, jseqs = _divergent_case()
    ref = jmesh.execute_divergent_sharded(ids, *jseqs, mesh=mesh8, backend=J.ParBackend.XLA)
    seqs = from_jax(jseqs)
    whole = T.launch_divergent_batch(ids, *seqs, device="cpu")
    locals_ = [tuple(pmesh._local_pipeline(s, i, NSH, len(ids)) for s in seqs)
               for i in range(NSH)]
    assert len({flatten(loc)[0] for loc in locals_}) == 1
    routings = [tuple(ids[2 * i:2 * i + 2]) for i in range(NSH)]
    executor.clear_cache()
    builds = executor.PLAN_BUILDS
    eager = torch.cat([T.launch_divergent_batch(r, *loc, device="cpu")
                       for r, loc in zip(routings, locals_)])
    assert executor.PLAN_BUILDS - builds == len(set(routings)) == 3
    plain = torch.cat([kd.run(loc, kd.build_plan(loc, r), CPU)
                       for r, loc in zip(routings, locals_)])
    assert torch.equal(eager, whole) and torch.equal(plain, whole)
    _close(whole, ref, "against the reference's sharded divergent output")


def test_sharded_divergent_rebases_a_ragged_resize_group():
    """A ragged crop-resize group: each rank masks from its own rebased
    count, so the ranks joined equal the unsharded batch (the reference's
    sharded divergent path keeps the global count in every shard, ROADMAP
    §3; its unsharded output is the oracle here)."""
    rng = _rng(15)
    n = 16
    frame = _u8(rng, (296, 384, 3))
    rects = np.array([[5 * z, 3 * z, 60, 120] for z in range(n)], np.int32)
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    jseqs = (J.build_operation_sequence(J.resize_batch(frame, rects=rects, dsize=J.Size(64, 128),
                                                       used_planes=11, background=5.0),
                                        J.write_tensor()),
             J.build_operation_sequence(J.image(flat), J.write_tensor()))
    ids = [1 if z % 4 else 2 for z in range(n)]
    ref = J.launch_divergent_batch(ids, *jseqs, backend=J.ParBackend.XLA)
    seqs = from_jax(jseqs)
    whole = T.launch_divergent_batch(ids, *seqs, device="cpu")
    joined = torch.cat([
        T.launch_divergent_batch(ids[2 * i:2 * i + 2],
                                 *(pmesh._local_pipeline(s, i, NSH, n) for s in seqs),
                                 device="cpu")
        for i in range(NSH)])
    assert torch.equal(joined, whole)
    _close(joined, ref, "against the reference's unsharded output")


def test_ring_view_in_both_plan_builders():
    """A rank's ring view: ``ln`` output planes over the ``N`` ring planes
    in the pointwise kernel's head and in the divergent kernel's group."""
    ring = _u8(_rng(12), (16, 8, 16, 3))
    p = T.build_pipeline(T.circular_batch_read(ring, first=-5),
                         T.convert_to(np.float32, alpha=0.5))
    loc = pmesh._local_pipeline(p, 3, 4)
    plan = kp.build_plan(loc)
    assert plan.base == "circ" and plan.n_planes == 4 and plan.head[5] == 16
    assert tuple(executor.meta_lower(loc.read).shape) == (4, 8, 16, 3)
    dplan = kd.build_plan((loc,), [1] * 4)
    assert dplan.n_planes == 4 and dplan.groups[0].kind == "circ" and dplan.groups[0].n_src == 16
    out = kd.run((loc,), dplan, CPU)
    np.testing.assert_array_equal(out.numpy(), ring[(np.arange(12, 16) - 5) % 16] * 0.5)


def test_used_planes_tensor_is_rebased_without_leaving_its_device():
    frame = _u8(_rng(13), (64, 96, 3))
    rects = np.array([[i, i, 20, 30] for i in range(8)], np.int32)
    used = torch.tensor(5, dtype=torch.int32)
    p = T.build_pipeline(T.resize_batch(frame, rects=rects, dsize=T.Size(8, 16), used_planes=used))
    locs = _ranks(p)
    for i, loc in enumerate(locs):
        assert isinstance(loc.read.used_planes, torch.Tensor)
        assert loc.read.used_planes.dtype == torch.int32
        assert int(loc.read.used_planes) == min(max(5 - i, 0), 1)
    whole = executor.run_pipeline(p, device="cpu")
    assert torch.equal(torch.cat([executor.run_pipeline(loc, device="cpu") for loc in locs]),
                       whole)


def test_refusals_take_the_references_exception_types():
    frame = _u8(_rng(14), (32, 48, 3))
    with pytest.raises(ValueError, match="batched"):
        pmesh._local_pipeline(T.build_pipeline(T.image(frame)), 0, 2)
    crop = T.build_pipeline(T.crop(T.image(np.stack([frame] * 2)), T.Rect(0, 0, 8, 8)))
    with pytest.raises(NotImplementedError, match="CropRead"):
        pmesh._local_pipeline(crop, 0, 2)
    mixed = T.build_pipeline(T.batch_read([T.image(frame), T.crop(T.image(frame),
                                                                   T.Rect(0, 0, 48, 32))]))
    with pytest.raises(NotImplementedError, match="structurally identical"):
        pmesh._local_pipeline(mixed, 0, 2)
    with pytest.raises(ValueError, match="world"):
        pmesh.make_mesh(2, device_type="cpu")  # this process is a world of one


def test_scaling_efficiency_is_the_references():
    for args in ((7200.0, 1000.0, 8), (950.0, 1000.0, 1), (1.0, 3.0, 4)):
        assert pmesh.scaling_efficiency(*args) == jmesh.scaling_efficiency(*args)


def test_two_processes_over_gloo(tmp_path):
    """The entry points in two processes of one gloo group: DTensor
    placements, ``full_tensor()`` equal to the unsharded output, the
    refusals. The store is a file under ``tmp_path``, so that concurrent
    test workers never share a port."""
    import torch_mesh_worker

    world = 2
    ctx = mp.start_processes(torch_mesh_worker.run,
                             args=(world, str(tmp_path / "store"), str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the two gloo processes did not finish in {GLOO_TIMEOUT_S} s")
    want = ["flagship_ragged", "used_planes_tensor", "image_batch_transposed",
            "image_batch_split_write", "warp_batch_ragged", "circular_descending", "divergent",
            "divergent_batchread_refused", "make_mesh_n_refused", "plane_count_must_divide",
            "unbatched_refused"]
    for rank in range(world):
        assert (tmp_path / f"rank{rank}.txt").read_text().split("\n") == want
