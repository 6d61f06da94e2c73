"""One rank of ``test_torch_mesh.py::test_two_processes_over_gloo``.

Imports torch and the port only, so that a spawned process starts quickly.
Every case runs in the one process group: the sharded entry points return
DTensors on the write layout's plane axis, ``full_tensor()`` gathers the
unsharded output bit for bit, and the refusals raise the reference's
exception types. The rank writes the names of the cases it passed to
``<out_dir>/rank<r>.txt``.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.parallel import mesh as pmesh


def _inputs():
    rng = np.random.default_rng(11)
    return {
        "frame": rng.integers(0, 256, (96, 128, 3)).astype(np.uint8),
        "rects": np.array([[3 * i, 2 * i, 40, 60] for i in range(8)], np.int32),
        "batch": rng.integers(0, 256, (8, 12, 16, 3)).astype(np.uint8),
        "ring": rng.integers(0, 256, (8, 12, 16, 3)).astype(np.uint8),
        "flat": rng.integers(0, 200, (8, 32, 16, 3)).astype(np.float32),
        "tall_ring": rng.integers(0, 256, (8, 32, 16, 3)).astype(np.uint8),
    }


def _cases(x):
    """name -> (ops, expected plane axis of each output)."""
    rot = [np.array([[1.0, 0.0, float(i)], [0.0, 1.0, i / 2]], np.float32) for i in range(8)]
    return {
        "flagship_ragged": ((T.resize_batch(x["frame"], rects=x["rects"], dsize=T.Size(16, 32),
                                            used_planes=5, background=7.0),
                             T.convert_to(np.float32, alpha=0.3), T.split_tensor()), 0),
        "used_planes_tensor": ((T.resize_batch(x["frame"], rects=x["rects"],
                                               dsize=T.Size(16, 32),
                                               used_planes=torch.tensor(3, dtype=torch.int32)),
                                T.split_tensor()), 0),
        "image_batch_transposed": ((T.image(x["batch"]), T.split_tensor_transposed()), 1),
        "image_batch_split_write": ((T.image(x["batch"]), T.multiply(2.0), T.split()), 0),
        "warp_batch_ragged": ((T.warp_batch([x["frame"]] * 8, rot, T.Size(16, 8), used_planes=5,
                                            default=7.0),), 0),
        "circular_descending": ((T.circular_batch_read(x["ring"], first=3, ascendent=False),
                                 T.convert_to(np.float32, alpha=1.0)), 0),
    }


def _divergent(x):
    seq = T.build_operation_sequence
    return [1 + (z % 3) for z in range(8)], (
        seq(T.resize_batch(x["frame"], rects=x["rects"], dsize=T.Size(16, 32)),
            T.convert_to(np.float32, alpha=0.5), T.write_tensor()),
        seq(T.image(x["flat"]), T.multiply(2.0), T.write_tensor()),
        seq(T.circular_batch_read(x["tall_ring"], first=5), T.convert_to(np.float32, alpha=0.25),
            T.write_tensor()))


def _check(out, want, dim, world):
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    assert len(outs) == len(wants)
    for o, w in zip(outs, wants):
        assert tuple(o.placements) == (Shard(dim),), o.placements
        assert tuple(o.shape) == tuple(w.shape), (o.shape, w.shape)
        assert o.to_local().shape[dim] * world == w.shape[dim]
        assert torch.equal(o.full_tensor(), w)


def run(rank: int, world: int, store: str, out_dir: str) -> None:
    mesh = pmesh.initialize_distributed(f"file://{store}", world, rank, device_type="cpu")
    passed = []
    x = _inputs()
    for name, (ops, dim) in _cases(x).items():
        out = pmesh.execute_sharded(*ops, mesh=mesh)
        _check(out, T.execute_operations(*ops, device="cpu"), dim, world)
        passed.append(name)
    ids, seqs = _divergent(x)
    out = pmesh.execute_divergent_sharded(ids, *seqs, mesh=mesh)
    _check(out, T.launch_divergent_batch(ids, *seqs, device="cpu"), 0, world)
    passed.append("divergent")

    warps = T.build_operation_sequence(
        T.warp_batch([x["frame"]] * 8, [np.eye(2, 3)] * 8, T.Size(16, 32)), T.write_tensor())
    for what, call, exc in (
            ("divergent_batchread_refused",
             lambda: pmesh.execute_divergent_sharded([1, 2] * 4, seqs[0], warps, mesh=mesh),
             NotImplementedError),
            ("make_mesh_n_refused",
             lambda: pmesh.make_mesh(world + 1, device_type="cpu"), ValueError),
            ("plane_count_must_divide",
             lambda: pmesh.execute_sharded(T.image(x["batch"][:world + 1]), mesh=mesh),
             ValueError),
            ("unbatched_refused",
             lambda: pmesh.execute_sharded(T.image(x["frame"]), mesh=mesh), ValueError)):
        try:
            call()
        except exc:
            passed.append(what)
        else:
            raise AssertionError(f"{what}: no {exc.__name__}")
    assert pmesh.make_mesh(world, device_type="cpu").size() == world
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write("\n".join(passed))
