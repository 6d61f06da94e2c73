#!/usr/bin/env python3
"""Whether gloo gathers CUDA tensors: two processes on one card, one gloo group.

    python3 tools/gloo_cuda_gather.py

Spawns two processes that both take the first CUDA device, join one gloo
process group through a file store in a temporary directory, run
``execute_sharded`` on a batched image pipeline over a CUDA ``DeviceMesh``
and gather it with ``DTensor.full_tensor()``. Prints each rank's steps and
how each process ended: exit code 0 when both gathered the unsharded output,
1 otherwise (a process that dies of a signal included). ``chip_smoke.py``
runs two ranks on one card only where this passes. Needs a card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(rank: int, world: int, store: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import cvgpuspeedup_tpu_torch as T
    from cvgpuspeedup_tpu_torch.parallel import mesh as pmesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    mesh = pmesh.make_mesh(device_type="cuda")
    batch = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 16, 32, 3))
                             .astype(np.uint8)).cuda()
    ops = (T.image(batch), T.split_tensor_transposed())
    out = pmesh.execute_sharded(*ops, mesh=mesh)
    print(f"rank {rank}: execute_sharded {out.placements} on {out.to_local().device}", flush=True)
    try:
        full = out.full_tensor()
    except Exception:
        print(f"rank {rank}: full_tensor raised\n{traceback.format_exc()}", flush=True)
        raise
    same = bool(torch.equal(full, T.execute_operations(*ops)))
    print(f"rank {rank}: full_tensor() equal to the unsharded call: {same}", flush=True)
    dist.destroy_process_group()
    if not same:
        raise AssertionError("the gathered tensor differs from the unsharded call")


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("gloo_cuda_gather: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(rank_main, args=(2, os.path.join(tmp, "store")), nprocs=2,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=300):
                pass
        except Exception as e:  # a rank raised or died: report how, and fail
            print(f"gloo gather of CUDA tensors failed: {type(e).__name__}: {e}", flush=True)
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            return 1
    print("gloo gathers CUDA tensors: both ranks equal the unsharded call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
