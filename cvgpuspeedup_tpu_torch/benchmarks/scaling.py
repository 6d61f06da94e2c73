#!/usr/bin/env python
"""Multi-card scaling of the sharded flagship: images/s at 1..N ranks and
the scaling efficiency.

Counterpart of the reference's ``benchmarks/scaling.py``: each rank runs the
SAME fused pipeline on its slice of the planes (``parallel/mesh.py``'s
``execute_sharded``); the pipeline is a 1080p frame, ``batch_per_device``
crops of 60x120 per rank into 64x128, the flagship chain, planar float32.
For mesh sizes 1, 2, 4, 8 up to the world size it reports images/s and
``scaling_efficiency`` against the first size. A mesh smaller than the
world is a ``DeviceMesh`` over its first ranks; the others wait at the
barriers. Before timing, each rank's output equals the batched crop-resize
kernel's plain version on its planes.

    torchrun --nproc-per-node=N -m cvgpuspeedup_tpu_torch.benchmarks.scaling
    torchrun --nproc-per-node=N -m cvgpuspeedup_tpu_torch.benchmarks.scaling --cpu

One process per card over NCCL; ``--cpu`` runs the same path over gloo on
CPU tensors (the reference's ``--cpu``), and reports the efficiency against
the core-bound ceiling too: CPU processes share the host's cores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

import cvgpuspeedup_tpu_torch as cvgs

from ..exec import cuda_batch_resize as kbr
from ..parallel import mesh as pmesh
from . import _timing


def inputs(divisor: int = 1) -> np.ndarray:
    """The reference's 1080p frame (seed 0), at 1/divisor of its edges."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (1080 // divisor, 1920 // divisor, 3)).astype(np.uint8)


def rects_for(batch: int) -> np.ndarray:
    return np.array([[i % 800, i % 800, 60, 120] for i in range(batch)], np.int32)


def ops(f, frame, rects):
    """The pipeline, built with the factories of ``f``."""
    return (f.resize_batch(frame, rects=rects, dsize=f.Size(64, 128)),
            f.convert_to(np.float32, alpha=0.3), f.subtract((3.2, 0.6, 11.8)),
            f.divide((128.0,) * 3), f.split_tensor())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(batch_per_device: int = 16, iters: int = 30, device_type: str = "cuda",
        mesh: Optional[DeviceMesh] = None, divisor: int = 1) -> List[Dict]:
    """The sweep in the current process group (``mesh``: the batch mesh over
    all of it, made where not given); every rank calls it. Returns one row
    per mesh size, on every rank."""
    world, rank = dist.get_world_size(), dist.get_rank()
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    frame = torch.from_numpy(inputs(divisor)).to(device)
    sizes = [s for s in (1, 2, 4, 8) if s <= world]
    rows, rates = [], {}
    for nsh in sizes:
        if nsh == world:
            m = mesh if mesh is not None else pmesh.make_mesh(device_type=device_type)
        else:
            m = DeviceMesh(device_type, list(range(nsh)), mesh_dim_names=("batch",))
        member = rank < nsh
        batch = batch_per_device * nsh
        rects = rects_for(batch)
        err = 0.0
        if member:
            launches = kbr.LAUNCHES
            out = pmesh.execute_sharded(*ops(cvgs, frame, rects), mesh=m).to_local()
            if device_type == "cuda" and (cvgs.last_backend() != "cuda:batch_resize"
                                          or kbr.LAUNCHES != launches + 1):
                raise AssertionError(f"scaling over {nsh}: {cvgs.last_backend()} in "
                                     f"{kbr.LAUNCHES - launches} launches")
            local = pmesh._local_pipeline(cvgs.build_pipeline(*ops(cvgs, frame, rects)), rank,
                                          nsh)
            plain = kbr.batch_resize_reference(kbr.prepare(local, kbr.build_plan(local), device))
            err = _timing.max_diff(out, plain, f"scaling over {nsh} ranks, rank {rank}")
            if err != 0.0:
                raise AssertionError(f"scaling over {nsh}: max|diff| {err} against the plain "
                                     "version")
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        if member:
            for _ in range(iters):
                pmesh.execute_sharded(*ops(cvgs, frame, rects), mesh=m)
            _sync(device)
        dist.barrier()
        dt = (time.perf_counter() - t0) / iters
        rates[nsh] = batch / dt
        eff = pmesh.scaling_efficiency(rates[nsh], rates[sizes[0]], nsh)
        row = {"case": f"shards_{nsh}", "kernel": "cuda:batch_resize" if device_type == "cuda"
               else "torch", "ranks": nsh, "batch": batch, "images_per_s": rates[nsh],
               "ms_per_call": dt * 1e3, "scaling_efficiency": eff, "max_abs_diff": err}
        line = f"shards={nsh}: {rates[nsh]:.0f} images/s (efficiency {eff * 100:.0f}%)"
        if device_type == "cpu":
            # CPU processes share the host's cores: the attainable ceiling is
            # min(shards, cores), not shards; report against it too, so that a
            # small host does not read as a fault of the sharded path
            cores = os.cpu_count() or 1
            ceiling = min(nsh, cores)
            row["core_bound_efficiency"] = pmesh.scaling_efficiency(rates[nsh], rates[sizes[0]],
                                                                    ceiling)
            line += (f" [host has {cores} cores: {row['core_bound_efficiency'] * 100:.0f}% of the "
                     "core-bound ceiling]")
        if rank == 0:
            _timing.log(line)
        rows.append(row)
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo on CPU tensors")
    ap.add_argument("--batch-per-device", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--quick", action="store_true", help="fewer repetitions")
    ap.add_argument("--init-method", default=None,
                    help="the process group's init_method (default: torchrun's environment)")
    args = ap.parse_args(argv)
    device_type = "cpu" if args.cpu else "cuda"
    if not args.cpu:
        _timing.require_card()
    own = not dist.is_initialized()
    mesh = pmesh.initialize_distributed(args.init_method, device_type=device_type) if own else None
    try:
        card = "cpu" if args.cpu else _timing.card_name_and_limit()
        if dist.get_rank() == 0:
            _timing.log(f"scaling: world {dist.get_world_size()} x {device_type}; {card}")
        rows = run(args.batch_per_device, 5 if args.quick else args.iters, device_type, mesh)
        if dist.get_rank() == 0:
            print(json.dumps({"benchmark": "scaling", "card": card, "rows": rows}))
            sys.stdout.flush()
        return rows
    finally:
        if own:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
