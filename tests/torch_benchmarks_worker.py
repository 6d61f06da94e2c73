"""One rank of ``test_torch_benchmarks.py::test_scaling_cpu_over_gloo_two_processes``.

Imports torch and the port only, so that a spawned process starts quickly.
It runs ``scaling --cpu`` in a gloo group of ``world`` processes joined
through a ``file://`` store, at 1/8 of the frame's edges and 4 crops per
rank, and writes its rows to ``<out_dir>/rank<r>.txt``.
"""

import os

import torch.distributed as dist


def run(rank, world, store, out_dir):
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    from cvgpuspeedup_tpu_torch.benchmarks import scaling
    from cvgpuspeedup_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.initialize_distributed(f"file://{store}", world, rank, device_type="cpu")
    try:
        rows = scaling.run(batch_per_device=4, iters=2, device_type="cpu", mesh=mesh, divisor=8)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write(repr(rows))
