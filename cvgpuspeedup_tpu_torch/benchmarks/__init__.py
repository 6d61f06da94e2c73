"""The system's own benchmarks on the card: each case's fused call held
against, and timed beside, the per-op launch pattern it replaces.

Counterparts of the reference's ``benchmarks/`` scripts, run as modules:

    python -m cvgpuspeedup_tpu_torch.benchmarks.vertical_fusion
    python -m cvgpuspeedup_tpu_torch.benchmarks.aux_pipelines
    python -m cvgpuspeedup_tpu_torch.benchmarks.host_overhead
    torchrun --nproc-per-node=N -m cvgpuspeedup_tpu_torch.benchmarks.scaling

Each keeps the reference's case names, shapes, constants and seeds, so a row
of its CSV and a row of the reference's name the same work. Each needs the
card and raises without one; ``scaling --cpu`` runs the sharded path over
gloo on CPU tensors, as the reference's ``--cpu`` does. ``_timing`` holds the
protocol they share.
"""
