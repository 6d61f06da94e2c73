#!/usr/bin/env python
"""The vertical-fusion stress on the card: the MAD-loop family.

Counterpart of the reference's ``benchmarks/vertical_fusion.py``: N fused
multiply/add ops between ONE read and ONE write, swept over image
resolutions, against launching one kernel per op (the per-op pattern), the
2x-10000x speedup axis of the original (its ``README.md:140``).

The fused chain is :func:`fused_chain`, nested static loops of
``multiply(1.0009)`` and ``add(0.0001)``, 200 ops: one launch of the
pointwise kernel (``cuda:pointwise``) per call. The per-op step runs the same
200 ops as 200 torch launches on the card. Rows are ``{edge}x{edge}_{ops}ops``
over :data:`RESOLUTIONS`, on float32 planes made from ``linspace`` as the
reference makes them. The floor is by operations at the unfused float32 rate
(``utils.bounds.OP_PER_S``): the build forbids FMA.

    python -m cvgpuspeedup_tpu_torch.benchmarks.vertical_fusion [--ops 200] [--quick] [--out DIR]

Needs the card. Writes ``vertical_fusion.csv`` and ``vertical_fusion_host.csv``
under ``--out`` (``build/benchmarks`` by default) and prints TFLOP-equiv/s
per row.
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

import cvgpuspeedup_tpu_torch as cvgs

from . import _timing

#: edge sizes of the sweep (the reference sweeps 100 to about 17M elements)
RESOLUTIONS = [128, 512, 1024, 2048, 4096]
MUL, ADD = 1.0009, 0.0001


def fused_chain(f, n_ops: int):
    """The reference's chain, built with the factories of ``f``: nested
    static loops exactly like the original's
    ``StaticLoop<StaticLoop<MAD, k>, N/k>``."""
    mad = f.fuse(f.multiply(MUL), f.add(ADD))
    assert n_ops % 20 == 0, "the chain is loops of 10 multiply-adds"
    return f.static_loop(f.static_loop(mad, 10), n_ops // 2 // 10)


def source(edge: int, divisor: int = 1) -> np.ndarray:
    """The reference's input: ``linspace(0, 1)`` over an (edge, edge) plane
    (at 1/divisor of the edge)."""
    e = edge // divisor
    return np.linspace(0, 1, e * e, dtype=np.float32).reshape(e, e)


def fused_ops(f, img, n_ops: int):
    """The fused pipeline of one plane: the read of (H, W, 1), the chain."""
    return (f.image(img[..., None]), fused_chain(f, n_ops))


def per_op(x: torch.Tensor, n_ops: int) -> torch.Tensor:
    """The per-op pattern: each multiply and add its own launch."""
    for _ in range(n_ops // 2):
        x = x * MUL
        x = x + ADD
    return x


def case(edge: int, n_ops: int, device, divisor: int = 1) -> _timing.Case:
    img = torch.from_numpy(source(edge, divisor)).to(device)
    work = _timing.pipeline_work(cvgs.build_pipeline(*fused_ops(cvgs, img, n_ops)), device)[2]
    return _timing.Case(
        name=f"{edge}x{edge}_{n_ops}ops", kernel="cuda:pointwise",
        fused=lambda: cvgs.execute_operations(*fused_ops(cvgs, img, n_ops), device=device)[..., 0],
        per_op=lambda: per_op(img, n_ops), work=work,
        iters=20, per_op_iters=10 if edge < 4096 else 5)


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=200)
    ap.add_argument("--quick", action="store_true",
                    help="fewer repetitions at the same shapes")
    ap.add_argument("--out", default=None, help="directory of the CSVs")
    args = ap.parse_args(argv)
    runner = _timing.Runner("vertical_fusion", args.out, args.quick)
    for edge in RESOLUTIONS:
        r = runner.run(case(edge, args.ops, runner.device))
        t_fused, t_per_op = r["fused_ms"] * 1e-3, r["per_op_ms"] * 1e-3
        _timing.log(f"{edge:5}x{edge:<5} fused {t_fused * 1e6:9.1f} us | per-op "
                    f"{t_per_op * 1e6:9.1f} us | speedup {t_per_op / t_fused:8.1f}x | "
                    f"{edge * edge * args.ops / t_fused / 1e12:6.2f} TFLOP-equiv/s")
    return runner.finish()


if __name__ == "__main__":
    main()
