#!/usr/bin/env python
"""The host's cost of the lazy graph build and the executor's dispatch, on
the card.

Counterpart of the reference's ``benchmarks/host_overhead.py``: building the
op graph, flattening it and hitting the plan cache must cost microseconds per
call; new frames, rects or scalars never rebuild anything. The reference's
shapes: a 296x384x3 uint8 frame (on the card) and 16 rects of 60x120, the
flagship chain into 64x128 planar float32, one launch of the batched
crop-resize kernel (``cuda:batch_resize``) per call. Measured:

- graph build alone (``build_pipeline``), us per call;
- build plus dispatch on a plan hit, with no sync (the rects shift between
  calls), us per call: under 5000, as the reference asserts;
- one call taken apart into its host layers, in its own order: build,
  ``graph.flatten`` and the plan lookup, ``prepare``, the launch, the sync
  (:func:`host_layers`, which ``chip_smoke.py`` phase 5 runs on the flagship).

Before any timing, one call's output must equal the kernel's plain version
bit for bit.

    python -m cvgpuspeedup_tpu_torch.benchmarks.host_overhead [--quick]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List

import numpy as np
import torch

import cvgpuspeedup_tpu_torch as cvgs

from ..exec import cuda_batch_resize as kbr
from ..exec import executor
from ..graph import flatten
from . import _timing

#: the reference's bound on build plus dispatch, us per call
LIMIT_US = 5000


def inputs(divisor: int = 1):
    """The reference's frame (seed 0) and 16 rects, at 1/divisor of their
    edges."""
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (296 // divisor, 384 // divisor, 3)).astype(np.uint8)
    w, h = max(1, 60 // divisor), max(1, 120 // divisor)
    return frame, np.array([[i, i, w, h] for i in range(16)], np.int32)


def ops(f, frame, rects):
    """The pipeline, built with the factories of ``f``."""
    return (f.resize_batch(frame, rects=rects, dsize=f.Size(64, 128)),
            f.convert_to(np.float32, alpha=0.3), f.subtract((3.2, 0.6, 11.8)),
            f.divide((128.0,) * 3), f.split_tensor())


def host_layers(make_ops: Callable[[], tuple], device, rounds: int = 110) -> Dict[str, List[float]]:
    """Seconds per call of one ``execute_operations`` call ("whole"), then of
    the same call taken apart into its host layers in its own order, both in
    each of ``rounds`` rounds: ``build_pipeline``, ``flatten`` and the plan
    lookup (``flatten+plan``), the kernel's ``prepare``, the launch, the
    ``synchronize()``. The first 10 rounds are left out."""
    parts = {"whole": [], "build_pipeline": [], "flatten+plan": [], "prepare": [], "launch": [],
             "sync": []}
    for _ in range(rounds):
        t0 = time.perf_counter()
        cvgs.execute_operations(*make_ops(), device=device)
        torch.cuda.synchronize()
        parts["whole"].append(time.perf_counter() - t0)
        t = [time.perf_counter()]
        p = cvgs.build_pipeline(*make_ops())
        t.append(time.perf_counter())
        key, leaves = flatten(p)
        d = executor._resolve_device(leaves, device)
        plan = executor._plan(p, key, cvgs.ParBackend.AUTO, d)
        t.append(time.perf_counter())
        a = plan.module.prepare(p, plan.kernel, d)
        t.append(time.perf_counter())
        plan.module.launch(a)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, t0, t1 in zip(list(parts)[1:], t, t[1:]):
            parts[k].append(t1 - t0)
    return {k: v[10:] for k, v in parts.items()}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="fewer repetitions")
    args = ap.parse_args(argv)
    dev = _timing.require_card()
    card = _timing.card_name_and_limit()
    host_frame, rects = inputs()
    frame = torch.from_numpy(host_frame).to(dev)

    def call(shift):
        return cvgs.execute_operations(*ops(cvgs, frame, rects + shift), device=dev)

    call(0)  # the plan, once
    launches = kbr.LAUNCHES
    out = call(1)
    backend, launches = cvgs.last_backend(), kbr.LAUNCHES - launches
    p = cvgs.build_pipeline(*ops(cvgs, frame, rects + 1))
    plain = kbr.batch_resize_reference(kbr.prepare(p, kbr.build_plan(p), dev))
    err = _timing.max_diff(out, plain, "host_overhead vs the plain version")
    if backend != "cuda:batch_resize" or launches != 1 or err != 0.0:
        raise AssertionError(f"host_overhead: {backend} in {launches} launches, max|diff| {err}")

    n = 50 if args.quick else 200
    t0 = time.perf_counter()
    for i in range(n):
        out = call(i % 3)
    dispatch_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        cvgs.build_pipeline(*ops(cvgs, frame, rects))
    graph_us = (time.perf_counter() - t0) / n * 1e6
    layers = host_layers(lambda: ops(cvgs, frame, rects), dev, rounds=30 if args.quick else 110)
    layer_us = {k: float(np.median(v)) * 1e6 for k, v in layers.items()}

    _timing.log(f"host_overhead: {card}")
    _timing.log(f"graph build only: {graph_us:.1f} us/call")
    _timing.log(f"build + dispatch (cache hit): {dispatch_us:.1f} us/call")
    _timing.log("host layers, us/call, median of " f"{len(layers['whole'])}: "
                + ", ".join(f"{k} {v:.2f}" for k, v in layer_us.items()))
    _timing.log(f"output vs the plain version of {backend}: max|diff| {err!r}, {launches} launch")
    assert dispatch_us < LIMIT_US, "host overhead must stay in the microsecond regime"
    result = {"case": "host_overhead_flagship_296x384_16_rects", "kernel": backend,
              "launches": launches, "max_abs_diff": err, "graph_build_us": graph_us,
              "build_dispatch_us": dispatch_us, "layers_us": layer_us}
    print(json.dumps({"benchmark": "host_overhead", "card": card, "rows": [result]}))
    return result


if __name__ == "__main__":
    main()
