#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against each other on one card.

    python3 tools/kernel_variants.py variants.json [rounds [cases]]

``variants.json`` maps a variant's name to a list of text substitutions
applied to the files of ``cvgpuspeedup_tpu_torch/csrc``: ``[old, new]`` in
every file that holds ``old``, ``[file, old, new]`` in that file alone; an
empty list is the tree as it stands. A string instead of a list names
another directory of sources, relative to the repo's root (an older commit's
``csrc`` unpacked with ``git archive``), whose C interface must equal the
present one (``_build.load`` declares the present signatures): since K1,
K2 and the warp kernel took ``out_type`` and ``clamp_store`` in place of
``out_u8``, a tree from before that is refused. For example::

    {"base": [],
     "parent": "build/parent/cvgpuspeedup_tpu_torch/csrc",
     "k1_256_threads": [["constexpr int kThreads = 128;\\nconstexpr int kPix",
                         "constexpr int kThreads = 256;\\nconstexpr int kPix"]],
     "warp_per_byte": [["if constexpr (sizeof(SrcT) == 1) {", "if constexpr (false) {"]]}

Each variant's sources are written to a directory of their own and built
into a library of their own (``_build.load(csrc_dir, build_dir)``). Then, in
``rounds`` rounds (6 unless given) over all variants in turn, these launches
are timed by CUDA events (median of 50) and by ``torch.profiler`` (median
kernel duration of 20 launches), in microseconds:

- the flagship crop-resize of ``chip_smoke.py`` (``k1``);
- its timed warp cases W1, W2, W5 and W6, and its warp batch cut to 2, 3, 4
  and 6 planes of 640x360 (``wb2`` .. ``wb6``), which lie between one warp
  and the batch of eight in output count;
- its frame paths (a) and (b) (``k2a``, ``k2b``), path (a)'s frame into
  784x441, 960x540 and 1280x720 and path (b)'s buffer into 960x540
  (``k2a_441p``, ``k2a_540p``, ``k2a_720p``, ``k2b_540p``: output counts
  between the two paths);
- its divergent rows D1-D4 (``d1`` .. ``d4``), D1 over 8 and 12 planes of its
  ring (``d1_8``, ``d1_12``) and over a float32 copy of it (``d1_f32``), and
  D4 over 40 and 48 planes (``d4_40``, ``d4_48``);
- its pointwise rows P1-P5 (``p1`` .. ``p5``: the 200-op chain, the ring, the
  border, the crop, NV12 -> RGBA) and P1's chain on 768x768, 1024x1024 and
  1448x1448 (``p1_768``, ``p1_1024``, ``p1_1448``: output counts around the
  one-lane instances' thresholds), left out for a variant whose sources have
  no pointwise kernel (an older tree's).

``cases``, a comma-separated list, times only those. The cases are
``chip_smoke.py``'s own functions, so the two cannot drift. Each line gives
every round's pair, then the median and the spread (min .. max) of the
profiler's readings (a trace that came back empty three times reads nan and
is left out of them). Before any timing every variant's output in every case
must equal the first variant's bit for bit. ``ptxas`` lines that report a
spill are printed per variant, and each variant's registers per kernel
instance where they differ from the first variant's. Needs one CUDA card and
``nvcc``; comparing variants only makes
sense within one run.
"""

from __future__ import annotations

import json
import re
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if len(sys.argv) not in (2, 3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import cvgpuspeedup_tpu_torch as cvgs
    from cvgpuspeedup_tpu_torch.exec import _build
    from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
    from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
    from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
    from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
    from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
    from cvgpuspeedup_tpu_torch.graph import map_leaves
    from cvgpuspeedup_tpu_torch.utils.dtypes import as_device_tensor
    from cvgpuspeedup_tpu_torch.utils.profiling import time_cuda

    variants = json.loads(Path(sys.argv[1]).read_text())
    rounds = int(sys.argv[2]) if len(sys.argv) >= 3 else 6
    only = set(sys.argv[3].split(",")) if len(sys.argv) == 4 else None
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(42)
    frame = torch.from_numpy(rng.integers(0, 256, (cs.SRC_H, cs.SRC_W, 3), dtype=np.uint8)).to(dev)
    hd = torch.from_numpy(rng.integers(0, 256, (cs.FRAME_H, cs.FRAME_W, 3), dtype=np.uint8)).to(dev)
    rects = np.array([[i, i, 60, 120] for i in range(cs.BATCH)], np.int32)
    shared = cvgs.image(hd)
    timed = cs.timed_warp_cases(cvgs, shared)
    cases = {"k1": (kbr, kbr.batch_resize, cs.flagship_ops(cvgs, frame, rects))}
    for short, name in (("w1", "w1_k3_separable"), ("w2", "w2_k4_rotation"),
                        ("w5", "w5_k5a_perspective_640x384"), ("w6", "w6_k5b_batch8_ragged7")):
        cases[short] = (kw, kw.warp, timed[name])
    for planes in (2, 3, 4, 6):
        cases[f"wb{planes}"] = (kw, kw.warp,
                                cs.warp_batch_ops(cvgs, shared, -10.0, planes, planes=planes))
    nv12 = torch.from_numpy(
        rng.integers(0, 256, (cs.NV12_H * 3 // 2, cs.NV12_W), dtype=np.uint8)).to(dev)
    cases["k2a"] = (kfr, kfr.frame_resize, cs.frame_a_ops(cvgs, hd))
    cases["k2a_441p"] = (kfr, kfr.frame_resize, cs.frame_a_ops(cvgs, hd, (784, 441)))
    cases["k2a_540p"] = (kfr, kfr.frame_resize, cs.frame_a_ops(cvgs, hd, (960, 540)))
    cases["k2a_720p"] = (kfr, kfr.frame_resize, cs.frame_a_ops(cvgs, hd, (1280, 720)))
    cases["k2b"] = (kfr, kfr.frame_resize, cs.frame_b_ops(cvgs, nv12))
    cases["k2b_540p"] = (kfr, kfr.frame_resize, cs.frame_b_ops(cvgs, nv12, (960, 540)))
    rows = cs.DivergentRows(cvgs, dev, frame)
    batches = {f"d{k}": v for k, v in enumerate(rows.timed().values(), 1)}
    batches["d1_8"] = rows.d1(3, rows.ring[:8])
    batches["d1_12"] = rows.d1(3, rows.ring[:12])
    batches["d1_f32"] = rows.d1(3, rows.ring.float())
    batches["d4_40"] = rows.d4(repeat=5)
    batches["d4_48"] = rows.d4(repeat=6)
    mad_src = torch.from_numpy(
        rng.random((cs.MAD_SIDE, cs.MAD_SIDE, 1), dtype=np.float32) * 255).to(dev)
    nv12_hd = torch.from_numpy(
        rng.integers(0, 256, (cs.FRAME_H * 3 // 2, cs.FRAME_W), dtype=np.uint8)).to(dev)
    pointwise = cs.pointwise_rows(cvgs, mad_src, rows.ring, 3, hd, (-300, -200), nv12_hd)
    for k, ops in enumerate(pointwise.values(), 1):
        cases[f"p{k}"] = (kp, kp.pointwise, ops)
    for side in (768, 1024, 1448):  # output counts around the one-lane thresholds
        cases[f"p1_{side}"] = (kp, kp.pointwise, (cvgs.image(mad_src[:side, :side].contiguous()),
                                                   cs.mad_chain(cvgs), cvgs.write()))
    pointwise_cases = {name for name in cases if name.startswith("p")}
    launches = {}
    for name, (module, wrapper, ops) in cases.items():
        pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: as_device_tensor(v, dev))
        args = module.prepare(pipe, module.build_plan(pipe), dev)
        launches[name] = (lambda wrapper=wrapper, args=args: wrapper(args))
    for name, (ids, seqs) in batches.items():
        seqs = map_leaves(seqs, lambda v: as_device_tensor(v, dev))
        args = kd.prepare(seqs, kd.build_plan(seqs, ids), dev)
        launches[name] = (lambda args=args: kd.divergent(args))
    if only is not None:
        if only - set(launches):
            print(f"no case named {sorted(only - set(launches))}", file=sys.stderr)
            return 1
        launches = {name: fn for name, fn in launches.items() if name in only}

    def runs(cname) -> bool:
        """Whether the library in use has the case's kernel."""
        return cname not in pointwise_cases or hasattr(_build.load(), "cvgs_pointwise")

    def profiler_us(fn, calls=20):
        for _ in range(3):
            fn()
        for _ in range(3):  # a trace now and then comes back empty: take it again
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            if us:
                return float(np.median(us))
        return float("nan")

    csrc = ROOT / "cvgpuspeedup_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory(prefix="kernel_variants_") as tmp:
        dirs = {}
        first_regs = None
        for vname, subs in variants.items():
            d = Path(tmp) / vname
            d.mkdir()
            from_dir = csrc
            if isinstance(subs, str):
                from_dir, subs = ROOT / subs, []
                old_abi = [f for f in ("batch_resize.cu", "frame_resize.cu", "warp.cu")
                           if "int out_type" not in (from_dir / f).read_text()]
                if old_abi:
                    print(f"{vname}: {', '.join(old_abi)} take out_u8, not out_type and "
                          "clamp_store: another C interface than the present one", file=sys.stderr)
                    return 1
            subs = [sub if len(sub) == 3 else [None, *sub] for sub in subs]
            unused = {old for _, old, _ in subs}
            for f in sorted(from_dir.iterdir()):
                text = f.read_text()
                for only_in, old, new in subs:
                    if old in text and only_in in (None, f.name):
                        unused.discard(old)
                        text = text.replace(old, new)
                (d / f.name).write_text(text)
            if unused:
                print(f"{vname}: no source holds {sorted(unused)}", file=sys.stderr)
                return 1
            dirs[vname] = d
            _build.load(d, d / "out")
            entry = ""
            regs = {}
            for line in _build.BUILD_LOG.splitlines():
                if "Compiling entry" in line:
                    found = re.search(r"\d\d([a-z_]+_kernel)I(\w+?)EEv", line.split("'")[1])
                    entry = f"{found.group(1)}<{found.group(2)}>" if found else line.split("'")[1]
                if "spill" in line and "0 bytes spill stores" not in line:
                    print(f"{vname}: {entry}: {line.strip()}")
                if "Used" in line and "registers" in line:
                    regs[entry] = int(line.split("Used")[1].split()[0])
            first_regs = first_regs or regs
            changed = {k: v for k, v in regs.items() if first_regs.get(k) != v}
            print(f"{vname}: registers " + (", ".join(f"{k} {v}" for k, v in (
                regs if regs is first_regs else changed).items()) or "as the first variant's"))

        # a variant may change the speed of a kernel, never a bit of its output
        outputs: dict = {}
        for vname, d in dirs.items():
            _build.load(d, d / "out")
            for cname, fn in launches.items():
                if not runs(cname):
                    continue
                got = fn()
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                want = outputs.setdefault(cname, got)
                if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
                    print(f"{vname}: {cname} differs from {next(iter(dirs))}'s output",
                          file=sys.stderr)
                    return 1
        del outputs

        results: dict = {}
        for _ in range(rounds):
            for vname, d in dirs.items():
                _build.load(d, d / "out")  # built above: this makes it the library in use
                for cname, fn in launches.items():
                    if not runs(cname):
                        continue
                    events = float(np.median(time_cuda(fn, iters=50))) * 1e3
                    results.setdefault((cname, vname), []).append((events, profiler_us(fn)))
    card = cs.gpu_name_and_limit()
    for (cname, vname), got in sorted(results.items()):
        prof = [p for _, p in got]
        print(f"{cname:8s} {vname:20s} "
              + " ".join(f"{e:.2f}/{p:.2f}" for e, p in got)
              + f"  events/profiler us; profiler median {np.nanmedian(prof):.2f} "
              f"({np.nanmin(prof):.2f} .. {np.nanmax(prof):.2f}); {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
