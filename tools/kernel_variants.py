#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against each other on one card.

    python3 tools/kernel_variants.py variants.json [rounds [cases]] [--sass]
        [--variants=a,b,...]

``variants.json`` maps a variant's name to a list of text substitutions
applied to the files of ``cvgpuspeedup_tpu_torch/csrc``: ``[old, new]`` in
every file that holds ``old``, ``[file, old, new]`` in that file alone; an
empty list is the tree as it stands. An object ``{"csrc": ..., "subs":
[...], "drop_flags": [...]}`` gives a directory, substitutions and compile
flags left out of ``exec/_build.py``'s command for that variant alone (for
example ``["-ftz=true"]``, the build before float32 subnormals were
flushed). ``"probe": true`` in such an object marks a variant that
changes outputs on purpose (a part of a kernel switched off at run time, to
see what that part costs): it is timed, its outputs are not compared, and
it is never a candidate to keep. With ``--sass`` each variant's float32
rule is read from its SASS (``tools/kernel_sass.py::ftz_census``).
``--variants=a,b,...`` builds and times those variants of the file alone, in
the file's order. A string instead of a list names
another directory of sources, relative to the repo's root (an older commit's
``csrc`` unpacked with ``git archive``), whose C interface must equal the
present one (``_build.load`` declares the present signatures): since K1,
K2 and the warp kernel took ``out_type`` and ``clamp_store`` in place of
``out_u8``, a tree from before that is refused. ``store_op`` (the row a
kernel runs before its store, 0 for none) has since taken the place of
``clamp_store`` (1: clamp) at the same position; the cases of this tool
pass 0, which both read alike. A tree whose K1, K2 and warp
kernel take ``src_u8`` and whose divergent kernel takes ``out_u8`` (before
they took a source and an output type code) is called through
:class:`SourceFlagAbi`, which turns the type codes of a uint8 or float32
source and output back into those flags; it runs the uint8 and float32
cases of this tool, which are all of them. A tree whose divergent kernel
takes no ``any_src`` (before its general instance) is called through
:class:`AnySrcAbi`, which drops it: it runs the divergent cases of uint8,
float32 and float64 groups, which are all of them. For example::

    {"base": [],
     "parent": "build/parent/cvgpuspeedup_tpu_torch/csrc",
     "k1_256_threads": [["constexpr int kThreads = 128;\\nconstexpr int kPix",
                         "constexpr int kThreads = 256;\\nconstexpr int kPix"]],
     "warp_per_byte": [["if constexpr (sizeof(SrcT) == 1) {", "if constexpr (false) {"]]}

Each variant's sources are written to a directory of their own and built
into a library of their own (``build_variant``, which ``_build.load(csrc_dir,
build_dir)`` then loads: the objects of all variants kept in one directory
under a hash of each source, its headers and the command, so that a variant
compiles only the sources it changes). Then, in
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
  no pointwise kernel (an older tree's);
- the flagship, W6 and D1 on their frame or ring in other source dtypes,
  the same values (``k1_f32``, ``k1_i32``, ``k1_i64``, ``k1_f64``, ``w6_*``
  and ``d1_f64`` alike), and P1-P4 on int64 and float64 twins of their
  sources (``p1_i64`` .. ``p4_f64``): what each source type's read costs;
  ``p4_edges_f64``, P4's crop of a float64 frame of ``chip_smoke.py``'s
  ``EDGES64`` (a copy that keeps float32's subnormals).
  The int64 and float64 ones are left out for a variant whose sources do
  not read them (no ``source_int64.cu``);
- its composed-read cases C1-C8 (``c1`` .. ``c8``), C1 on float32 and
  float64 twins of its 4K frame (``c1_f32``, ``c1_f64``) and C4 into a
  width of 1917, no multiple of 4 (``c4_ragged``), left out for a variant
  whose sources have no composed kernel;
- its composed kernel's batches B1-B7 (``b1`` .. ``b7``: ``batch_read`` of
  eight 1080p cameras' read trees, and of 50 crops of the 4K frame), left
  out for a variant whose composed kernel takes no batch of resamples (no
  ``plane_stride`` in its ``composed.cuh``);
- its composed kernel's nested cases N1-N6 (``n1`` .. ``n6``: a second
  resampling node, or a fused read above the core) and the two at the ends
  of their staging (``n7``, a warp at a quarter scale whose blocks
  evaluate per tap, and ``n8``, an upscale whose blocks share their taps:
  ``budget_nested_cases``), left out for a variant without the nested
  instances (no ``cvgs_composed_nested``);
- its composed kernel's mixed-geometry batches M1-M5 (``m1`` .. ``m5``:
  ``chip_smoke.py``'s ``mixed_cases``, planes of one shape and each its
  own sizes), left out for a variant without the mixed-geometry instances
  (no ``composed_kernel_mixed`` in its ``composed.cuh``);
- its composed kernel's batches of nested planes of their own geometry
  NM1-NM4 (``nm1`` .. ``nm4``: ``chip_smoke.py``'s ``nested_mixed_cases``),
  left out for a variant without the mixed nested instances (no
  ``composed_kernel_nested_mixed`` in its ``composed_nested.cuh``);
- its composed kernel's divergent batches DV1-DV4 (``dv1`` .. ``dv4``:
  ``divergent_composed_cases``), left out for a variant without them (no
  ``CM_DIVERGENT`` in its ``composed.cuh``), and those with a nested group
  DVN1-DVN4 (``dvn1`` .. ``dvn4``: ``divergent_nested_cases``), left out
  for a variant without the general nested instances (no
  ``composed_nested_divergent.cu``): each one launch through its divergent
  plan, which the tree's own host code builds;
- the split kernel's batches DK1-DK4 (``dk1`` .. ``dk4``: ``split_cases``),
  left out for a variant without ``divergent_split.cu``
  (``tools/kernel_variants_split.json`` times its variants).

``cases``, a comma-separated list, times only those; where it is not given,
a file's ``"cases"`` entry (a string, not a variant) names them. The cases are
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

import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


class SourceFlagAbi:
    """A library of the older C interface, called with the present one's
    arguments: K1's, K2's and the warp kernel's source type code (argument 2)
    becomes ``src_u8``, the divergent kernel's output type code (argument 10)
    ``out_u8``, and the store row becomes ``clamp_store``: 1 for a float's
    truncate into uint8 (the clamp store), else 0. Only uint8 and float32
    sources and outputs have such a flag."""

    U8, F32 = 0, 4  # cuda_batch_resize.TYPE_CODES
    TRUNC_U8 = 23  # cuda_batch_resize.OP_TRUNC_U8
    CLAMP = {"cvgs_batch_resize": 18, "cvgs_frame_resize": 26, "cvgs_warp": 19}

    def __init__(self, lib):
        self.lib = lib

    def _flag(self, code):
        if code not in (self.U8, self.F32):
            raise ValueError(f"type code {code}: the older interface takes uint8 or float32")
        return int(code == self.U8)

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name in self.CLAMP:
            def call(*args):
                args = list(args)
                args[1] = self._flag(args[1])
                args[self.CLAMP[name]] = int(args[self.CLAMP[name]] == self.TRUNC_U8)
                return fn(*args)
            return call
        if name == "cvgs_divergent":
            def call(*args):
                args = list(args)
                args[9] = self._flag(args[9])
                return fn(*args)
            return call
        return fn


class AnySrcAbi:
    """A library whose divergent kernel has no general instance and takes
    no ``any_src`` (the argument before the stream), called with the present
    arguments: ``any_src`` is dropped, and must be 0 (a batch of uint8,
    float32 and float64 groups, which all of this tool's older cases are)."""

    def __init__(self, lib):
        self.lib = lib
        fn = lib.cvgs_divergent
        fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name != "cvgs_divergent":
            return fn

        def call(*args):
            if args[-2]:
                raise ValueError("the older interface has no general divergent instance")
            return fn(*args[:-2], args[-1])
        return call


def takes_any_src(csrc: Path) -> bool:
    """Whether the divergent kernel in ``csrc`` takes ``any_src``."""
    return "int any_src" in (csrc / "divergent.cu").read_text()


def uses_source_flags(csrc: Path) -> bool:
    """Whether the sources in ``csrc`` take ``src_u8`` (the older interface)."""
    return "int src_u8" in (csrc / "batch_resize.cu").read_text()


def included(source: Path, seen: list) -> list:
    """The headers ``source`` includes by name from its own directory, and
    theirs, in the order first met."""
    for name in re.findall(r'#include "([^"]+)"', source.read_text()):
        header = source.parent / name
        if header.exists() and header not in seen:
            seen.append(header)
            included(header, seen)
    return seen


def object_key(source: Path, command) -> str:
    """A hash of one source's object: the source, the headers it includes
    and its compile command (``command(nvcc, source, output)``)."""
    h = hashlib.sha256()
    for f in [source, *included(source, [])]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(command("nvcc", Path("src.cu"), Path("src.o"))).encode())
    return h.hexdigest()[:24]


def build_variant(build, d: Path, objects: Path) -> str:
    """Build the sources in ``d`` into the library that ``build.load(d, d /
    "out")`` loads (``build`` the package's ``exec/_build.py``), compiling
    only the sources whose object is not in ``objects`` yet, each kept there
    under its ``object_key`` beside its compiler output. Returns the
    compiler output of every source (ptxas's registers and spills)."""
    objects.mkdir(parents=True, exist_ok=True)
    sources = sorted(d.glob("*.cu"))
    objs = [objects / f"{s.stem}.{object_key(s, build.compile_command)}.o" for s in sources]
    path = build.library_path(d, d / "out")
    if not path.exists():
        nvcc = build.find_nvcc()
        todo = [(s, o) for s, o in zip(sources, objs) if not o.exists()]
        tmp = [o.with_name(f"{o.name}.{os.getpid()}.tmp.o") for _, o in todo]
        procs = [subprocess.Popen(build.compile_command(nvcc, s, t), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for (s, _), t in zip(todo, tmp)]
        for p, t, (_, o) in zip(procs, tmp, todo):
            o.with_suffix(".log").write_text(build._run([p], "compile"))
            os.replace(t, o)
        path.parent.mkdir(parents=True, exist_ok=True)
        linked = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        build._run([subprocess.Popen(build.link_command(nvcc, objs, linked),
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)],
                   "link")
        os.replace(linked, path)
    return "".join(o.with_suffix(".log").read_text() for o in objs)


def main() -> int:
    import torch

    sass = "--sass" in sys.argv
    if sass:
        sys.argv.remove("--sass")
    picked = [a for a in sys.argv if a.startswith("--variants=")]
    for a in picked:
        sys.argv.remove(a)
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
    from cvgpuspeedup_tpu_torch.exec import cuda_divergent_split as ks
    from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
    from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
    from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
    from cvgpuspeedup_tpu_torch.graph import map_leaves
    from cvgpuspeedup_tpu_torch.utils.dtypes import kernel_source
    from cvgpuspeedup_tpu_torch.utils.profiling import time_cuda

    sys.path.insert(0, str(ROOT / "tools"))
    import kernel_sass

    variants = json.loads(Path(sys.argv[1]).read_text())
    listed = variants.pop("cases", None)
    if picked:
        keep = picked[-1].split("=", 1)[1].split(",")
        if set(keep) - set(variants):
            print(f"no variant named {sorted(set(keep) - set(variants))}", file=sys.stderr)
            return 2
        variants = {k: v for k, v in variants.items() if k in keep}
    rounds = int(sys.argv[2]) if len(sys.argv) >= 3 else 6
    listed = sys.argv[3] if len(sys.argv) == 4 else listed
    only = set(listed.split(",")) if listed else None
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
    twins = {"f32": torch.float32, "i32": torch.int32, "i64": torch.int64,
             "f64": torch.float64}
    for tag, dtype in twins.items():
        cases[f"k1_{tag}"] = (kbr, kbr.batch_resize, cs.flagship_ops(cvgs, frame.to(dtype), rects))
        cases[f"w6_{tag}"] = (kw, kw.warp, cs.warp_batch_ops(cvgs, cvgs.image(hd.to(dtype)),
                                                             -10.0, 7))
    batches["d1_f64"] = rows.d1(3, rows.ring.double())
    for tag, dtype in (("i64", torch.int64), ("f64", torch.float64)):
        wide = cs.pointwise_rows(cvgs, mad_src.to(dtype), rows.ring.to(dtype), 3, hd.to(dtype),
                                 (-300, -200), nv12_hd)
        for k, ops in enumerate(list(wide.values())[:4], 1):
            cases[f"p{k}_{tag}"] = (kp, kp.pointwise, ops)
            pointwise_cases.add(f"p{k}_{tag}")
    # P4's crop of a float64 frame a sixteenth each of chip_smoke's EDGES64:
    # a copy, which keeps float32's subnormals (1e-40, -1e-42)
    cases["p4_edges_f64"] = (kp, kp.pointwise, (
        cvgs.crop(cvgs.image(cs.as_float64(torch, hd, edges=True)), cvgs.Rect(-300, -200, 256, 256)),
        cvgs.write()))
    pointwise_cases.add("p4_edges_f64")
    # the composed-read kernel's cases C1-C8 (c1 .. c8), C1 on float32 and
    # float64 twins of its 4K frame (c1_f32, c1_f64) and C4 into a width
    # that is no multiple of 4 (c4_ragged: every thread row ends in a
    # partial group)
    from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc

    composed = cs.composed_cases(cvgs, frame, hd, nv12)
    for k, ops in enumerate(composed.values(), 1):
        cases[f"c{k}"] = (kc, kc.composed, ops)
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        cases[f"c1_{tag}"] = (kc, kc.composed, cs.composed_cases(
            cvgs, frame.to(dtype), hd, nv12)["c1_roi_crop_resize"])
    x, y, w, h = cs.ROI
    c4 = composed["c4_warp_of_a_crop"]
    cases["c4_ragged"] = (kc, kc.composed, (
        cvgs.warp(cvgs.crop(cvgs.image(frame), cvgs.Rect(x, y, w, h)),
                  cs.rotation((w / 2, h / 2), 10.0, 1.0), cvgs.Size(w - 3, h)), *c4[1:]))
    cams = [torch.from_numpy(rng.integers(0, 256, (cs.FRAME_H, cs.FRAME_W, 3), dtype=np.uint8))
            .to(dev) for _ in range(cs.CAMERAS)]
    for k, ops in enumerate(cs.batch_cases(cvgs, cams, frame).values(), 1):
        cases[f"b{k}"] = (kc, kc.composed, ops)
    batch_names = {name for name in cases if name.startswith("b")}
    # the nested cases N1-N6 (n1 .. n6): two levels of resampling, or a
    # fused read above the core
    for k, ops in enumerate((*cs.nested_cases(cvgs, frame, hd, cams).values(),
                             *cs.budget_nested_cases(cvgs, frame).values()), 1):
        cases[f"n{k}"] = (kc, kc.composed, ops)
    nested_names = {f"n{k}" for k in range(1, 9)}
    # the mixed-geometry batches M1-M5 (m1 .. m5): planes of one shape, each
    # its own geometry
    m_cams = [torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
              for h, w in cs.M_CAMERAS]
    m_nv12 = [torch.from_numpy(rng.integers(0, 256, (h * 3 // 2, w), dtype=np.uint8)).to(dev)
              for h, w in cs.M5_NV12]
    for k, ops in enumerate(cs.mixed_cases(cvgs, m_cams, frame, m_nv12).values(), 1):
        cases[f"m{k}"] = (kc, kc.composed, ops)
    mixed_names = {f"m{k}" for k in range(1, 6)}
    # the batches of nested planes of their own geometry NM1-NM4 (nm1 .. nm4)
    for k, ops in enumerate(cs.nested_mixed_cases(cvgs, m_cams, frame).values(), 1):
        cases[f"nm{k}"] = (kc, kc.composed, ops)
    nested_mixed_names = {f"nm{k}" for k in range(1, 5)}
    # the divergent batches DV1-DV4 (dv1 .. dv4) and those with a nested
    # group DVN1-DVN4 (dvn1 .. dvn4), through their divergent plans
    cams43 = [torch.from_numpy(rng.integers(0, 256, (*cs.DV_CAMERA, 3), dtype=np.uint8))
              .to(dev) for _ in range(cs.CAMERAS)]
    sensor = torch.from_numpy(rng.integers(0, 4096, (*cs.DV_SENSOR, 3)).astype(np.uint16)).to(dev)
    nv12_cams = [torch.from_numpy(rng.integers(0, 256, (cs.FRAME_H * 3 // 2, cs.FRAME_W),
                                               dtype=np.uint8)).to(dev) for _ in range(cs.CAMERAS)]
    divergent = {f"dv{k}": v for k, v in enumerate(
        cs.divergent_composed_cases(cvgs, cams, cams43, frame, sensor).values(), 1)}
    divergent.update({f"dvn{k}": v for k, v in enumerate(
        cs.divergent_nested_cases(cvgs, cams, nv12_cams, sensor).values(), 1)})
    # the split batches DK1-DK4 (dk1 .. dk4), through the split kernel
    side = cs.SPLIT_RING[1]
    split_ring = torch.from_numpy(rng.integers(0, 256, (cs.SPLIT_RING[0], side, side, 3),
                                               dtype=np.uint8)).to(dev)
    split_stack = torch.from_numpy(rng.integers(0, 256, (*cs.SPLIT_STACK, 3), dtype=np.uint8)
                                   ).to(dev)
    split = {f"dk{k}": v for k, v in enumerate(cs.split_cases(
        cvgs, cams, split_ring, frame, split_stack, sensor, nv12_cams).values(), 1)}
    composed_names = {name for name in cases if name.startswith(("c", "b"))}
    x64_cases = {name for name in (*cases, *batches) if name.endswith(("_i64", "_f64"))}
    launches = {}
    # host leaves onto the card once; a tensor, 64-bit ones among them, stays
    for name, (module, wrapper, ops) in cases.items():
        pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: kernel_source(v, dev))
        args = module.prepare(pipe, module.build_plan(pipe), dev)
        launches[name] = (lambda wrapper=wrapper, args=args: wrapper(args))
    for name, (ids, seqs) in batches.items():
        seqs = map_leaves(seqs, lambda v: kernel_source(v, dev))
        args = kd.prepare(seqs, kd.build_plan(seqs, ids), dev)
        launches[name] = (lambda args=args: kd.divergent(args))
    for name, (ids, ops) in divergent.items():
        seqs = map_leaves(tuple(cvgs.build_operation_sequence(*o) for o in ops),
                          lambda v: kernel_source(v, dev))
        args = kc.prepare(seqs, kc.build_divergent_plan(seqs, ids), dev)
        launches[name] = (lambda args=args: kc.composed(args))
    for name, (ids, ops) in split.items():
        seqs = map_leaves(tuple(cvgs.build_operation_sequence(*o) for o in ops),
                          lambda v: kernel_source(v, dev))
        args = ks.prepare(seqs, ks.build_split_plan(seqs, ids), dev)
        launches[name] = (lambda args=args: ks.divergent_split(args))
    if only is not None:
        if only - set(launches):
            print(f"no case named {sorted(only - set(launches))}", file=sys.stderr)
            return 1
        launches = {name: fn for name, fn in launches.items() if name in only}

    def runs(cname, d) -> bool:
        """Whether the library in use, built from ``d``, has the case's
        kernel and reads its source."""
        if cname in x64_cases and not (d / "source_int64.cu").exists():
            return False
        if cname in composed_names and not hasattr(_build.load(), "cvgs_composed"):
            return False
        if cname in batch_names and "plane_stride" not in (d / "composed.cuh").read_text():
            return False
        if cname in nested_names and not hasattr(_build.load(), "cvgs_composed_nested"):
            return False
        if cname in mixed_names and "composed_kernel_mixed" not in (d / "composed.cuh").read_text():
            return False
        if cname in nested_mixed_names and "composed_kernel_nested_mixed" not in (
                d / "composed_nested.cuh").read_text():
            return False
        if cname.startswith("dk") and not (d / "divergent_split.cu").exists():
            return False
        if cname.startswith("dvn") and not (d / "composed_nested_divergent.cu").exists():
            return False
        if cname.startswith("dv") and "CM_DIVERGENT" not in (d / "composed.cuh").read_text():
            return False
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

    compile_command = _build.compile_command
    dropped: dict = {}
    probes: set = set()
    current: dict = {}

    def variant_command(nvcc, source, output):
        """The build's command without the flags the variant in use drops."""
        return [f for f in compile_command(nvcc, source, output)
                if f not in dropped.get(current.get("d"), ())]

    _build.compile_command = variant_command  # the library's name hashes it too

    def use(d):
        """Load the sources in ``d``, built by ``build_variant``: the library
        every wrapper launches from from now on."""
        current["d"] = d
        lib = _build.load(d, d / "out")
        if not takes_any_src(d):
            lib = _build._LIB = AnySrcAbi(lib)
        if uses_source_flags(d):
            _build._LIB = SourceFlagAbi(lib)

    csrc = ROOT / "cvgpuspeedup_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory(prefix="kernel_variants_") as tmp:
        objects = Path(tmp) / "objects"
        dirs = {}
        first_regs = None
        for vname, subs in variants.items():
            d = Path(tmp) / vname
            d.mkdir()
            from_dir = csrc
            if isinstance(subs, str):
                subs = {"csrc": subs}
            if isinstance(subs, dict):
                dropped[d] = tuple(subs.get("drop_flags", ()))
                if subs.get("probe"):
                    probes.add(vname)
                from_dir = ROOT / subs["csrc"] if "csrc" in subs else csrc
                subs = subs.get("subs", [])
            if from_dir != csrc:
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
            current["d"] = d
            log = build_variant(_build, d, objects)
            use(d)
            entry = ""
            regs = {}
            for line in log.splitlines():
                if "Compiling entry" in line:
                    found = re.search(r"\d\d([a-z_]+_kernel(?:_nested(?:_staged)?)?)I(\w+?)EEv",
                                      line.split("'")[1])
                    entry = f"{found.group(1)}<{found.group(2)}>" if found else line.split("'")[1]
                if "spill" in line and "0 bytes spill stores" not in line:
                    print(f"{vname}: {entry}: {line.strip()}")
                if "Used" in line and "registers" in line:
                    regs[entry] = int(line.split("Used")[1].split()[0])
            first_regs = first_regs or regs
            changed = {k: v for k, v in regs.items() if first_regs.get(k) != v}
            print(f"{vname}: registers " + (", ".join(f"{k} {v}" for k, v in (
                regs if regs is first_regs else changed).items()) or "as the first variant's"))
            if dropped.get(d):
                print(f"{vname}: built without {' '.join(dropped[d])}")
            if sass:
                for kernel, c in kernel_sass.ftz_census(_build.library_path(d, d / "out")).items():
                    c["no_ftz_opcodes"] = dict(c["no_ftz_opcodes"].most_common(4))
                    print(f"{vname}: sass {kernel} {c}")

        # a variant may change the speed of a kernel, never a bit of its output
        outputs: dict = {}
        for vname, d in dirs.items():
            if vname in probes:
                continue
            use(d)
            for cname, fn in launches.items():
                if not runs(cname, d):
                    continue
                got = fn()
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                want = outputs.setdefault(cname, got)
                if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
                    bad = sum(int((g != w).sum()) for g, w in zip(got, want, strict=True))
                    print(f"{vname}: {cname} differs from {next(iter(dirs))}'s output in {bad} "
                          "values", file=sys.stderr)
                    return 1
        del outputs

        results: dict = {}
        for _ in range(rounds):
            for vname, d in dirs.items():
                use(d)  # built above: this makes it the library in use
                for cname, fn in launches.items():
                    if not runs(cname, d):
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
