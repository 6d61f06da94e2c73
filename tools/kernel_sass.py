#!/usr/bin/env python3
"""Count what a kernel of the port's library is made of, from its SASS.

    python3 tools/kernel_sass.py [pattern [out.txt]]
    python3 tools/kernel_sass.py --ftz
    python3 tools/kernel_sass.py --compare csrc_dir [csrc_dir]

Builds ``cvgpuspeedup_tpu_torch/csrc`` (``exec/_build.py``: nothing is built
twice), dumps with ``cuobjdump -sass`` every kernel whose mangled name holds
``pattern`` (``pointwise_kernelIfLi4ELi4ELb0E``, the float32 instance with
4 lanes and 4 pixels per thread for 32-bit sources, unless given) and
prints for each: its instruction count, its
local-memory loads and stores (``LDL``, ``STL``: spills), every loop (a
backward branch) with its length in instructions, and the opcodes of the
longest loop, most frequent first. With ``out.txt`` the SASS itself is
written there. With ``--ftz`` it prints for each kernel of ``KERNELS``, over
all its instances, the float32 add, multiply, compare and min/max
instructions without ``.FTZ`` (among them ``KEEP_TERMS``, a warp map's
terms) and the float64 to float32 conversions with and without it
(:func:`ftz_census`). With ``--compare`` it builds two trees of sources
(the second the package's own unless given; the first such as the parent
commit's unpacked with ``git archive``) and holds every kernel instance the
two share against each other, instruction by instruction
(:func:`sass_by_function`): it prints how many are identical, names those
that differ and those of one tree alone, and exits 1 where any differs.
Needs ``nvcc``'s toolkit (``cuobjdump`` beside it); no card.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_INSTRUCTION = re.compile(r"\s+/\*([0-9a-f]{4,6})\*/\s+(.*?);")
_FUNCTION = re.compile(r"^\s*Function : (\S+)", re.M)
#: float32 arithmetic, compare and min/max opcodes that take ``.FTZ``
FTZ_OPCODES = ("FADD", "FADD32I", "FMUL", "FMUL32I", "FSETP", "FMNMX")
#: the kernels of the library, by the name each instance's symbol holds (the
#: composed kernel's nested instances, ``composed_kernel_nested``, count as
#: its own; the split kernel's, ``divergent_split_kernel`` and
#: ``divergent_split_nested``, K6's body beside the composed kernel's, as one)
KERNELS = ("batch_resize_kernel", "frame_resize_kernel", "warp_kernel", "divergent_kernel",
           "pointwise_kernel", "composed_kernel", "divergent_split")
#: the census's one exception: a warp map's terms c*X and b*Y + c, computed
#: as the host computes them with a subnormal kept (``csrc/warp.cuh``'s
#: ``fmul_keep`` and ``fadd_keep``, PTX ``mul.rn.f32`` and ``add.rn.f32``
#: without ``.ftz``), are an FMUL or FADD without ``.FTZ`` in the kernels
#: that compute warp coordinates, and only there
KEEP_TERMS = {"opcodes": ("FMUL", "FADD"),
              "kernels": ("warp_kernel", "divergent_kernel", "composed_kernel",
                          "divergent_split")}


def kernel_stats(sass: str) -> dict:
    """Counts of one kernel's SASS text (see the module's docstring)."""
    ins = [(int(m.group(1), 16), m.group(2).strip())
           for m in map(_INSTRUCTION.match, sass.splitlines()) if m]

    def opcode(text: str) -> str:
        words = text.split()
        return words[1] if words[0].startswith("@") else words[0]

    loops = []
    for addr, text in ins:
        m = re.search(r"\bBRA\S*\s+.*?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    stats = {"instructions": len(ins),
             "local_ops": sum(opcode(t).startswith(("LDL", "STL")) for _, t in ins),
             "loops": [(hi - lo) // 16 + 1 for lo, hi in loops], "longest_loop_opcodes": []}
    if loops:
        lo, hi = max(loops, key=lambda r: r[1] - r[0])
        body = [t for a, t in ins if lo <= a <= hi]
        stats["longest_loop_opcodes"] = collections.Counter(map(opcode, body)).most_common(16)
        stats["longest_loop_local_ops"] = sum(opcode(t).startswith(("LDL", "STL")) for t in body)
    return stats


def ftz_stats(sass: str) -> dict:
    """The float32 rule in one kernel's SASS (``utils/dtypes.py::flush_subnormal``):
    ``f32_ops`` and ``f32_no_ftz``, the instructions of ``FTZ_OPCODES`` and
    those of them without ``.FTZ``; ``f2f_f64`` and ``f2f_f64_ftz``, the
    float64 to float32 conversions (``F2F.F32.F64``) and those with ``.FTZ``,
    which a copy of a float64 source must not have; ``no_ftz_opcodes``, the
    opcodes without ``.FTZ`` by count; ``keep_terms``, those of them that
    are ``KEEP_TERMS``' opcodes (a plain ``FMUL`` or ``FADD``)."""
    out = {"f32_ops": 0, "f32_no_ftz": 0, "keep_terms": 0, "f2f_f64": 0, "f2f_f64_ftz": 0,
           "no_ftz_opcodes": collections.Counter()}
    for m in map(_INSTRUCTION.match, sass.splitlines()):
        if not m:
            continue
        words = m.group(2).split()
        opcode = words[1] if words[0].startswith("@") else words[0]
        parts = opcode.split(".")
        if parts[0] in FTZ_OPCODES:
            out["f32_ops"] += 1
            if "FTZ" not in parts:
                out["f32_no_ftz"] += 1
                out["no_ftz_opcodes"][opcode] += 1
                out["keep_terms"] += parts[0] in KEEP_TERMS["opcodes"]
        elif parts[0] == "F2F" and "F32" in parts and "F64" in parts:
            out["f2f_f64"] += 1
            out["f2f_f64_ftz"] += "FTZ" in parts
    return out


def ftz_census(lib: Path) -> dict:
    """:func:`ftz_stats` summed over every instance of each of ``KERNELS``
    in the library ``lib`` (one ``cuobjdump -sass`` of the whole library),
    with ``instances``, the count of instances, and :func:`rule_holds`."""
    from cvgpuspeedup_tpu_torch.exec import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    census = {k: {"instances": 0, "f32_ops": 0, "f32_no_ftz": 0, "keep_terms": 0, "f2f_f64": 0,
                  "f2f_f64_ftz": 0, "no_ftz_opcodes": collections.Counter()} for k in KERNELS}
    heads = list(_FUNCTION.finditer(sass))
    for i, h in enumerate(heads):
        kernel = next((k for k in KERNELS if k in h.group(1)), None)
        if kernel is None:
            continue
        body = sass[h.end():heads[i + 1].start() if i + 1 < len(heads) else len(sass)]
        census[kernel]["instances"] += 1
        for key, n in ftz_stats(body).items():
            census[kernel][key] += n
    for kernel, c in census.items():
        c["rule_holds"] = rule_holds(kernel, c)
    return census


#: the per-file tag of an anonymous namespace in a mangled name (its
#: hashes differ between two builds of the same file)
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]{8}")


def sass_by_function(lib: Path) -> dict:
    """Each kernel instance of the library ``lib`` (one ``cuobjdump -sass``):
    its mangled name with the anonymous namespace's tag made the file's name,
    mapped to its instructions' text, addresses left out."""
    from cvgpuspeedup_tpu_torch.exec import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    heads = list(_FUNCTION.finditer(sass))
    out = {}
    for i, h in enumerate(heads):
        body = sass[h.end():heads[i + 1].start() if i + 1 < len(heads) else len(sass)]
        out[_ANON.sub(r"\1", h.group(1))] = tuple(
            _ANON.sub(r"\1", m.group(2).strip())
            for m in map(_INSTRUCTION.match, body.splitlines()) if m)
    return out


def rule_holds(kernel: str, c: dict) -> bool:
    """Whether the counts ``c`` of ``kernel`` (:func:`ftz_stats` with
    ``instances``) keep the float32 rule: no op of :data:`FTZ_OPCODES`
    without ``.FTZ`` but ``KEEP_TERMS``' in its kernels, and the float64
    conversions present and without ``.FTZ``."""
    allowed = c["keep_terms"] if kernel in KEEP_TERMS["kernels"] else 0
    return bool(c["instances"] and c["f32_no_ftz"] == allowed and c["f2f_f64"]
                and not c["f2f_f64_ftz"])


def main() -> int:
    if sys.argv[1:2] == ["--compare"]:
        sys.path.insert(0, str(ROOT))
        import tempfile

        from cvgpuspeedup_tpu_torch.exec import _build

        trees = [Path(d) for d in sys.argv[2:4]]
        trees += [ROOT / "cvgpuspeedup_tpu_torch" / "csrc"] * (2 - len(trees))
        with tempfile.TemporaryDirectory(prefix="kernel_sass_") as tmp:
            a, b = (sass_by_function(_build.build(d, Path(tmp) / str(k)))
                    for k, d in enumerate(trees))
        shared = sorted(set(a) & set(b))
        differ = [n for n in shared if a[n] != b[n]]
        print(f"{len(shared) - len(differ)} of {len(shared)} shared kernel instances identical "
              f"in their SASS ({trees[0]} against {trees[1]})")
        for n in differ:
            print(f"differs: {n} ({len(a[n])} against {len(b[n])} instructions)")
        for n in sorted(set(a) ^ set(b)):
            print(f"only in {trees[0] if n in a else trees[1]}: {n} "
                  f"({len(a.get(n, b.get(n)))} instructions)")
        return 1 if differ else 0
    if sys.argv[1:2] == ["--ftz"]:
        sys.path.insert(0, str(ROOT))
        from cvgpuspeedup_tpu_torch.exec import _build

        for kernel, c in ftz_census(_build.build()).items():
            c["no_ftz_opcodes"] = dict(c["no_ftz_opcodes"].most_common(6))
            print(kernel, c)
        return 0
    pattern = sys.argv[1] if len(sys.argv) > 1 else "pointwise_kernelIfLi4ELi4ELb0E"
    sys.path.insert(0, str(ROOT))
    from cvgpuspeedup_tpu_torch.exec import _build

    lib = _build.build()
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    elf = subprocess.run([cuobjdump, "-elf", str(lib)], capture_output=True, text=True, check=True)
    names = sorted(set(re.findall(r"_Z\w*" + re.escape(pattern) + r"\w*", elf.stdout)))
    if not names:
        print(f"no kernel of {lib.name} is named *{pattern}*", file=sys.stderr)
        return 1
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass", "-fun", name, str(lib)], capture_output=True,
                              text=True, check=True).stdout
        if len(sys.argv) > 2:
            Path(sys.argv[2]).write_text(sass)
        s = kernel_stats(sass)
        print(f"{name}: {s['instructions']} instructions, {s['local_ops']} local loads and "
              f"stores, loops of {s['loops']} instructions")
        if s["longest_loop_opcodes"]:
            print(f"  longest loop: {s['longest_loop_local_ops']} local loads and stores; "
                  + ", ".join(f"{op} {n}" for op, n in s["longest_loop_opcodes"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
