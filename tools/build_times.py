#!/usr/bin/env python3
"""Time the compile of each CUDA source of the port alone, then the build
of all of them in parallel, as ``exec/_build.py`` runs it.

    python3 tools/build_times.py [--rounds N] [csrc_dir[:flag,...] ...]

For each directory of sources (the package's ``csrc`` unless given; another
tree's, such as the parent commit's unpacked with ``git archive``, to
compare; after a colon, flags of ``exec/_build.py``'s command left out for
that directory, such as ``-ftz=true``), prints each source's ``nvcc`` time in seconds when it compiles
alone, their sum, and the wall time of the parallel build into a temporary
directory (``_build.build``, each source in a process of its own, then the
link). With ``--rounds N`` it times the parallel build alone, N rounds of
every directory in turn, the order reversed in every other round (trees
compared within one call). Needs ``nvcc``; no card.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from cvgpuspeedup_tpu_torch.exec import _build

    args = sys.argv[1:]
    rounds = 0
    if args[:1] == ["--rounds"]:
        rounds, args = int(args[1]), args[2:]
    args = args or [str(ROOT / "cvgpuspeedup_tpu_torch" / "csrc")]
    nvcc = _build.find_nvcc()
    command = _build.compile_command

    def use(arg):
        path, _, drop = arg.partition(":")
        csrc, dropped = Path(path), set(filter(None, drop.split(",")))
        _build.compile_command = lambda *a: [f for f in command(*a) if f not in dropped]
        return csrc, dropped

    if rounds:
        times = {arg: [] for arg in args}
        for r in range(rounds):
            for arg in args if r % 2 == 0 else args[::-1]:
                csrc, _ = use(arg)
                with tempfile.TemporaryDirectory(prefix="build_times_") as tmp:
                    t0 = time.perf_counter()
                    _build.build(csrc, Path(tmp) / "lib")
                    times[arg].append(time.perf_counter() - t0)
                print(f"round {r + 1}: {arg} {times[arg][-1]:.1f} s in parallel", flush=True)
        for arg, t in times.items():
            print(f"{arg}: {len(_build._inputs(use(arg)[0])[0])} sources, in parallel "
                  + " / ".join(f"{v:.1f}" for v in t) + " s (link included)")
        return 0
    for arg in args:
        csrc, dropped = use(arg)
        sources, _ = _build._inputs(csrc)
        with tempfile.TemporaryDirectory(prefix="build_times_") as tmp:
            alone = {}
            for s in sources:
                t0 = time.perf_counter()
                subprocess.run(_build.compile_command(nvcc, s, Path(tmp) / f"{s.stem}.o"),
                               check=True, capture_output=True)
                alone[s.name] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _build.build(csrc, Path(tmp) / "lib")
            parallel = time.perf_counter() - t0
        print(f"{csrc}: " + ", ".join(f"{n} {t:.1f}" for n, t in
                                      sorted(alone.items(), key=lambda kv: -kv[1])))
        print(f"{csrc}: {len(sources)} sources, {sum(alone.values()):.1f} s one by one, "
              f"{parallel:.1f} s in parallel (link included)"
              + (f", without {' '.join(sorted(dropped))}" if dropped else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
