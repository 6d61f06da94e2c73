#!/usr/bin/env python3
"""Time the compile of named CUDA sources of the port, all started together.

    python3 tools/compile_together.py name.cu [name.cu ...]

Starts one ``nvcc`` per named source of ``cvgpuspeedup_tpu_torch/csrc``
at once, with ``exec/_build.py``'s command line, into a temporary
directory, and prints each source's seconds from the common start to its
own end as it finishes: with no more sources than the machine's cores, each
near its time alone. Needs ``nvcc``; no card.
"""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from cvgpuspeedup_tpu_torch.exec import _build  # noqa: E402


def main() -> int:
    csrc = _build.PACKAGE_DIR / "csrc"
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            _build.compile_command(nvcc, csrc / name, Path(tmp) / (name + ".o")),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for name in sys.argv[1:]}
        left = dict(procs)
        while left:
            for name, p in list(left.items()):
                if p.poll() is not None:
                    print(f"compile {name}: {time.perf_counter() - t0:.1f} s, {len(procs)} "
                          f"started together, rc {p.returncode}", flush=True)
                    del left[name]
            time.sleep(0.2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
