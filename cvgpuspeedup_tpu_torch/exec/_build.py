"""Build the package's CUDA sources into one shared library and load it.

``nvcc`` compiles ``csrc/*.cu`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. Nothing here
includes PyTorch's headers, so a build takes seconds. The library lands in
``build/kernels/`` beside the package, named by a hash of the sources and
the command line, so an edited source is rebuilt at its next use. The build
runs at first use, never at import.

``nvcc`` is taken from ``$CUDA_HOME/bin``, else from ``PATH``, else from the
toolkit PyTorch itself locates; a build without one raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCES = sorted((PACKAGE_DIR / "csrc").glob("*.cu"))
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

#: the last build's compiler output (register and spill counts from ptxas)
BUILD_LOG = ""


def find_nvcc() -> str:
    """Path of ``nvcc``; raises ``RuntimeError`` when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def nvcc_command(nvcc: str, sources: List[Path], output: Path) -> List[str]:
    """The compile command: Hopper target, no FMA contraction, no fast math."""
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-fmad=false",
        "-Xptxas", "-v",
        "-shared",
        "-Xcompiler", "-fPIC",
        "-o", str(output),
        *[str(s) for s in sources],
    ]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for s in SOURCES:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(nvcc_command("nvcc", [], Path("lib.so"))).encode())
    return BUILD_DIR / f"libcvgs_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    global BUILD_LOG
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        nvcc_command(find_nvcc(), SOURCES, tmp), capture_output=True, text=True, check=False
    )
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The built library with every function's argument types declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cvgs_batch_resize.argtypes = [
                p, i, ll, i, i, i,      # src, src_u8, plane_stride, src_h, src_w, nch
                p, p, p, p, i,          # rects, used, fparams, ops, n_ops
                i, i, i, i,             # n_planes, dst_w, dst_h, mode
                p, i, ll, ll, ll, ll,   # out, out_u8, sn, sc, sy, sx
                p,                      # stream
            ]
            lib.cvgs_batch_resize.restype = ctypes.c_int
            lib.cvgs_error_string.argtypes = [ctypes.c_int]
            lib.cvgs_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB
