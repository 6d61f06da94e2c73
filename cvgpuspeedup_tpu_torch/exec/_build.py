"""Build the package's CUDA sources into one shared library and load it.

``nvcc`` compiles each ``csrc/*.cu`` for Hopper (``sm_90a``) into an object,
all of them at once in parallel processes, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``. Nothing
here includes PyTorch's headers, so a build takes seconds. The library lands
in ``build/kernels/`` beside the package, named by a hash of the sources,
the headers they include (``csrc/*.cuh``) and the command lines, so an
edited source or header is rebuilt at its next use. The build runs at first
use, never at import. ``load(csrc_dir, build_dir)`` builds another directory
of sources instead and makes it the library every wrapper launches from, for
timing two versions of a kernel in one process.

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
HEADERS = sorted((PACKAGE_DIR / "csrc").glob("*.cuh"))
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

#: the last build's compiler output (register and spill counts from ptxas)
BUILD_LOG = ""
#: set by ``executor.debug_mode``: each wrapper then waits for its launch
DEBUG = False


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


def compile_command(nvcc: str, source: Path, output: Path) -> List[str]:
    """One source to one object: Hopper target, no FMA contraction, float32
    subnormal operands and results flushed to a zero of their sign
    (``-ftz=true``, the reference's rule: ``utils/dtypes.py::flush_subnormal``),
    no fast math, position-independent for the shared library."""
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-fmad=false",
        "-ftz=true",
        "-Xptxas", "-v",
        "-Xcompiler", "-fPIC",
        "-c", str(source),
        "-o", str(output),
    ]


def link_command(nvcc: str, objects: List[Path], output: Path) -> List[str]:
    """The objects to one shared library."""
    return [nvcc, "-shared", "-o", str(output), *[str(o) for o in objects]]


def _inputs(csrc_dir: Optional[Path]):
    """The sources and headers of ``csrc_dir``, by default the package's own."""
    if csrc_dir is None:
        return SOURCES, HEADERS
    return sorted(Path(csrc_dir).glob("*.cu")), sorted(Path(csrc_dir).glob("*.cuh"))


def library_path(csrc_dir: Optional[Path] = None, build_dir: Optional[Path] = None) -> Path:
    """Where the library for the sources, headers and flags lives."""
    sources, headers = _inputs(csrc_dir)
    h = hashlib.sha256()
    for s in sources + headers:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(compile_command("nvcc", Path("src.cu"), Path("src.o"))).encode())
    h.update(" ".join(link_command("nvcc", [Path("src.o")], Path("lib.so"))).encode())
    return (build_dir or BUILD_DIR) / f"libcvgs_kernels_{h.hexdigest()[:16]}.so"


def _run(procs, what: str) -> str:
    """Wait for every process, then raise if any failed; returns their output."""
    outs = [(p, *p.communicate()) for p in procs]
    log = "".join(o + e for _, o, e in outs)
    failed = [p.returncode for p, _, _ in outs if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed to {what} (exit {failed[0]}):\n{log}")
    return log


def build(csrc_dir: Optional[Path] = None, build_dir: Optional[Path] = None) -> Path:
    """Compile the sources unless the library for them already exists."""
    global BUILD_LOG
    path = library_path(csrc_dir, build_dir)
    if path.exists():
        return path
    sources, _ = _inputs(csrc_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objects = [path.parent / f"{tag}.{s.stem}.o" for s in sources]
    procs = [subprocess.Popen(compile_command(nvcc, s, o), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(sources, objects)]
    BUILD_LOG = _run(procs, "compile")
    tmp = path.with_name(f"{tag}.tmp.so")
    BUILD_LOG += _run([subprocess.Popen(link_command(nvcc, objects, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)], "link")
    for o in objects:
        o.unlink()
    os.replace(tmp, path)
    return path


def load(csrc_dir: Optional[Path] = None, build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The built library with every function's argument types declared.

    With no arguments, the library in use: the package's own sources, built
    at the first call. With ``csrc_dir``, the library of those sources, built
    into ``build_dir``, which later calls without arguments return too."""
    global _LIB
    with _LOCK:
        if _LIB is None or csrc_dir is not None:
            lib = ctypes.CDLL(str(build(csrc_dir, build_dir)))
            p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.cvgs_batch_resize.argtypes = [
                p, i, ll, i, i, i,         # src, src_type, plane_stride, src_h, src_w, nch
                p, p, p, p, i,             # rects, used, fparams, ops, n_ops
                i, i, i, i,                # n_planes, dst_w, dst_h, mode
                p, i, i, i,                # out, out_type, out_ch, store_op
                ll, ll, ll, ll,            # sn, sc, sy, sx
                p,                         # stream
            ]
            lib.cvgs_batch_resize.restype = ctypes.c_int
            lib.cvgs_frame_resize.argtypes = [
                p, i, i, i, i,             # src, src_type, src_h, src_w, nch
                i, i, p, p, i,             # yuv, nv21, taps, weights, keep_edge
                i, i, f, f, f, f, f, f,    # limited, alpha, ys, cs, rv, gu, gv, bu
                p, p, i,                   # fparams, ops, n_ops
                i, i, p, i, i, i,          # dst_w, dst_h, out, out_type, out_ch, store_op
                ll, ll, ll,                # sc, sy, sx
                p,                         # stream
            ]
            lib.cvgs_frame_resize.restype = ctypes.c_int
            lib.cvgs_warp.argtypes = [
                p, i, i, i, i, i,          # srcs, src_type, src_h, src_w, nch, perspective
                p, p, p, p, p, p, i,       # coeffs, border, default, used, fparams, ops, n_ops
                i, i, i,                   # n_planes, dst_w, dst_h
                p, i, i, i,                # out, out_type, out_ch, store_op
                ll, ll, ll, ll,            # sn, sc, sy, sx
                p,                         # stream
            ]
            lib.cvgs_warp.restype = ctypes.c_int
            lib.cvgs_divergent.argtypes = [
                p, p, i, i, i,             # blk, consts, ptr_off, desc_off, n_groups
                i, i, i,                   # n_planes, dst_w, dst_h
                p, i, i, ll, ll, ll, ll,   # out, out_type, out_ch, sn, sc, sy, sx
                i, p,                      # any_src, stream
            ]
            lib.cvgs_divergent.restype = ctypes.c_int
            # another directory of sources (an earlier tree's) may lack it
            if csrc_dir is None or hasattr(lib, "cvgs_pointwise"):
                lib.cvgs_pointwise.argtypes = [
                    p, p, f, f, f, f, f, f,    # src, head (host words), ys, cs, rv, gu, gv, bu
                    p, p, i, i,                # blk, ops, n_ops, fp_off
                    i, i, i,                   # n_planes, dst_w, dst_h
                    p, i, i, i,                # out, out_type, out_ch, store_op
                    ll, ll, ll, ll,            # sn, sc, sy, sx
                    p,                         # stream
                ]
                lib.cvgs_pointwise.restype = ctypes.c_int
            if csrc_dir is None or hasattr(lib, "cvgs_composed"):
                lib.cvgs_composed.argtypes = [
                    p, p, f, f, f, f, f, f,    # src, head (host words), ys, cs, rv, gu, gv, bu
                    p, p,                      # blk, consts
                    i, i, i,                   # n_planes, dst_w, dst_h
                    p, i, i, i,                # out, out_type, out_ch, store_op
                    ll, ll, ll, ll,            # sn, sc, sy, sx
                    p,                         # stream
                ]
                lib.cvgs_composed.restype = ctypes.c_int
            if csrc_dir is None or hasattr(lib, "cvgs_composed_nested"):
                # a nested plan's head: its CmNested words; the rest as above
                lib.cvgs_composed_nested.argtypes = lib.cvgs_composed.argtypes
                lib.cvgs_composed_nested.restype = ctypes.c_int
            if csrc_dir is None or hasattr(lib, "cvgs_divergent_split"):
                lib.cvgs_divergent_split.argtypes = [
                    p, p, i, i, i,             # blk, consts, ptr_off, desc_off, n_groups
                    i, i, p, i,                # cm_blk_off, cm_consts_off, head (host), nested
                    f, f, f, f, f, f,          # ys, cs, rv, gu, gv, bu
                    i, i, i,                   # n_planes, dst_w, dst_h
                    p, i, i,                   # out, out_type, out_ch
                    ll, ll, ll, ll,            # sn, sc, sy, sx
                    p,                         # stream
                ]
                lib.cvgs_divergent_split.restype = ctypes.c_int
            lib.cvgs_error_string.argtypes = [ctypes.c_int]
            lib.cvgs_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def after_launch(kernel: str, device) -> None:
    """Called by each wrapper after it queued its kernel on ``device``. In
    ``executor.debug_mode`` it waits for the device and raises, naming
    ``kernel``, on a CUDA error the launch hit; else it does nothing."""
    if not DEBUG:
        return
    import torch

    try:
        torch.cuda.synchronize(device)
    except RuntimeError as e:
        raise RuntimeError(f"{kernel}: CUDA error after its launch: {e}") from e
