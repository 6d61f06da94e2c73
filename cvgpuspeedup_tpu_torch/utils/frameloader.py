"""Python binding of the native streaming frame loader (``native/frameloader.cpp``).

Counterpart of ``cvgpuspeedup_tpu/utils/frameloader.py``. Raw NV12 or
packed-RGB frame sequences are read from disk through a native prefetch ring,
so the next frame is already in host memory while the card runs the current
pipeline. :class:`FrameLoader` yields zero-copy numpy views of the ring's
slots; each view's memory is recycled at the next iteration.

The shared library is compiled from ``native/frameloader.cpp`` with the host
C++ compiler (``$CXX``, else ``c++`` or ``g++`` on ``PATH``) at first use,
into ``build/native/`` beside the kernels' ``build/kernels/``, under a name
that hashes the source and the command line, as ``exec/_build.py`` names the
kernels' library. Where there is no compiler or no source, the loader reads
with numpy instead, with the same semantics and no prefetch; ``.native`` says
which reader is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "frameloader.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
#: the flags of ``native/Makefile``
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_LOCK = threading.Lock()
_lib = None
_lib_tried = False


def find_cxx() -> Optional[str]:
    """The host C++ compiler: ``$CXX``, else ``c++``, else ``g++``."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    return None


def compile_command(cxx: str, output: Path) -> List[str]:
    return [cxx, *CXXFLAGS, "-o", str(output), str(SOURCE)]


def library_path() -> Path:
    """Where the library for the source and the flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(compile_command("c++", Path("lib.so"))).encode())
    return BUILD_DIR / f"libframeloader_{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the loader unless its library exists; None where there is no
    source, no compiler, or the compiler fails."""
    if not SOURCE.is_file():
        return None
    path = library_path()
    if path.exists():
        return path
    cxx = find_cxx()
    if cxx is None:
        return None
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    done = subprocess.run(compile_command(cxx, tmp), capture_output=True, timeout=120)
    if done.returncode != 0:
        return None
    os.replace(tmp, path)
    return path


def _load_native():
    """The library with its argument types declared, or None (tried once)."""
    global _lib, _lib_tried
    with _LOCK:
        if _lib_tried:
            return _lib
        _lib_tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.flv_open.restype = ctypes.c_void_p
        lib.flv_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        lib.flv_frame_count.restype = ctypes.c_int64
        lib.flv_frame_count.argtypes = [ctypes.c_void_p]
        lib.flv_next.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.flv_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.flv_release.restype = None
        lib.flv_release.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.flv_close.restype = None
        lib.flv_close.argtypes = [ctypes.c_void_p]
        lib.flv_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def frame_shape_nv12(width: int, height: int) -> Tuple[int, int]:
    """The NV12 buffer shape of a WxH stream (luma rows, then half as many
    rows of interleaved chroma pairs)."""
    return (height * 3 // 2, width)


def frame_shape_packed(width: int, height: int, channels: int = 3) -> Tuple[int, int]:
    """The packed frame shape, (H, W*C) rows of interleaved pixels: a raw
    row-major RGB frame is this layout already, and ``image(frame,
    channels=C)`` reads it with no copy (``ops.memory.ImageRead.packed_channels``)."""
    return (height, width * channels)


class FrameLoader:
    """Iterate the frames of a raw frame-sequence file, prefetched natively.

    ``shape`` and ``dtype`` describe one frame's payload (``frame_shape_nv12(w,
    h)`` and uint8 for NV12, ``(h, w, 3)`` and uint8 for RGB). Yields
    zero-copy numpy views of ring slots; a yielded frame's memory is recycled
    at the next iteration.
    """

    def __init__(self, path: str, shape, dtype=np.uint8, ring_depth: int = 4):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self.ring_depth = ring_depth
        self._lib = _load_native()
        self._handle = None
        self._pending = None
        if self._lib is not None:
            self._handle = self._lib.flv_open(path.encode(), self.frame_bytes, ring_depth)
            if not self._handle:
                raise OSError(self._lib.flv_last_error().decode())
            self.num_frames = int(self._lib.flv_frame_count(self._handle))
        else:  # the numpy reader
            self._file = open(path, "rb")
            self._file.seek(0, 2)
            self.num_frames = self._file.tell() // self.frame_bytes
            self._file.seek(0)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is not None:
            if self._pending is not None:
                self._lib.flv_release(self._handle, self._pending)
                self._pending = None
            idx = ctypes.c_int64()
            ptr = self._lib.flv_next(self._handle, ctypes.byref(idx))
            if not ptr:
                raise StopIteration
            self._pending = ptr
            arr = np.ctypeslib.as_array(ptr, shape=(self.frame_bytes,))
            return arr.view(self.dtype).reshape(self.shape)
        buf = self._file.read(self.frame_bytes)
        if len(buf) < self.frame_bytes:
            raise StopIteration
        return np.frombuffer(buf, self.dtype).reshape(self.shape)

    def close(self):
        if self._handle is not None:
            if self._pending is not None:
                self._lib.flv_release(self._handle, self._pending)
                self._pending = None
            self._lib.flv_close(self._handle)
            self._handle = None
        elif getattr(self, "_file", None):
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
