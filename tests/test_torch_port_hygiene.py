"""Rules of the port that no numerics test shows: it never imports jax, its
kernels are built for Hopper without FMA contraction or fast math, and their
CUDA sources and headers ship with the package."""

import fnmatch
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

from cvgpuspeedup_tpu_torch.exec import _build

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    code = (
        "import sys, cvgpuspeedup_tpu_torch, cvgpuspeedup_tpu_torch.interop.from_jax, "
        "cvgpuspeedup_tpu_torch.utils.profiling, cvgpuspeedup_tpu_torch.exec.cuda_frame_resize, "
        "cvgpuspeedup_tpu_torch.ops.nv12, cvgpuspeedup_tpu_torch.ops.color, "
        "cvgpuspeedup_tpu_torch.exec.cuda_warp, cvgpuspeedup_tpu_torch.ops.warp, "
        "cvgpuspeedup_tpu_torch.exec.cuda_divergent, cvgpuspeedup_tpu_torch.ops.crop, "
        "cvgpuspeedup_tpu_torch.ops.border, cvgpuspeedup_tpu_torch.data.circular_tensor, "
        "cvgpuspeedup_tpu_torch.exec.cuda_pointwise, cvgpuspeedup_tpu_torch.pipelines.presets, "
        "cvgpuspeedup_tpu_torch.exec.cuda_composed, "
        "cvgpuspeedup_tpu_torch.interop.cv2_compat, cvgpuspeedup_tpu_torch.utils.frameloader, "
        "cvgpuspeedup_tpu_torch.parallel.mesh, cvgpuspeedup_tpu_torch.utils.bounds, "
        "cvgpuspeedup_tpu_torch.benchmarks.vertical_fusion, "
        "cvgpuspeedup_tpu_torch.benchmarks.aux_pipelines, "
        "cvgpuspeedup_tpu_torch.benchmarks.host_overhead, "
        "cvgpuspeedup_tpu_torch.benchmarks.scaling, "
        "cvgpuspeedup_tpu_torch.examples.detection_preprocessing, "
        "cvgpuspeedup_tpu_torch.examples.nv12_camera_stream, "
        "cvgpuspeedup_tpu_torch.examples.temporal_window_slam; "
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'cvgpuspeedup_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


_FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|cv2|cvgpuspeedup_tpu)\b", re.M)


def test_port_sources_import_neither_jax_nor_cv2():
    paths = [ROOT / "chip_smoke.py", *(ROOT / "cvgpuspeedup_tpu_torch").rglob("*.py")]
    for sub in ("benchmarks", "examples", "utils/bounds.py"):  # the subpackages' own files too
        assert any(str(p.relative_to(ROOT)).startswith(f"cvgpuspeedup_tpu_torch/{sub}")
                   for p in paths), sub
    for path in paths:
        assert not _FORBIDDEN_IMPORT.search(path.read_text()), path


def test_chip_smoke_fails_without_a_card(tmp_path):
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_nvcc_command_targets_hopper_without_fast_math():
    for src in _build.SOURCES:
        cmd = _build.compile_command("nvcc", src, Path("out.o"))
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined
        assert "-fmad=false" in cmd
        assert "-ftz=true" in cmd  # float32 subnormals flushed, as the reference computes
        assert "--use_fast_math" not in joined and "-use_fast_math" not in joined
        assert "-c" in cmd and str(src) in cmd
    link = _build.link_command("nvcc", [Path("a.o"), Path("b.o")], Path("out.so"))
    assert "-shared" in link and "a.o" in link and "b.o" in link


def _included(text):
    """The headers a source includes, directly or through another header."""
    found, todo = [], [text]
    while todo:
        t = todo.pop()
        for h in _build.HEADERS:
            if f'#include "{h.name}"' in t and h not in found:
                found.append(h)
                todo.append(h.read_text())
    return found


@pytest.mark.parametrize("name,replaces", [
    ("batch_resize.cu", "pallas_backend.py::_emit_batch_resize"),
    ("frame_resize.cu", "pallas_frame.py::_emit_frame_resize"),
    ("warp.cu", "pallas_warp.py::_emit_warp"),
    ("warp.cu", "pallas_warp_general.py::_emit"),
    ("warp.cu", "pallas_warp_universal.py::_emit"),
    ("warp.cu", "pallas_warp_universal.py::_emit_batch"),
    ("divergent.cu", "pallas_divergent.py::_emit"),
    ("pointwise.cu", "cvgpuspeedup_tpu/exec/executor.py"),  # the jitted XLA program: no Pallas kernel
    ("composed.cu", "cvgpuspeedup_tpu/exec/executor.py"),   # the same, for composed reads
    # the same program's merge, for a divergent batch split by plane
    ("divergent_split.cu", "cvgpuspeedup_tpu/exec/executor.py"),
])
def test_cuda_source_exists_and_ships_as_package_data(name, replaces):
    src = ROOT / "cvgpuspeedup_tpu_torch" / "csrc" / name
    assert src.is_file() and src in _build.SOURCES
    text = src.read_text()
    assert replaces in text
    # the source with the headers it includes: the samplers live in headers
    included = _included(text)
    assert any(h.name == "chain.cuh" or '#include "chain.cuh"' in h.read_text() for h in included)
    code = text + "".join(h.read_text() for h in included)
    assert "__fmul_rn" in code or "lerp_rn" in code
    header = ROOT / "cvgpuspeedup_tpu_torch" / "csrc" / "chain.cuh"
    assert header in _build.HEADERS and "__fdiv_rn" in header.read_text()
    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    setuptools = conf["tool"]["setuptools"]
    include = setuptools["packages"]["find"]["include"]
    assert any(fnmatch.fnmatchcase("cvgpuspeedup_tpu_torch.exec", p) for p in include)
    data = setuptools["package-data"]["cvgpuspeedup_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data


def test_library_is_keyed_on_the_sources(tmp_path, monkeypatch):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert path == _build.library_path()
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    # an edited header names another library, so it is rebuilt
    header = tmp_path / "chain.cuh"
    header.write_text(_build.HEADERS[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "HEADERS", [header])
    assert _build.library_path() != path


@pytest.mark.parametrize("header,users", [
    ("batch_resize.cuh", ("batch_resize_kernel.cuh", "divergent_kernel.cuh")),
    ("frame_resize.cuh", ("frame_resize_kernel.cuh", "divergent_kernel.cuh")),
    ("warp.cuh", ("warp_kernel.cuh", "divergent_kernel.cuh")),
    ("pointwise.cuh", ("pointwise.cu",)),
    ("pointwise_chain.cuh", ("pointwise.cuh",)),
])
def test_shared_samplers_live_in_headers(header, users):
    """Each coordinate rule exists once: the kernels that share a sampler
    include its header, and the library's hash covers it."""
    path = ROOT / "cvgpuspeedup_tpu_torch" / "csrc" / header
    assert path in _build.HEADERS
    text = path.read_text()
    assert "#pragma once" in text and '#include "chain.cuh"' in text
    for user in users:
        assert f'#include "{header}"' in (path.parent / user).read_text()


def test_the_pointwise_heads_share_the_frame_kernels_conversion():
    """One YUV -> RGB for the frame and pointwise kernels; the pointwise
    kernel stages its chain through its own interpreter, the other four
    share chain.cuh's run_chain (K1, K2, the warp kernel and K6 in the
    kernel headers their sources instantiate)."""
    csrc = ROOT / "cvgpuspeedup_tpu_torch" / "csrc"
    assert '#include "frame_resize.cuh"' in (csrc / "pointwise.cuh").read_text()
    pointwise = (csrc / "pointwise.cu").read_text()
    assert "yuv_to_rgb(" in pointwise
    assert "stage_rows(" in pointwise and "run_rows(" in pointwise and "run_chain" not in pointwise
    assert "kWide" not in (csrc / "chain.cuh").read_text()
    for other in ("batch_resize_kernel.cuh", "frame_resize_kernel.cuh", "warp_kernel.cuh",
                  "divergent_kernel.cuh"):
        text = (csrc / other).read_text()
        assert "run_chain(" in text and "run_rows(" not in text


def test_the_native_loader_builds_beside_the_kernels():
    from cvgpuspeedup_tpu_torch.utils import frameloader

    assert frameloader.BUILD_DIR == ROOT / "build" / "native"
    assert frameloader.SOURCE == ROOT / "native" / "frameloader.cpp"
    cmd = frameloader.compile_command("c++", Path("out.so"))
    assert "-shared" in cmd and "-fPIC" in cmd and str(frameloader.SOURCE) in cmd
    assert "libframeloader.so" not in " ".join(cmd)


@pytest.mark.parametrize("name,elem,short", [("int8", "int8_t", "i8"), ("uint16", "uint16_t", "u16"),
                                             ("int16", "int16_t", "i16"), ("float16", "f16", "f16"),
                                             ("int32", "int32_t", "i32")])
def test_each_source_type_has_a_translation_unit_of_its_own(name, elem, short):
    """K1, K2 and the warp kernel instantiate uint8 and float32 sources
    beside their C entry and every other source type in a file of its own,
    which the build compiles in a process of its own; each C entry sends
    that type's code to it."""
    csrc = ROOT / "cvgpuspeedup_tpu_torch" / "csrc"
    src = csrc / f"source_{name}.cu"
    assert src in _build.SOURCES
    assert f"CVGS_SOURCE({elem}, {short})" in src.read_text()
    code = {"int8": "PW_I8", "uint16": "PW_U16", "int16": "PW_I16", "float16": "PW_F16",
            "int32": "PW_I32"}[name]
    for kernel in ("batch_resize", "frame_resize", "warp"):
        entry = (csrc / f"{kernel}.cu").read_text()
        assert f"case {code}: cvgs::{kernel}_{short}(a);" in entry


#: the reference's modules whose public names the port carries, by the
#: port's module of the same path
PUBLIC_MODULES = ("", ".exec.executor", ".utils.dtypes", ".utils.profiling", ".utils.frameloader",
                  ".ops.arithmetic", ".ops.border", ".ops.cast", ".ops.color", ".ops.crop",
                  ".ops.memory", ".ops.nv12", ".ops.resize", ".ops.warp",
                  ".data.circular_tensor", ".interop.cv2_compat", ".parallel.mesh",
                  ".pipelines", ".pipelines.presets", ".graph", ".types")
#: the reference's public names the port replaces on purpose, and by what
REPLACED = {
    ".utils.profiling": {"transfer_sync", "differential_device_time",  # CUDA events, the profiler
                         "V5E_BF16_MACS", "V5E_HBM_BPS"},  # the H100's rates: utils/bounds.py
    ".ops.resize": {"axis_lerp_np"},  # axis_taps, the numpy form of axis_lerp
}


def _public_names(module):
    """A module's ``__all__``, else its names that do not start with ``_``
    and are no module."""
    import types

    names = getattr(module, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", module.__name__).split(".")[0] != "__future__"}


@pytest.mark.parametrize("path", PUBLIC_MODULES, ids=lambda p: p or "root")
def test_every_public_name_of_the_reference_has_a_counterpart(path):
    """Each public name of a module of the JAX package (its ``__all__``, or
    what it defines and imports under a public name) is a name of the
    port's module of the same path, but the deliberate replacements
    (``REPLACED``) and the Pallas emitters (``exec/pallas_*``, whose
    counterparts are the CUDA kernels)."""
    import importlib

    pytest.importorskip("jax")
    ref = importlib.import_module("cvgpuspeedup_tpu" + path)
    port = importlib.import_module("cvgpuspeedup_tpu_torch" + path)
    ref_names = {n for n in _public_names(ref)
                 if not getattr(getattr(ref, n), "__module__", "").startswith(
                     ("jax", "numpy", "enum", "typing", "dataclasses", "functools"))}
    missing = sorted(n for n in ref_names - REPLACED.get(path, set()) if not hasattr(port, n))
    assert not missing, f"cvgpuspeedup_tpu_torch{path} lacks {missing}"
    assert not {n for n in REPLACED.get(path, set()) if hasattr(port, n)}, "a replaced name is back"


def test_the_pallas_emitters_are_the_cuda_kernels():
    """The reference's ``exec/pallas_*`` modules have no module of the same
    name in the port: each has a kernel module (``exec/cuda_*``)."""
    ref = sorted(p.stem for p in (ROOT / "cvgpuspeedup_tpu" / "exec").glob("pallas_*.py"))
    port = {p.stem for p in (ROOT / "cvgpuspeedup_tpu_torch" / "exec").glob("*.py")}
    assert ref == ["pallas_backend", "pallas_divergent", "pallas_frame", "pallas_warp",
                   "pallas_warp_general", "pallas_warp_universal"]
    assert not port & set(ref)
    assert {"cuda_batch_resize", "cuda_divergent", "cuda_frame_resize", "cuda_warp",
            "cuda_pointwise"} <= port
