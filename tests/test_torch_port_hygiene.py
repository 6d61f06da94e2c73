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
        assert "--use_fast_math" not in joined and "-use_fast_math" not in joined
        assert "-c" in cmd and str(src) in cmd
    link = _build.link_command("nvcc", [Path("a.o"), Path("b.o")], Path("out.so"))
    assert "-shared" in link and "a.o" in link and "b.o" in link


@pytest.mark.parametrize("name,replaces", [
    ("batch_resize.cu", "pallas_backend.py::_emit_batch_resize"),
    ("frame_resize.cu", "pallas_frame.py::_emit_frame_resize"),
    ("warp.cu", "pallas_warp.py::_emit_warp"),
    ("warp.cu", "pallas_warp_general.py::_emit"),
    ("warp.cu", "pallas_warp_universal.py::_emit"),
    ("warp.cu", "pallas_warp_universal.py::_emit_batch"),
    ("divergent.cu", "pallas_divergent.py::_emit"),
    ("pointwise.cu", "cvgpuspeedup_tpu/exec/executor.py"),  # the jitted XLA program: no Pallas kernel
])
def test_cuda_source_exists_and_ships_as_package_data(name, replaces):
    src = ROOT / "cvgpuspeedup_tpu_torch" / "csrc" / name
    assert src.is_file() and src in _build.SOURCES
    text = src.read_text()
    assert replaces in text
    # the source with the headers it includes: the samplers live in headers
    included = [h for h in _build.HEADERS if f'#include "{h.name}"' in text]
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
    ("batch_resize.cuh", ("batch_resize.cu", "divergent.cu")),
    ("frame_resize.cuh", ("frame_resize.cu", "divergent.cu")),
    ("warp.cuh", ("warp.cu", "divergent.cu")),
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
    share chain.cuh's run_chain, which no longer holds the wide table."""
    csrc = ROOT / "cvgpuspeedup_tpu_torch" / "csrc"
    assert '#include "frame_resize.cuh"' in (csrc / "pointwise.cuh").read_text()
    pointwise = (csrc / "pointwise.cu").read_text()
    assert "yuv_to_rgb(" in pointwise
    assert "stage_rows(" in pointwise and "run_rows(" in pointwise and "run_chain" not in pointwise
    assert "kWide" not in (csrc / "chain.cuh").read_text()
    for other in ("batch_resize.cu", "frame_resize.cu", "warp.cu", "divergent.cu"):
        text = (csrc / other).read_text()
        assert "run_chain(" in text and "run_rows(" not in text


def test_the_native_loader_builds_beside_the_kernels():
    from cvgpuspeedup_tpu_torch.utils import frameloader

    assert frameloader.BUILD_DIR == ROOT / "build" / "native"
    assert frameloader.SOURCE == ROOT / "native" / "frameloader.cpp"
    cmd = frameloader.compile_command("c++", Path("out.so"))
    assert "-shared" in cmd and "-fPIC" in cmd and str(frameloader.SOURCE) in cmd
    assert "libframeloader.so" not in " ".join(cmd)
