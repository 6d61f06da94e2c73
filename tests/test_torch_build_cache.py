"""The object keys of ``tools/kernel_variants.py`` (``object_key``), under
which it keeps each variant's objects so that a variant compiles only the
sources it changes: a source's key follows the source, every header it
includes by name, transitively, and the compile command, and nothing else.
No compiler needed."""

import importlib.util
from pathlib import Path

from cvgpuspeedup_tpu_torch.exec import _build

_spec = importlib.util.spec_from_file_location(
    "kernel_variants", _build.PACKAGE_DIR.parent / "tools" / "kernel_variants.py")
kv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kv)


def _tree(tmp: Path) -> Path:
    (tmp / "a.cu").write_text('#include "x.cuh"\n#include <cstdio>\nint a;\n')
    (tmp / "x.cuh").write_text('#include "y.cuh"\nint x;\n')
    (tmp / "y.cuh").write_text("int y;\n")
    (tmp / "z.cuh").write_text("int z;\n")
    return tmp / "a.cu"


def test_a_source_includes_its_headers_transitively(tmp_path):
    src = _tree(tmp_path)
    assert kv.included(src, []) == [tmp_path / "x.cuh", tmp_path / "y.cuh"]
    real = _build.PACKAGE_DIR / "csrc" / "divergent_split_any.cu"
    names = {h.name for h in kv.included(real, [])}
    assert {"divergent_split.cuh", "composed_nested.cuh", "composed.cuh", "chain.cuh",
            "divergent_kernel.cuh"} <= names and "pointwise.cu" not in names


def test_the_key_follows_what_the_object_is_built_from(tmp_path):
    src = _tree(tmp_path)
    command = _build.compile_command
    key = kv.object_key(src, command)
    (tmp_path / "z.cuh").write_text("int z2;\n")  # not included: the same object
    assert kv.object_key(src, command) == key
    (tmp_path / "y.cuh").write_text("int y2;\n")  # included through x.cuh
    moved = kv.object_key(src, command)
    assert moved != key
    assert kv.object_key(src, lambda *a: [f for f in command(*a) if f != "-ftz=true"]) != moved
