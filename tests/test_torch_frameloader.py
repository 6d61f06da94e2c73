"""The port's frame loader: ``tests/test_frameloader.py``'s loader cases, with
the native prefetch ring (compiled from ``native/frameloader.cpp`` at first
use) and with the numpy reader, each against the file's own bytes and the
reference's loader."""

import numpy as np
import pytest

import cvgpuspeedup_tpu_torch as T
from conftest import check_exact
from cvgpuspeedup_tpu.utils import frameloader as JF
from cvgpuspeedup_tpu_torch.utils import frameloader as TF
from cvgpuspeedup_tpu_torch.utils.frameloader import (FrameLoader, frame_shape_nv12,
                                                      frame_shape_packed)

H, W = 32, 64
NFRAMES = 9


@pytest.fixture(scope="module")
def nv12_file(tmp_path_factory):
    rng = np.random.default_rng(5)
    path = tmp_path_factory.mktemp("frames") / "stream.nv12"
    frames = rng.integers(0, 256, (NFRAMES,) + frame_shape_nv12(W, H)).astype(np.uint8)
    path.write_bytes(frames.tobytes())
    return str(path), frames


@pytest.fixture(params=["native", "numpy"])
def reader(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(TF, "_lib", None)
        monkeypatch.setattr(TF, "_lib_tried", True)
    return request.param


def test_native_lib_builds_into_the_build_directory(nv12_file):
    path, _ = nv12_file
    with FrameLoader(path, frame_shape_nv12(W, H)) as fl:
        assert fl.native, "the C++ loader must build here (a host compiler is present)"
    lib = TF.library_path()
    assert lib.exists() and lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert TF.SOURCE.name == "frameloader.cpp" and "native" in TF.SOURCE.parts
    assert lib.name != "libframeloader.so"  # the committed library is neither loaded nor written


def test_shapes_are_the_references():
    for w, h in ((64, 32), (1920, 1080), (6, 4)):
        assert frame_shape_nv12(w, h) == JF.frame_shape_nv12(w, h)
        for c in (1, 3, 4):
            assert frame_shape_packed(w, h, c) == JF.frame_shape_packed(w, h, c)


def test_iterates_all_frames_in_order(nv12_file, reader):
    path, frames = nv12_file
    with FrameLoader(path, frame_shape_nv12(W, H), ring_depth=3) as fl:
        assert fl.native == (reader == "native") and fl.num_frames == NFRAMES
        with JF.FrameLoader(path, frame_shape_nv12(W, H), ring_depth=3) as ref:
            for k, (frame, want) in enumerate(zip(fl, ref, strict=True)):
                check_exact(frame, frames[k], f"frame {k}")
                check_exact(frame, want, f"frame {k} against the reference's loader")
        assert k == NFRAMES - 1


def test_frames_feed_a_pipeline(nv12_file, reader):
    path, frames = nv12_file
    convert = T.convert_yuv_to_rgb(standard=T.ColorStandard.BT709)
    with FrameLoader(path, frame_shape_nv12(W, H)) as fl:
        outs = [T.execute_operations(T.read_yuv(frame), convert, device="cpu").numpy()
                for frame in fl]
    assert len(outs) == NFRAMES and outs[0].shape == (H, W, 3)
    for k in (0, NFRAMES - 1):
        check_exact(outs[k], T.execute_operations(T.read_yuv(frames[k]), convert,
                                                  device="cpu").numpy(), "loader frame -> pipeline")


def test_truncated_tail_dropped(tmp_path, reader):
    shape = frame_shape_nv12(W, H)
    data = np.random.default_rng(1).integers(0, 256, (2,) + shape).astype(np.uint8)
    path = tmp_path / "trunc.nv12"
    path.write_bytes(data.tobytes() + b"\x00" * 17)  # a partial frame at the end
    with FrameLoader(str(path), shape) as fl:
        assert fl.num_frames == 2 and len(list(fl)) == 2


def test_other_dtypes_and_a_missing_file(tmp_path, reader):
    data = np.random.default_rng(2).integers(0, 60000, (3, 4, 6, 3)).astype(np.uint16)
    path = tmp_path / "stream.u16"
    path.write_bytes(data.tobytes())
    with FrameLoader(str(path), (4, 6, 3), np.uint16, ring_depth=1) as fl:
        assert fl.frame_bytes == 4 * 6 * 3 * 2
        got = [f.copy() for f in fl]
    assert len(got) == 3 and got[2].dtype == np.uint16
    check_exact(got[2], data[2], "uint16 frame")
    with pytest.raises(OSError):
        FrameLoader(str(tmp_path / "absent.raw"), (4, 6, 3))


def test_no_compiler_gives_the_numpy_reader(nv12_file, monkeypatch, tmp_path):
    """Where the library is not built yet and no compiler is found, the
    loader reads with numpy; ``.native`` says so."""
    path, frames = nv12_file
    monkeypatch.setattr(TF, "_lib", None)
    monkeypatch.setattr(TF, "_lib_tried", False)
    monkeypatch.setattr(TF, "BUILD_DIR", tmp_path / "nothing-built")
    monkeypatch.setattr(TF, "find_cxx", lambda: None)
    with FrameLoader(path, frame_shape_nv12(W, H)) as fl:
        assert not fl.native
        check_exact(list(fl)[3], frames[3], "numpy reader frame 3")
    monkeypatch.setattr(TF, "_lib_tried", False)  # the next loader looks again
