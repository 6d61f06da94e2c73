"""The port's examples (``cvgpuspeedup_tpu_torch/examples``) on the CPU
(``--device cpu``): each prints what the reference's example prints, and its
outputs equal the reference example's pipelines, built with the JAX
package's factories from the same seeded inputs and lowered op by op
outside jit: uint8 bit for bit, float32 within 1e-4."""

import contextlib
import io
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
from cvgpuspeedup_tpu_torch.examples import (detection_preprocessing, nv12_camera_stream,
                                             temporal_window_slam)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4


def _assert_matches(port, ref, what):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (
        f"{what}: {port.shape} {port.dtype} vs {ref.shape} {ref.dtype}")
    if port.dtype == np.uint8:
        assert np.array_equal(port, ref), f"{what}: uint8 values differ"
    else:
        d = float(np.abs(port.astype(np.float64) - ref.astype(np.float64)).max())
        assert d <= F32_TOL, f"{what}: max |diff| {d}"


def _run(example):
    """The port's example on the CPU: ``(what it printed, its outputs)``."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        outs = example.main(["--device", "cpu"])
    return printed.getvalue(), outs


@pytest.mark.parametrize("example", [detection_preprocessing, nv12_camera_stream,
                                     temporal_window_slam], ids=lambda m: m.__name__)
def test_prints_what_the_reference_example_prints(example):
    name = example.__name__.rsplit(".", 1)[-1]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    assert _run(example)[0] == printed.getvalue()


def test_detection_preprocessing_equals_the_reference():
    _, outs = _run(detection_preprocessing)
    frame, rects = detection_preprocessing.inputs()
    for key, r, used in (("out", rects, 20), ("out2", rects + 3, 17)):
        ref = J.build_pipeline(*detection_preprocessing.ops(J, frame, r, used)).lower()
        _assert_matches(outs[key], ref, key)


def test_nv12_camera_stream_equals_the_reference():
    _, outs = _run(nv12_camera_stream)
    frames = nv12_camera_stream.frames()
    assert len(outs["frames"]) == len(frames) == 8
    for k, (got, nv12) in enumerate(zip(outs["frames"], frames)):
        _assert_matches(got, J.build_pipeline(*nv12_camera_stream.ops(J, nv12)).lower(),
                        f"frame {k}")


def test_temporal_window_slam_equals_the_reference():
    _, outs = _run(temporal_window_slam)
    window_in, ring_in = temporal_window_slam.window_frames()

    def planar(ops):
        return np.asarray(J.build_pipeline(*ops, J.split_tensor()).lower())

    # NEWEST_FIRST: logical plane i is the frame pushed i pushes ago
    want = np.stack([planar((J.resize(J.image(window_in[-1 - i]), J.Size(320, 192)),
                             J.convert_to(np.float32, alpha=1 / 255.0)))
                     for i in range(temporal_window_slam.K)])
    _assert_matches(outs["window"], want, "window")
    # OLDEST_FIRST and TRANSPOSED: (C, N, H, W), the last 8 of 10 frames oldest first
    want = np.stack([planar(temporal_window_slam.ring_ops(J, f)) for f in ring_in[2:]], axis=1)
    _assert_matches(outs["ring"], want, "ring")
    assert isinstance(outs["ring"], torch.Tensor) and outs["ring"].device.type == "cpu"
