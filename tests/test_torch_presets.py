"""The preset pipelines of the port against the JAX package's and OpenCV:
``tests/test_pipelines.py``'s three cases and the two ``video_stream`` cases
of ``tests/test_frameloader.py``, each from one numpy seed through both
packages. The port runs with ``device="cpu"``; against the reference's XLA
path float outputs agree within 1e-4 (uint8 within 1: XLA contracts the
lerps and the YUV sums into FMAs on the CPU), against cv2 within the repo's
1e-4.
"""

import inspect

import cv2
import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from conftest import check_float
from cvgpuspeedup_tpu.pipelines import presets as JP
from cvgpuspeedup_tpu_torch.pipelines import presets as TP
from cvgpuspeedup_tpu_torch.utils.frameloader import frame_shape_nv12


@pytest.mark.parametrize("name", ["detection_preprocessor", "temporal_window", "video_stream",
                                  "camera_pipeline"])
def test_constructor_signatures_are_the_references_plus_device(name):
    ref = inspect.signature(getattr(JP, name).__init__).parameters
    port = inspect.signature(getattr(TP, name).__init__).parameters
    assert list(port) == [*ref, "device"] and port["device"].default is None
    for k, p in ref.items():
        if isinstance(p.default, (int, float, str, bool, tuple, type(None))):
            assert port[k].default == p.default, k
        else:  # an enum or a Size of the other package: the same name
            assert getattr(port[k].default, "name", port[k].default) == getattr(
                p.default, "name", p.default), k


def test_detection_preprocessor():
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[i, i, 60, 120] for i in range(8)], np.int32)
    args = dict(mean=(127.5,) * 3, scale=(128.0,) * 3)
    out = TP.detection_preprocessor(dsize=T.Size(64, 128), device="cpu", **args)(
        frame, rects, used_planes=8)
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (8, 3, 128, 64)
    crop = frame[2:122, 2:62].astype(np.float32)
    ref = (cv2.resize(crop, (64, 128)) - 127.5) / 128.0
    check_float(out[2].numpy(), ref.transpose(2, 0, 1), msg="preset plane 2")
    want = np.asarray(JP.detection_preprocessor(dsize=J.Size(64, 128), backend=J.ParBackend.XLA,
                                                **args)(frame, rects, used_planes=8))
    check_float(out.numpy(), want, msg="against the reference's preset")
    ragged = TP.detection_preprocessor(dsize=T.Size(64, 128), background=5.0, device="cpu")(
        frame, rects, used_planes=3)
    assert float(ragged[3:].min()) == float(ragged[3:].max()) == 5.0


@pytest.mark.parametrize("planes", list(T.ColorPlanes), ids=lambda p: p.name)
@pytest.mark.parametrize("order", list(T.CircularTensorOrder), ids=lambda o: o.name)
def test_temporal_window(order, planes):
    tw = TP.temporal_window(window=3, dsize=T.Size(16, 8), order=order, planes=planes,
                            device="cpu")
    ref = JP.temporal_window(window=3, dsize=J.Size(16, 8), order=J.CircularTensorOrder[order.name],
                             planes=J.ColorPlanes[planes.name])
    rng = np.random.default_rng(2)
    for k in range(5):
        frame = rng.integers(0, 256, (32, 64, 3)).astype(np.uint8)
        t = tw.push(frame)
        want = np.asarray(ref.push(frame))
    assert tuple(t.shape) == want.shape
    check_float(t.numpy(), want, msg="window against the reference's")
    assert torch.equal(tw.tensor, t)


def test_temporal_window_holds_the_newest_frames_first():
    tw = TP.temporal_window(window=3, dsize=T.Size(16, 8), device="cpu")
    for k in range(5):
        t = tw.push(np.full((32, 64, 3), (k + 1) * 10, np.uint8))
    assert tuple(t.shape) == (3, 3, 8, 16)
    for z, k in enumerate([5, 4, 3]):
        check_float(t[z].numpy(), np.full((3, 8, 16), k * 10 / 255.0), msg=f"window z={z}")


@pytest.mark.parametrize("alpha", [True, False])
@pytest.mark.parametrize("out_size", [(32, 16), None])
@pytest.mark.parametrize("fmt", ["NV12", "NV21"])
def test_camera_pipeline(fmt, out_size, alpha):
    h, w = 32, 64
    buf = np.random.default_rng(3).integers(0, 256, (h * 3 // 2, w)).astype(np.uint8)
    cam = TP.camera_pipeline(out_size=out_size and T.Size(*out_size), alpha=alpha,
                             pixel_format=T.PixelFormat[fmt], device="cpu")
    ref = JP.camera_pipeline(out_size=out_size and J.Size(*out_size), alpha=alpha,
                             pixel_format=J.PixelFormat[fmt])
    out, want = cam(buf).numpy(), np.asarray(ref(buf))
    oh, ow = (out_size[1], out_size[0]) if out_size else (h, w)
    assert out.shape == want.shape == (oh, ow, 4 if alpha else 3) and out.dtype == np.uint8
    if alpha:
        assert np.all(out[..., 3] == 255)
    assert np.abs(out.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_video_stream_preset(tmp_path):
    """video_stream: a raw packed-RGB file through the loader, packed
    ingestion, resize, normalization and split per frame, against cv2 and the
    reference's preset."""
    rng = np.random.default_rng(11)
    w, h, n = 64, 32, 4
    frames = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    path = tmp_path / "stream.rgb"
    path.write_bytes(frames.tobytes())
    mean, scale = (0.4, 0.5, 0.6), (0.2, 0.3, 0.4)
    stream = TP.video_stream(str(path), w, h, dsize=T.Size(32, 16), mean=mean, scale=scale,
                             device="cpu")
    assert stream.loader.native
    outs = [o.numpy().copy() for o in stream]
    assert len(outs) == n and outs[0].shape == (3, 16, 32)
    ref = [np.asarray(o) for o in JP.video_stream(str(path), w, h, dsize=J.Size(32, 16), mean=mean,
                                                  scale=scale, backend=J.ParBackend.XLA)]
    for k, o in enumerate(outs):
        r = cv2.resize(frames[k].astype(np.float32), (32, 16), interpolation=cv2.INTER_LINEAR)
        want = ((r / np.float32(255.0)) - np.float32(mean)) / np.float32(scale)
        check_float(o, want.transpose(2, 0, 1), tol=1e-5, msg=f"stream frame {k}")
        check_float(o, ref[k], tol=1e-5, msg=f"stream frame {k} against the reference")


def test_video_stream_preset_nv12(tmp_path):
    rng = np.random.default_rng(12)
    w, h, n = 64, 32, 3
    bufs = rng.integers(0, 256, (n,) + frame_shape_nv12(w, h)).astype(np.uint8)
    path = tmp_path / "stream.nv12"
    path.write_bytes(bufs.tobytes())
    stream = TP.video_stream(str(path), w, h, fmt="nv12", dsize=T.Size(32, 16), device="cpu")
    outs = [o.numpy().copy() for o in stream]
    assert len(outs) == n and outs[0].shape == (3, 16, 32)
    ref = [np.asarray(o) for o in JP.video_stream(str(path), w, h, fmt="nv12",
                                                  dsize=J.Size(32, 16), backend=J.ParBackend.XLA)]
    for k, o in enumerate(outs):
        # the port's own unfused path per frame: convert, then resize
        rgb = T.execute_operations(T.read_yuv(bufs[k]), T.convert_yuv_to_rgb(out_dtype=np.float32),
                                   device="cpu")
        want = T.execute_operations(T.resize(T.image(rgb), T.Size(32, 16)),
                                    T.convert_to(np.float32, alpha=1 / 255.0), T.split_tensor(),
                                    device="cpu")
        check_float(o, want.numpy(), tol=1e-4, msg=f"nv12 stream frame {k}")
        check_float(o, ref[k], tol=1e-4, msg=f"nv12 stream frame {k} against the reference")


def test_presets_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    frame = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.detection_preprocessor(dsize=T.Size(8, 8))(frame, np.array([[0, 0, 8, 8]], np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.temporal_window(window=2, dsize=T.Size(8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.camera_pipeline()(np.zeros((12, 8), np.uint8))
