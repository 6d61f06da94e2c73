#!/usr/bin/env python
"""Example: NV12 camera stream -> fused convert+resize ("ComputeWhatYouSee").

Mirrors the reference's 6K NV12 scenario: the YUV->RGB conversion happens
*inside* the fused read, so only the pixels the resize samples are
converted, in one launch of the full-frame resize kernel per frame. Frames
stream through the native C++ prefetch ring (``utils/frameloader.py``).

    python -m cvgpuspeedup_tpu_torch.examples.nv12_camera_stream [--device cpu]
"""

import os
import tempfile

import numpy as np

import cvgpuspeedup_tpu_torch as cvgs
from cvgpuspeedup_tpu_torch.utils.frameloader import FrameLoader, frame_shape_nv12

from . import _args

W, H = 1280, 720


def frames() -> np.ndarray:
    """A short synthesized NV12 stream (a deployment points at a camera ring
    buffer or a capture file)."""
    rng = np.random.default_rng(1)
    return rng.integers(0, 256, (8,) + frame_shape_nv12(W, H)).astype(np.uint8)


def ops(f, nv12):
    """One frame's pipeline, built with the factories of ``f``."""
    return (f.resize(f.fuse(f.read_yuv(nv12),
                            f.convert_yuv_to_rgb(standard=f.ColorStandard.BT709,
                                                 color_range=f.ColorRange.LIMITED,
                                                 out_dtype=np.float32)),
                     f.Size(640, 360)),
            f.convert_to(np.uint8))


def main(argv=None):
    args = _args.parse(__doc__, argv)
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "camera.nv12")
        with open(path, "wb") as fh:
            fh.write(frames().tobytes())
        with FrameLoader(path, frame_shape_nv12(W, H), ring_depth=4) as loader:
            print(f"native loader: {loader.native}, {loader.num_frames} frames")
            for k, nv12 in enumerate(loader):
                rgb_small = cvgs.execute_operations(*ops(cvgs, nv12.copy()), device=args.device)
                outs.append(rgb_small)
                if k == 0:
                    print("fused NV12->RGB->resize output:", _args.shape(rgb_small),
                          _args.dtype(rgb_small))
    print("stream done")
    return {"frames": outs}


if __name__ == "__main__":
    main()
