#!/usr/bin/env python
"""Example: detection preprocessing — N crops of one frame, ONE fused kernel.

The reference's flagship scenario: an object detector yields N boxes per
video frame; each box must be cropped, resized to the classifier input,
normalized, and laid out planar. Classic per-op libraries launch 5 kernels
per box; this runs the whole batch as one launch of the batched crop-resize
kernel.

    python -m cvgpuspeedup_tpu_torch.examples.detection_preprocessing [--device cpu]
"""

import numpy as np

import cvgpuspeedup_tpu_torch as cvgs

from . import _args

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def inputs():
    """A 1080p frame and 20 detections with different sizes."""
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (1080, 1920, 3)).astype(np.uint8)
    rects = np.array([[40 * i, 30 * i, 60 + (i % 5) * 8, 120 + (i % 3) * 10] for i in range(20)],
                     np.int32)
    return frame, rects


def ops(f, frame, rects, used):
    """The pipeline, built with the factories of ``f``."""
    return (f.resize_batch(frame, rects=rects, dsize=f.Size(64, 128), used_planes=used,
                           background=114.0,                  # letterbox gray
                           aspect_ratio=f.AspectRatio.PRESERVE_AR),
            f.convert_to(np.float32, alpha=1 / 255.0),
            f.subtract(MEAN),                                 # ImageNet mean
            f.divide(STD),                                    # ImageNet std
            f.split_tensor())                                 # planar (N, C, H, W)


def main(argv=None):
    args = _args.parse(__doc__, argv)
    frame, rects = inputs()
    out = cvgs.execute_operations(*ops(cvgs, frame, rects, len(rects)), device=args.device)
    print("classifier input batch:", _args.shape(out), _args.dtype(out))
    # next frame: new boxes, the same plan (no rebuild)
    out2 = cvgs.execute_operations(*ops(cvgs, frame, rects + 3, 17), device=args.device)
    print("second frame (cache hit):", _args.shape(out2))
    return {"out": out, "out2": out2}


if __name__ == "__main__":
    main()
