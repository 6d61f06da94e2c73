#!/usr/bin/env python
"""Example: CircularTensor temporal window for a SLAM / temporal-model
front-end.

The reference's CircularTensor scenario: a temporal network consumes the
last K frames, preprocessed and stacked planar. Each incoming frame is
resized and normalized into the next slot of the ring in ONE launch, the
ring updated in place.

    python -m cvgpuspeedup_tpu_torch.examples.temporal_window_slam [--device cpu]
"""

import numpy as np

import cvgpuspeedup_tpu_torch as cvgs
from cvgpuspeedup_tpu_torch.pipelines.presets import temporal_window

from . import _args

K = 15  # the reference demos a 15-frame window


def window_frames():
    rng = np.random.default_rng(2)
    window = [rng.integers(0, 256, (480, 800, 3)).astype(np.uint8) for _ in range(20)]
    ring = [rng.integers(0, 256, (128, 128, 3)).astype(np.uint8) for _ in range(10)]
    return window, ring


def ring_ops(f, frame):
    """One update of the raw ring, built with the factories of ``f``."""
    return (f.resize(f.image(frame), f.Size(64, 64)),
            f.convert_to(np.float32, alpha=2.0, beta=-1.0))


def main(argv=None):
    args = _args.parse(__doc__, argv)
    window_in, ring_in = window_frames()
    window = temporal_window(window=K, dsize=cvgs.Size(320, 192), alpha=1 / 255.0,
                             order=cvgs.CircularTensorOrder.NEWEST_FIRST,
                             planes=cvgs.ColorPlanes.STANDARD,   # (K, C, H, W): the model's input
                             device=args.device)
    for frame in window_in:
        tensor = window.push(frame)
    print("temporal stack:", _args.shape(tensor), _args.dtype(tensor))  # (15, 3, 192, 320)

    # the same ring with raw op control (order/layout variants, custom chains)
    ring = cvgs.CircularTensor(width=64, height=64, channels=3, batch=8,
                               order=cvgs.CircularTensorOrder.OLDEST_FIRST,
                               planes=cvgs.ColorPlanes.TRANSPOSED, device=args.device)
    for frame in ring_in:
        ring.update(*ring_ops(cvgs, frame))
    print("transposed ring:", _args.shape(ring.tensor))  # (3, 8, 64, 64)
    return {"window": tensor, "ring": ring.tensor}


if __name__ == "__main__":
    main()
