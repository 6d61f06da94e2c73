"""A resize of a crop that overhangs its frame, on the CPU: which of the
reference's two paths the port follows.

The reference's op-by-op lowering (``Pipeline.lower()``) starts a crop as
``jax.lax.dynamic_slice`` does (``cvgpuspeedup_tpu/ops/crop.py:45-47``: a
negative origin counts from the far edge, then the start clamps so that
the window stays in the frame). Its jitted XLA path does not keep that for
a crop under a resize: XLA rewrites a phase of ``_resize_axis_static``'s
strided slices (``cvgpuspeedup_tpu/ops/resize.py:208``) over the
``dynamic_slice`` into a one-column slice whose start clamps to the frame,
not to the window, so on the column axis it reads past the crop (up to 220
on 0..255 here); on the row axis the two agree. The port follows the
lowering: its eager path and the composed kernel's plain version equal it
bit for bit, one-level, nested (a crop of a downscale resized) and as a
plane of a ``batch_read`` of planes of their own geometry; K1's rects
(``resize_batch``, ``BatchResizeRead``) past the frame's edges equal it
too, and there the XLA path agrees. Each case also asserts what the XLA
path does, so that a jax upgrade that changes it shows up here.
``chip_smoke.py`` phase 3 holds the kernels against their plain versions on
the same trees at full width.
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax

CPU = torch.device("cpu")
#: a 33x9 crop past the right edge of a 50-wide frame, a 20x30 one past the
#: bottom of a 40-high one, a 33x9 one from x = -4 (from the far edge, then
#: clamped); the XLA path reads past the crop on the column axis alone
EDGES = {"right": ((18, 4, 33, 9), True), "bottom": ((3, 20, 20, 30), False),
         "negative": ((-4, 4, 33, 9), True)}
TREES = ("one_level", "nested", "mixed_plane", "k1_rects")
DST = (16, 16)


def _frames():
    rng = np.random.default_rng(21)
    return (rng.integers(0, 256, (40, 50, 3), dtype=np.uint8),
            rng.integers(0, 256, (44, 60, 3), dtype=np.uint8))


def _ops(M, tree: str, rect):
    img, other = _frames()
    dst, r = M.Size(*DST), M.Rect(*rect)
    if tree == "one_level":
        read = M.resize(M.crop(M.image(img), r), dst)
    elif tree == "nested":  # a crop of a downscale of the other frame to 50x40
        read = M.resize(M.crop(M.resize(M.image(other), M.Size(50, 40)), r), dst)
    elif tree == "mixed_plane":  # beside a plane of another crop size
        read = M.batch_read([M.resize(M.crop(M.image(img), r), dst),
                             M.resize(M.crop(M.image(other), M.Rect(1, 1, 20, 15)), dst)])
    else:
        read = M.resize_batch(img, rects=np.array([rect], np.int32), dsize=dst)
    return (read, M.write_tensor() if tree in ("mixed_plane", "k1_rects") else M.write())


def _array(out):
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("edge", list(EDGES))
def test_the_port_follows_the_lowering(edge, tree):
    rect, xla_reads_past = EDGES[edge]
    jops = _ops(J, tree, rect)
    jp = J.build_pipeline(*jops)
    p = from_jax(jp)
    lowered = _array(jp.lower())
    eager = _array(T.execute_operations(p.read, *p.compute, p.write, device="cpu"))
    if tree == "k1_rects":
        plain = _array(kbr.run(p, kbr.build_plan(p), CPU))
    else:
        plan = kc.build_plan(p)
        assert bool(plan.core2) == (tree == "nested")
        assert (plan.word("batch") == kc.MIXED) == (tree == "mixed_plane")
        plain = _array(kc.run(p, plan, CPU))
    assert lowered.dtype == np.float32 and plain.shape == lowered.shape
    np.testing.assert_array_equal(eager.view(np.int32), lowered.view(np.int32))
    np.testing.assert_array_equal(plain.view(np.int32), lowered.view(np.int32))
    xla = _array(J.execute_operations(*jops, backend=J.ParBackend.XLA))
    gap = float(np.abs(xla.astype(np.float64) - lowered).max())
    if xla_reads_past and tree != "k1_rects":
        assert gap > 100.0, gap  # the XLA path reads past the crop
    else:
        assert gap <= 1e-4 * 255, gap
