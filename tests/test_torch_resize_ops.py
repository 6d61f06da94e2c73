"""The port's coordinate and dtype helpers against the JAX package's.

``axis_lerp`` must give equal taps and bit-equal weights, including the
negative numerators of upscales and letterbox offsets (floor division);
``letterbox_geometry`` must be exact in all four aspect-ratio modes;
``saturate_cast`` and ``as_channel_vector`` must agree with the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvgpuspeedup_tpu.ops import resize as jresize
from cvgpuspeedup_tpu.types import AspectRatio as JAR, Size as JSize
from cvgpuspeedup_tpu.utils import dtypes as jdt
from cvgpuspeedup_tpu_torch.ops import resize as tresize
from cvgpuspeedup_tpu_torch.types import AspectRatio as TAR, Size as TSize
from cvgpuspeedup_tpu_torch.utils import dtypes as tdt


def _bits(w) -> np.ndarray:
    return np.asarray(w, np.float32).view(np.uint32)


@pytest.mark.parametrize("src,dst", [
    (60, 64), (120, 128), (30, 32), (64, 64), (640, 64), (100, 37), (37, 100),
    (1, 5), (2, 7), (7, 2), (5, 1), (1, 1), (3840, 64), (2, 128),
])
def test_axis_lerp_matches_reference(src, dst):
    # q runs past both ends, as letterbox offsets make it do
    q = np.arange(-dst - 3, 2 * dst + 3, dtype=np.int32)
    j0, j1, jw = jresize.axis_lerp(jnp.asarray(q), src, dst)
    t0, t1, tw = tresize.axis_lerp(torch.from_numpy(q), src, dst)
    assert np.array_equal(np.asarray(j0), t0.numpy())
    assert np.array_equal(np.asarray(j1), t1.numpy())
    assert np.array_equal(_bits(jw), _bits(tw.numpy()))
    assert tw.dtype == torch.float32 and t0.dtype == torch.int32


def test_axis_lerp_negative_numerator_takes_floor():
    # first column of the 60 -> 64 upscale: num = 60 - 64 < 0, so the left
    # tap is -1 (then clamped to 0, weight 0); truncation would give tap 0
    # and a negative weight
    i0, i1, w = tresize.axis_lerp(torch.tensor([0, 1], dtype=torch.int32), 60, 64)
    assert i0.tolist() == [0, 0] and i1.tolist() == [1, 1]
    assert w[0].item() == 0.0 and w[1].item() > 0.0


def test_axis_lerp_per_plane_lengths():
    rng = np.random.default_rng(3)
    src = rng.integers(1, 300, (12, 1)).astype(np.int32)
    dst = rng.integers(1, 200, (12, 1)).astype(np.int32)
    q = np.arange(-10, 140, dtype=np.int32)[None, :]
    j = jresize.axis_lerp(jnp.asarray(q), jnp.asarray(src), jnp.asarray(dst))
    t = tresize.axis_lerp(torch.from_numpy(q), torch.from_numpy(src), torch.from_numpy(dst))
    assert np.array_equal(np.asarray(j[0]), t[0].numpy())
    assert np.array_equal(np.asarray(j[1]), t[1].numpy())
    assert np.array_equal(_bits(j[2]), _bits(t[2].numpy()))


@pytest.mark.parametrize("mode", list(TAR), ids=lambda m: m.name)
@pytest.mark.parametrize("dsize", [(64, 128), (128, 64), (100, 100), (33, 17)])
def test_letterbox_geometry_matches_reference(mode, dsize):
    w, h = np.meshgrid(np.arange(1, 260, 7), np.arange(1, 260, 11))
    w = w.ravel().astype(np.int32)
    h = h.ravel().astype(np.int32)
    j = jresize.letterbox_geometry(jnp.asarray(w), jnp.asarray(h), JSize(*dsize), JAR[mode.name])
    t = tresize.letterbox_geometry(torch.from_numpy(w), torch.from_numpy(h), TSize(*dsize), mode)
    for a, b in zip(j, t):
        assert np.array_equal(np.broadcast_to(np.asarray(a), w.shape), b.numpy())


def test_letterbox_fits_flagship_preserve_crop():
    new_w, new_h, ox, oy = tresize.letterbox_geometry(30, 120, TSize(64, 128), TAR.PRESERVE_AR)
    assert (int(new_w), int(new_h), int(ox), int(oy)) == (32, 128, 16, 0)


@pytest.mark.parametrize("src,dst,values", [
    (np.float32, np.uint8, [-3.5, -0.5, 0.5, 1.5, 2.5, 254.5, 255.5, 300.0, 17.49]),
    (np.int8, np.uint8, [-128, -1, 0, 1, 127]),
    (np.float32, np.int16, [-40000.0, -2.5, 2.5, 40000.0]),
    (np.uint8, np.float32, [0, 1, 255]),
    (np.int32, np.uint8, [-5, 0, 255, 256, 100000]),
])
def test_saturate_cast_matches_reference(src, dst, values):
    x = np.asarray(values, src)
    j = np.asarray(jdt.saturate_cast(jnp.asarray(x), dst))
    t = tdt.saturate_cast(torch.from_numpy(x), dst).numpy()
    assert t.dtype == j.dtype
    assert np.array_equal(j, t)


@pytest.mark.parametrize("value", [2.5, (1.0, 2.0, 3.0), [7.0], np.float32(4.0)])
def test_as_channel_vector_matches_reference(value):
    j = np.asarray(jdt.as_channel_vector(value, 3, np.float32))
    t = tdt.as_channel_vector(value, 3, np.float32)
    assert isinstance(t, np.ndarray)
    assert np.array_equal(j, t)


def test_as_channel_vector_rejects_wrong_length():
    with pytest.raises(ValueError):
        jdt.as_channel_vector((1.0, 2.0), 3)
    with pytest.raises(ValueError):
        tdt.as_channel_vector((1.0, 2.0), 3)
    with pytest.raises(ValueError):
        tdt.as_channel_vector(torch.tensor([1.0, 2.0]), 3)
