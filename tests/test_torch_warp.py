"""The warp slice (``WarpRead``, ``BatchRead``, ``warp``/``warp_batch``/
``batch_read``, the warp kernel's plan and plain version): the port against
the JAX package.

Each pipeline is built with the JAX package's factories and carried across
with ``from_jax``. The port runs it through the eager PyTorch version
(``execute_operations`` on CPU tensors) and through the warp kernel's
wrapper on CPU tensors, which gathers the kernel's arguments with
``prepare`` and runs the plain version on them.

Tolerances:

- the port equals the reference's op-by-op lowering (``Pipeline.lower()``
  outside jit) bit for bit, float32 and uint8 alike, and the kernel's plain
  version equals the port's eager output bit for bit;
- against the reference's jitted ``ParBackend.XLA`` path, float32 within
  1e-4 and uint8 within 1: XLA-CPU contracts the bilinear lerps into FMAs
  (ROADMAP §3), which moves a value in 0..255 by a few ulps (up to 6.1e-5
  measured);
- against the reference's Pallas warp kernels in interpret mode, as the JAX
  tests run them: K3 (``pallas_warp``) through ``execute_operations(...,
  backend=PALLAS_INTERPRET)``, K4 (``pallas_warp_general``) and K5
  (``pallas_warp_universal``) through ``try_lower(pipe, interpret=True)``.
  The JAX tests hold K3, K4 and the batched K5 within ``check_float``'s
  default 1e-4 of the XLA path, and the port within the same 1e-4. They
  hold the single-image K5 cases at 0, but that 0 is between two
  FMA-contracted computations: the interpret-mode kernel equals the XLA
  path exactly and both differ from the op-by-op lowering by the same
  ulps, so the port is held within 1e-4 of K5 as well.
"""

import math

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from conftest import assert_backend
from cvgpuspeedup_tpu.exec import pallas_warp, pallas_warp_general, pallas_warp_universal
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.graph import flatten, map_leaves
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.ops import warp as twarp
from cvgpuspeedup_tpu_torch.utils.dtypes import as_device_tensor

F32_TOL = 1e-4
CPU = torch.device("cpu")


def _img(seed, h=96, w=384, c=3, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c is None else (h, w, c)
    return rng.integers(0, 256, shape).astype(dtype)


def rotation(center, angle, scale, to=None):
    """``cv2.getRotationMatrix2D``; with ``to``, shifted so that ``center``
    lands on ``to`` in the output (a downscaled rotation about the source's
    center then fills the output instead of missing it)."""
    a = math.radians(angle)
    al, be = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    m = np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])
    if to is not None:
        m[:, 2] += (to[0] - cx, to[1] - cy)
    return m


def perspective(src, dst):
    """``cv2.getPerspectiveTransform`` of four point pairs."""
    rows, rhs = [], []
    for (x, y), (u, v) in zip(src, dst):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs += [u, v]
    h = np.linalg.solve(np.asarray(rows, np.float64), np.asarray(rhs, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


CORNERS = [(0, 0), (383, 0), (0, 95), (383, 95)]


def _tuple(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def _host(x):
    return tuple(np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for v in _tuple(x))


def _assert_equal(actual, expected, msg):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.shape == e.shape and a.dtype == e.dtype, (
            f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}")
        assert np.array_equal(a, e, equal_nan=a.dtype.kind == "f"), (
            f"{msg}: not bit-equal, max |diff| {np.nanmax(np.abs(a.astype(np.float64) - e))}")


def _assert_close(actual, expected, msg, tol=F32_TOL):
    for a, e in zip(_host(actual), _host(expected), strict=True):
        assert a.shape == e.shape and a.dtype == e.dtype, (
            f"{msg}: {a.shape} {a.dtype} vs {e.shape} {e.dtype}")
        d = np.abs(a.astype(np.float64) - e.astype(np.float64)).max()
        assert d <= (1 if a.dtype == np.uint8 else tol), f"{msg}: max |diff| {d}"


def check_parity(*jax_ops, pallas=None):
    """Run the pipeline in the JAX package (op by op, jitted XLA, and the
    Pallas kernel ``pallas`` names: "k3", "k4" or "k5") and in both port
    versions; returns the port's eager output."""
    jp = J.build_pipeline(*jax_ops)
    pipeline = from_jax(jp)
    eager = T.execute_operations(pipeline.read, *pipeline.compute, pipeline.write, device="cpu")
    assert T.last_backend() == "torch"
    _assert_equal(eager, jp.lower(), "eager vs the reference op by op")
    _assert_close(eager, J.execute_operations(*jax_ops, backend=J.ParBackend.XLA),
                  "eager vs the reference's XLA path")
    plain = kw.run(pipeline, kw.build_plan(pipeline), CPU)
    _assert_equal(plain, eager, "kernel plain version vs eager")
    if pallas == "k3":
        got = J.execute_operations(*jax_ops, backend=J.ParBackend.PALLAS_INTERPRET)
        assert_backend("pallas:warp:interpret")
    elif pallas is not None:
        module = pallas_warp_general if pallas == "k4" else pallas_warp_universal
        got = module.try_lower(jp, interpret=True)
        assert got is not None, f"{pallas} did not take the pipeline"
    if pallas is not None:
        _assert_close(eager, got, f"eager vs the reference's Pallas {pallas}")
    return eager


# --- single warps: the classes of pallas_warp (K3) ---------------------------


@pytest.mark.parametrize("name,m,dsize,kw_", [
    ("identity", [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], (128, 96), {}),
    ("translation", [[1.0, 0.0, 17.0], [0.0, 1.0, -9.0]], (128, 96), {}),
    ("scale_translate_border", [[0.7, 0.0, -20.0], [0.0, 1.3, 30.0]], (128, 64),
     {"default": (9.0, 8.0, 7.0)}),
])
def test_separable_maps_match_reference(name, m, dsize, kw_):
    img = _img(1, h=96, w=128)
    ops = (J.warp(img, np.asarray(m), J.Size(*dsize), **kw_), J.multiply(0.5), J.split_tensor())
    assert pallas_warp.supports(J.build_pipeline(*ops))
    out = check_parity(*ops, pallas="k3")
    assert tuple(out.shape) == (3, dsize[1], dsize[0])
    if name == "identity":
        assert torch.equal(out, torch.from_numpy(img).permute(2, 0, 1).float() * 0.5)


def test_separable_upscale_matches_reference():
    ops = (J.warp(_img(2, h=96, w=256), np.array([[2.0, 0.0, 5.0], [0.0, 2.0, 3.0]]),
                  J.Size(512, 192)),
           J.convert_to(np.float32, alpha=1 / 255.0), J.split_tensor())
    check_parity(*ops, pallas="k3")


# --- single warps: the class of pallas_warp_general (K4) ----------------------


@pytest.mark.parametrize("angle", [10.0, -7.5])
def test_rotations_match_reference(angle):
    m = rotation((192, 48), angle, 1 / 3.0, to=(64, 16))
    ops = (J.warp(_img(3), m, J.Size(128, 32)), J.split_tensor())
    assert J.build_pipeline(*ops).read.gen_buckets is not None
    check_parity(*ops, pallas="k4")


def test_rotation_with_chain_and_border():
    # half the output falls outside the source
    ops = (J.warp(_img(4), rotation((50, 20), 12.0, 0.25), J.Size(128, 96), default=17.0),
           J.multiply((2.0, 0.5, 1.0)), J.subtract(3.0), J.split_tensor())
    check_parity(*ops, pallas="k4")


@pytest.mark.parametrize("m", [
    [[1 / 3.0, 0.12, 5.0], [0.0, 1 / 2.0, -2.0]],   # horizontal shear
    [[1 / 3.0, 0.0, 1.0], [0.08, 1 / 2.0, 0.0]],    # vertical shear
    [[1 / 3.0, -0.05, 8.0], [0.10, 1.6, 2.0]],      # vertical upscale with rotation
], ids=["shear_h", "shear_v", "vertical_upscale_rotation"])
def test_shears_match_reference(m):
    ops = (J.warp(_img(5), np.asarray(m), J.Size(96, 48)), J.split_tensor())
    check_parity(*ops, pallas="k4")


def test_single_channel_split_write():
    ops = (J.warp(_img(6, c=None), rotation((300, 100), -15.0, 1 / 4.0, to=(48, 16)),
                  J.Size(96, 32)),
           J.split())
    out = check_parity(*ops, pallas="k4")
    assert len(out) == 1 and tuple(out[0].shape) == (32, 96)


def test_four_channels():
    ops = (J.warp(_img(7, w=320, c=4), rotation((160, 48), 8.0, 1 / 3.0, to=(32, 16)),
                  J.Size(64, 32)),
           J.split_tensor())
    check_parity(*ops, pallas="k4")


# --- single warps: the class of pallas_warp_universal (K5a) -------------------


@pytest.mark.parametrize("name,m,dsize", [
    ("upscale_rotation", rotation((100, 40), 10.0, 1.2), (128, 64)),
    ("flip_h", np.array([[-0.5, 0.0, 90.0], [0.0, 0.5, 2.0]]), (64, 32)),
    ("flip_v", np.array([[0.5, 0.02, 3.0], [0.01, -0.5, 80.0]]), (64, 32)),
    ("ragged_height", rotation((100, 40), 10.0, 1.2), (128, 44)),
])
def test_universal_affine_maps_match_reference(name, m, dsize):
    ops = (J.warp(_img(8), m, J.Size(*dsize)), J.split_tensor())
    check_parity(*ops, pallas="k5")


@pytest.mark.parametrize("dst", [
    [(5, 3), (120, 8), (2, 60), (125, 62)],
    # the interior-rounding regression of the universal kernel: the bottom
    # rows map to source row ~95, and an interior sy rounds one ulp below
    # both row endpoints
    [(6, 3), (119, 8), (2, 61), (125, 61)],
], ids=["perspective", "sy_endpoint_rounding"])
def test_perspective_matches_reference(dst):
    ops = (J.warp(_img(9), perspective(CORNERS, dst), J.Size(128, 64),
                  warp_type=J.WarpType.PERSPECTIVE), J.split_tensor())
    check_parity(*ops, pallas="k5")


def test_universal_chain_and_border():
    ops = (J.warp(_img(10), rotation((50, 20), 12.0, 1.5), J.Size(128, 64), default=17.0),
           J.multiply((2.0, 0.5, 1.0)), J.subtract(3.0), J.split_tensor())
    check_parity(*ops, pallas="k5")


def test_universal_single_channel_split_write():
    ops = (J.warp(_img(11, c=None), rotation((150, 40), -8.0, 1.3), J.Size(128, 64)), J.split())
    check_parity(*ops, pallas="k5")


# --- single warps outside every TPU class --------------------------------------


@pytest.mark.parametrize("shift", [1e6, -1e6, 3e9, -3e9], ids=["1e6", "-1e6", "3e9", "-3e9"])
def test_far_off_map_reads_the_border(shift):
    """Every tap lies outside the source, left and right or above and below;
    at 3e9 the coordinates leave int32. Each output pixel is the border."""
    m = np.array([[1.0, 0.0, shift], [0.0, 1.0, -shift / 3]])
    out = check_parity(J.warp(_img(12, h=40, w=64), m, J.Size(32, 24), default=(4.0, 5.0, 6.0)),
                       J.split_tensor())
    want = torch.tensor([4.0, 5.0, 6.0]).reshape(3, 1, 1).expand(3, 24, 32)
    assert torch.equal(out, want)


def test_affine_vs_float64_oracle():
    """A rotation with a shift against a float64 warp with the reference's
    float32 coordinate terms (``tests/test_warp.py::_np_warp_affine``)."""
    img = _img(13, h=60, w=80)
    m = rotation((40, 30), 20.0, 0.8)
    m[:, 2] += (5, -3)
    out = check_parity(J.warp(img, m, J.Size(80, 60)))
    terms = twarp.decompose_inverse_map(twarp.invert_affine(m), T.Size(80, 60))
    sx = terms["col_x"][None, :] + terms["row_x"][:, None]
    sy = terms["col_y"][None, :] + terms["row_y"][:, None]
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    src = img.astype(np.float64)

    def tap(ix, iy):
        valid = (ix >= 0) & (ix < 80) & (iy >= 0) & (iy < 60)
        return np.where(valid[..., None], src[np.clip(iy, 0, 59), np.clip(ix, 0, 79)], 0.0)

    h0 = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    h1 = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    assert np.abs(out.numpy() - (h0 * (1 - fy) + h1 * fy)).max() <= F32_TOL


@pytest.mark.parametrize("layout", ["split", "split_tensor", "write"])
def test_u8_chain_four_channels_per_channel_border(layout):
    ops = (J.warp(_img(14, c=4), rotation((190, 50), -20.0, 0.9), J.Size(96, 48),
                  default=(10.0, 20.0, 30.0, 250.0)),
           J.convert_to(np.uint8), getattr(J, layout)())
    out = check_parity(*ops)
    assert _tuple(out)[0].dtype == torch.uint8


def test_float32_source():
    img = _img(15).astype(np.float32) / np.float32(255.0)
    check_parity(J.warp(img, rotation((192, 48), 10.0, 1 / 3.0, to=(64, 16)), J.Size(128, 32)),
                 J.multiply(3.0), J.split_tensor())


def test_packed_host_image():
    """``J.image`` ingests a host frame as packed (H, W*C) rows; the port
    reads the same rows."""
    read = J.image(_img(16))
    assert read.packed_channels == 3
    check_parity(J.warp(read, rotation((192, 48), 10.0, 1 / 3.0, to=(64, 16)), J.Size(128, 32)),
                 J.split_tensor(), pallas="k4")


# --- batched warps (pallas_warp_universal._emit_batch, K5b) -------------------


def test_warp_batch_ragged_matches_reference():
    imgs = [_img(20 + i) for i in range(6)]
    mats = [rotation((192, 48), 7.0 * i - 15, 1.0 + 0.1 * i) for i in range(6)]
    ops = (J.warp_batch(imgs, mats, J.Size(128, 64), used_planes=5, default=7.0,
                        border_value=(1.0, 2.0, 3.0)),
           J.multiply(0.5), J.split_tensor())
    out = check_parity(*ops, pallas="k5")
    assert tuple(out.shape) == (6, 3, 64, 128)
    assert bool((out[5] == 3.5).all())


def test_warp_batch_perspective_matches_reference():
    imgs = [_img(30 + i) for i in range(4)]
    mats = [perspective(CORNERS, [(5 + i, 3), (120 - i, 8), (2, 60 + i), (125, 62 - i)])
            for i in range(4)]
    check_parity(J.warp_batch(imgs, mats, J.Size(128, 64), warp_type=J.WarpType.PERSPECTIVE),
                 J.split_tensor(), pallas="k5")


def test_warp_batch_mixing_a_translation_with_rotations():
    imgs = [_img(40 + i) for i in range(4)]
    mats = [np.array([[1.0, 0.0, 5.0], [0.0, 1.0, 3.0]])] + [
        rotation((192, 48), 7.0 * i, 1.1) for i in range(1, 4)]
    check_parity(J.warp_batch(imgs, mats, J.Size(128, 64)), J.split_tensor(), pallas="k5")


def test_warp_batch_of_one_shared_frame():
    """The reference's own batched row, cut to size: one frame warped 8
    times, ragged at 7; the kernel's arguments hold the frame once."""
    frame = _img(50)
    mats = [rotation((192, 48), 3 * i - 10, 1 + 0.04 * i) for i in range(8)]
    ops = (J.warp_batch([frame] * 8, mats, J.Size(64, 32), used_planes=7, default=3.0),
           J.convert_to(np.float32, alpha=1 / 255.0), J.split_tensor())
    out = check_parity(*ops, pallas="k5")
    assert torch.equal(out[7], torch.full((3, 32, 64), np.float32(3.0) * np.float32(1 / 255.0)))
    pipeline = from_jax(J.build_pipeline(*ops))
    a = kw.prepare(pipeline, kw.build_plan(pipeline), CPU)
    assert len(a.srcs) == 1 and a.plane_src == (0,) * 8
    assert len(set(a.ptrs.tolist())) == 1 and int(a.used) == 7


@pytest.mark.parametrize("layout", ["split_tensor_transposed", "split_tensor_packed",
                                    "write_tensor", "write", "split"])
def test_warp_batch_layouts(layout):
    imgs = [_img(60 + i, h=40, w=64) for i in range(3)]
    mats = [rotation((32, 20), 5.0 * i, 0.9) for i in range(3)]
    check_parity(J.warp_batch(imgs, mats, J.Size(48, 32), used_planes=2, default=(3.0, 4.0, 5.0)),
                 J.convert_to(np.uint8, alpha=0.5), getattr(J, layout)())


def test_batch_read_of_warps():
    imgs = _img(70, h=40, w=40, c=None)[None].repeat(4, 0)
    warps = [J.warp(imgs[i], rotation((20, 20), 10 * i, 0.8), J.Size(40, 40)) for i in range(4)]
    out = check_parity(J.batch_read(warps, used_planes=3, default=7.0))
    assert tuple(out.shape) == (4, 40, 40, 1) and bool((out[3] == 7.0).all())


# --- BatchRead on the eager path -------------------------------------------------


def test_batch_read_of_images_on_the_eager_path():
    imgs = [_img(80 + i, h=16, w=24) for i in range(5)]
    ops = (J.batch_read([J.image(i) for i in imgs], used_planes=3, default=9.0), J.multiply(2.0))
    jp = J.build_pipeline(*ops)
    pipeline = from_jax(jp)
    assert not kw.supports(pipeline)
    out = T.execute_operations(pipeline.read, *pipeline.compute, pipeline.write, device="cpu")
    _assert_equal(out, jp.lower(), "batch_read of images vs the reference op by op")
    assert out.dtype == torch.uint8 and bool((out[3:] == 18).all())
    native = T.execute_operations(T.batch_read([T.image(i) for i in imgs], used_planes=3,
                                               default=9.0), T.multiply(2.0), device="cpu")
    assert torch.equal(native, out)


@pytest.mark.parametrize("planes", [(0, 2), (4, 1, 3), (3,)])
def test_lower_planes_matches_reference(planes):
    imgs = [_img(90 + i, h=32, w=48) for i in range(5)]
    mats = [rotation((24, 16), 6.0 * i, 0.9) for i in range(5)]
    jread = J.warp_batch(imgs, mats, J.Size(24, 16), used_planes=3, default=(1.0, 2.0, 3.0))
    tread = map_leaves(from_jax(jread), lambda v: as_device_tensor(v, CPU))
    got = tread.lower_planes(planes)
    _assert_equal(got, np.asarray(jread.lower_planes(planes)), "lower_planes")
    _assert_equal(got, tread.lower()[list(planes)], "lower_planes vs lower")


# --- the kernel's arguments and the executor ----------------------------------


@pytest.mark.parametrize("kind", ["affine", "perspective"])
def test_kernel_coordinates_from_the_coefficients_equal_the_terms(kind):
    """The kernel recomputes sx, sy (and den) from the parameter block's
    float32 coefficients as c0*X + (c1*Y + c2), each op rounded once; in
    numpy float32 that equals the factory's term sums bit for bit."""
    if kind == "affine":
        read = T.warp(_img(100), rotation((190, 50), 17.0, 0.37), T.Size(200, 90))
    else:
        read = T.warp(_img(100), perspective(CORNERS, [(5, 3), (120, 8), (2, 60), (125, 62)]),
                      T.Size(200, 90), warp_type=T.WarpType.PERSPECTIVE)
    pipeline = T.build_pipeline(read, T.split_tensor())
    a = kw.prepare(pipeline, kw.build_plan(pipeline), CPU)
    c = a.coeffs.numpy()
    xs = np.arange(200, dtype=np.float32)[None, :]
    ys = np.arange(90, dtype=np.float32)[:, None]

    def term(k):
        return c[k] * xs + (c[k + 1] * ys + c[k + 2])

    for k, (col, row) in enumerate([("col_x", "row_x"), ("col_y", "row_y"), ("col_w", "row_w")]):
        if getattr(read, col) is None:
            assert kind == "affine" and not c[6:].any()
            continue
        want = getattr(read, col)[None, :] + getattr(read, row)[:, None]
        assert np.array_equal(term(3 * k), want)


def test_prepare_packs_host_and_device_leaves_alike():
    imgs = [_img(110 + i, h=40, w=64) for i in range(3)]
    pipe = T.build_pipeline(
        T.warp_batch(imgs, [rotation((32, 20), 5.0 * i, 0.9) for i in range(3)], T.Size(48, 32),
                     used_planes=2, default=(3.0, 4.0, 5.0), border_value=7.0),
        T.subtract((1.0, 2.0, 3.0)), T.split_tensor())
    plan = kw.build_plan(pipe)
    host = kw.prepare(pipe, plan, CPU)
    dev = kw.prepare(map_leaves(pipe, lambda v: as_device_tensor(v, CPU)), plan, CPU)
    for f in ("used", "coeffs", "border", "default", "fparams", "ops"):
        assert torch.equal(getattr(host, f), getattr(dev, f)), f
    assert host.border[:4].tolist() == [7.0, 7.0, 7.0, 0.0]
    assert host.default.tolist() == [3.0, 4.0, 5.0, 0.0]
    assert host.fparams.tolist() == [1.0, 2.0, 3.0] and int(host.used) == 2


def test_matrix_values_and_used_planes_build_no_new_plan():
    frame = torch.from_numpy(_img(120))

    def call(angle, used):
        return T.execute_operations(
            T.warp_batch([frame] * 4,
                         [rotation((192, 48), angle + i, 0.5, to=(32, 16)) for i in range(4)],
                         T.Size(64, 32), used_planes=used, default=1.0),
            T.split_tensor(), device="cpu")

    first = call(3.0, 4)
    builds = executor.PLAN_BUILDS
    second = call(11.0, 2)
    assert executor.PLAN_BUILDS == builds and not torch.equal(first, second)
    assert bool((second[2:] == 1.0).all())
    single = [T.build_pipeline(T.warp(frame, rotation((192, 48), a, 0.5), T.Size(64, 32)))
              for a in (3.0, 30.0)]
    assert flatten(single[0])[0] == flatten(single[1])[0]


def test_backend_choice_on_the_cpu():
    ops = (T.warp(torch.from_numpy(_img(130)), rotation((192, 48), 10.0, 0.5), T.Size(64, 32)),
           T.split_tensor())
    assert T.describe_backend(*ops, device="cpu") == "torch"
    T.execute_operations(*ops, device="cpu")
    assert T.last_backend() == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        T.execute_operations(*ops, backend=T.ParBackend.CUDA, device="cpu")


def test_error_paths_raise_like_reference():
    img = _img(140, h=16, w=16)
    for m in (J, T):
        with pytest.raises(ValueError, match="2x3"):
            m.warp(img, np.eye(3), m.Size(8, 8))
        with pytest.raises(ValueError, match="3x3"):
            m.warp(img, np.eye(3)[:2], m.Size(8, 8), warp_type=m.WarpType.PERSPECTIVE)
        with pytest.raises(ValueError, match="one matrix per source"):
            m.warp_batch([img, img], [np.eye(3)[:2]], m.Size(8, 8))
        with pytest.raises(ValueError, match="default"):
            m.batch_read([m.warp(img, np.eye(3)[:2], m.Size(8, 8))], used_planes=1)
        with pytest.raises(ValueError, match="channels"):
            m.warp(img, np.eye(3)[:2], m.Size(8, 8), default=(1.0, 2.0))


def test_from_jax_drops_the_tpu_buckets():
    jread = J.warp(_img(150), rotation((192, 48), 10.0, 1 / 3.0), J.Size(128, 32))
    assert jread.gen_buckets is not None
    tread = from_jax(jread)
    assert type(tread) is twarp.WarpRead and tread.warp_type is T.WarpType.AFFINE
    assert tread.col_w is None and tread.coeffs.shape == (6,) and tread.dsize == T.Size(128, 32)
    native = T.warp(_img(150), rotation((192, 48), 10.0, 1 / 3.0), T.Size(128, 32))
    for f in ("col_x", "row_x", "col_y", "row_y", "coeffs", "default"):
        assert np.array_equal(getattr(tread, f), getattr(native, f)), f


def test_warp_of_a_read_op_counts_its_channels():
    src = T.resize(T.image(_img(160, c=4)), T.Size(100, 50))
    read = T.warp(src, rotation((50, 25), 10.0, 0.8), T.Size(64, 32), default=(1, 2, 3, 4))
    assert read.default.shape == (4,)
    out = T.execute_operations(read, T.split_tensor(), device="cpu")
    assert tuple(out.shape) == (4, 32, 64)


def test_kernel_refusals():
    img = _img(170, h=40, w=64)
    rot = rotation((32, 20), 10.0, 0.8)
    size = T.Size(32, 16)
    ok = T.build_pipeline(T.warp(img, rot, size), T.split_tensor())
    assert kw.supports(ok)
    nv12 = np.zeros((60, 64), np.uint8)
    refused = {
        "warp_of_a_resize": (T.warp(T.resize(T.image(img), T.Size(50, 30)), rot, size),),
        "warp_of_nv12": (T.warp(T.fuse(T.read_yuv(nv12), T.convert_yuv_to_rgb()), rot, size),),
        "mixed_types": (T.batch_read([T.warp(img, rot, size),
                                      T.warp(img, np.eye(3), size,
                                             warp_type=T.WarpType.PERSPECTIVE)]),),
        "mixed_sizes": (T.batch_read([T.warp(img, rot, size), T.warp(img, rot, T.Size(16, 16))]),),
        "mixed_geometry": (T.warp_batch([img, img[:20]], [rot, rot], size),),
        "mixed_dtypes": (T.warp_batch([img, img.astype(np.float32)], [rot, rot], size),),
        "five_channels": (T.warp(_img(170, h=40, w=64, c=5), rot, size),),
        "uint32_source": (T.warp(img.astype(np.uint32), rot, size),),
        "batch_of_images": (T.batch_read([T.image(img), T.image(img)]),),
        "single_tensor_write": (T.warp(img, rot, size), T.write_tensor()),
        "uint32_out": (T.warp(img, rot, size), T.Cast(dst=torch.uint32)),
    }
    # int64 and float64 are int32 and float32 where they enter, as in the
    # reference: a host frame of either, a tensor of either (read at load)
    # and a cast to either run in the kernel
    for src in (img.astype(np.float64), img.astype(np.int64),
                torch.from_numpy(img.astype(np.int64))):
        assert kw.supports(T.build_pipeline(T.warp(src, rot, size), T.convert_to(np.float64)))
    assert kw.build_plan(T.build_pipeline(T.warp(img, rot, size),
                                          T.Cast(dst=torch.int64))).out_dtype == torch.int32
    assert kw.supports(T.build_pipeline(T.warp(img.astype(np.uint16), rot, size),
                                        T.convert_to(np.int16)))
    assert kw.supports(T.build_pipeline(T.warp(img.astype(np.int32), rot, size),
                                        T.convert_to(np.int32)))
    for name, ops in refused.items():
        pipe = T.build_pipeline(*ops)
        assert not kw.supports(pipe), name
        if name == "warp_of_a_resize":
            # the eager version still runs it
            assert tuple(T.execute_operations(*ops, device="cpu").shape) == (16, 32, 3)
