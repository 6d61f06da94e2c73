"""The addressing of the CUDA kernels, emulated in numpy.

``csrc/batch_resize.cu`` computes a tile's tap tables once per block and
gathers every thread's taps through them; ``csrc/warp.cu`` fetches the two
adjacent taps of a uint8 row as three aligned 4-byte words, funnel-shifted
to the run's first byte; ``csrc/divergent.cu`` reads its descriptors as
16-byte words and gives a thread a group of adjacent pixels of a plane;
``csrc/frame_resize.cu`` gives a thread a group of adjacent output pixels
and reads the row's taps once; both store a whole aligned group as vectors,
in planar and in packed layouts (``csrc/chain.cuh``). None can run without a
card, so :func:`emulate_batch_resize`, :func:`emulate_warp`,
:func:`emulate_divergent_copy` and :func:`emulate_frame_resize` repeat
their index arithmetic step by step on a flat byte buffer whose index plays
the absolute address: the tile grid, the tables' marks outside the
letterbox, the taps' addresses (none may leave the source buffer), each
vector store's alignment, the packed-or-per-byte decision.
Each must equal the kernels' plain versions (``batch_resize_reference``,
``warp_reference``, ``divergent_reference``, ``frame_resize_reference``) bit
for bit. Keep the constants and the steps in step with the sources.
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw

CPU = torch.device("cpu")
F32 = np.float32

# csrc/chain.cuh, csrc/batch_resize.cu
K_PIX, THREADS, MAX_TILE_W, MAX_TILE_H = 4, 128, 256, 64
POISON = 0xA5  # fills the memory around a source: no value may come from it


def tile_shape(dst_w):
    tile_w = min(MAX_TILE_W, (dst_w + K_PIX - 1) // K_PIX * K_PIX)
    return tile_w, min(MAX_TILE_H, max(1, THREADS * K_PIX // tile_w))


def place(src: np.ndarray, offset: int, slack: int = 64):
    """``(mem, lo, hi)``: a poisoned byte buffer holding ``src``'s bytes at
    absolute address ``lo = 64 + offset`` (the buffer itself is 64-byte
    aligned at address 0)."""
    raw = np.ascontiguousarray(src).view(np.uint8).reshape(-1)
    lo = 64 + offset
    size = (lo + raw.size + slack + 63) // 64 * 64
    store = np.full(size + 64, POISON, np.uint8)
    shift = (-store.ctypes.data) % 64
    mem = store[shift:shift + size]
    mem[lo:lo + raw.size] = raw
    return mem, lo, lo + raw.size


def letterbox(cw, ch, dst_w, dst_h, mode):
    """``csrc/batch_resize.cuh::letterbox`` for one rect."""
    if mode == T.AspectRatio.IGNORE_AR:
        return dst_w, dst_h, 0, 0
    with np.errstate(divide="ignore", invalid="ignore"):
        w = int(F32(F32(dst_h) / F32(ch)) * F32(cw))
        h = dst_h
        if w > dst_w:
            h = int(F32(F32(dst_w) / F32(cw)) * F32(ch))
            w = dst_w
    if mode == T.AspectRatio.PRESERVE_AR_RN_EVEN:
        w, h = min((w + 1) // 2 * 2, dst_w), min((h + 1) // 2 * 2, dst_h)
    if mode == T.AspectRatio.PRESERVE_AR_LEFT:
        return w, h, 0, 0
    return w, h, (dst_w - w) // 2, (dst_h - h) // 2


def axis_lerp(q, src, dst):
    """``csrc/batch_resize.cuh::axis_lerp`` for an int array ``q``."""
    num = (2 * q + 1) * src - dst
    den = 2 * dst
    i = num // den
    w = (num - i * den).astype(F32) / F32(den)
    w = np.where(i < 0, F32(0), w)
    i = np.maximum(i, 0)
    w = np.where(i >= src - 1, F32(0), w)
    i = np.minimum(i, src - 1)
    return i, np.minimum(i + 1, src - 1), w.astype(F32)


def source_index(t, n):
    return np.clip(np.where(t < 0, t + n, t), 0, n - 1)


def lerp(a, b, w):
    return (a * (F32(1) - w) + b * w).astype(F32)


def emulate_batch_resize(a: kbr.Launch, offset: int = 0):
    """``batch_resize_kernel`` before its chain: ``(values (N, H, W, C)
    float32, stats)``; ``stats`` counts the tiles and the sampled pixels."""
    plan = a.plan
    dst_w, dst_h = plan.dsize
    src = a.src.numpy()
    dtype, item, nch = src.dtype, src.dtype.itemsize, plan.nch
    src_h, src_w = src.shape[-3], src.shape[-2]
    mem, lo, hi = place(src, offset * item)  # a view keeps its element alignment
    plane_stride = src_h * src_w * nch if plan.stack_mode else 0
    rects, used = a.rects.numpy(), int(a.used.item())
    bg = a.fparams.numpy()[:nch]
    tile_w, tile_h = tile_shape(dst_w)
    out = np.empty((plan.n_planes, dst_h, dst_w, nch), F32)
    out[:] = bg
    stats = {"tiles": 0, "sampled": 0, "background": 0}
    mode = plan.aspect_ratio
    for z in range(min(used, plan.n_planes)):
        plane = lo + z * plane_stride * item  # address of the plane's first byte
        rx, ry, rw, rh = (int(v) for v in rects[z])
        nw, nh, ox, oy = letterbox(rw, rh, dst_w, dst_h, mode)

        def tap(r, c):
            first = plane + ((r * src_w + c) * nch) * item
            assert lo <= first and first + nch * item <= hi
            return mem[first:first + nch * item].view(dtype).astype(F32)

        for ty0 in range(0, dst_h, tile_h):
            for tx0 in range(0, dst_w, tile_w):
                # the prologue's tables; -1 marks a column or row outside the letterbox
                qx = tx0 + np.arange(tile_w) - ox
                qy = ty0 + np.arange(tile_h) - oy
                inx, iny = (qx >= 0) & (qx < nw), (qy >= 0) & (qy < nh)
                i0, i1, wx = axis_lerp(np.where(inx, qx, 0), rw, max(nw, 1))
                c0 = np.where(inx, source_index(rx + i0, src_w), -1)
                c1 = source_index(rx + i1, src_w)
                j0, j1, wy = axis_lerp(np.where(iny, qy, 0), rh, max(nh, 1))
                r0 = np.where(iny, source_index(ry + j0, src_h), -1)
                r1 = source_index(ry + j1, src_h)
                stats["tiles"] += 1
                valid = np.outer(r0[:min(tile_h, dst_h - ty0)] >= 0,
                                 c0[:min(tile_w, dst_w - tx0)] >= 0)
                stats["sampled"] += int(valid.sum())
                stats["background"] += int((~valid).sum())
                # the threads' gathers and lerps, horizontal first
                for ly in range(min(tile_h, dst_h - ty0)):
                    if r0[ly] < 0:
                        continue
                    for lx in range(min(tile_w, dst_w - tx0)):
                        if c0[lx] < 0:
                            continue
                        top = lerp(tap(r0[ly], c0[lx]), tap(r0[ly], c1[lx]), wx[lx])
                        bot = lerp(tap(r1[ly], c0[lx]), tap(r1[ly], c1[lx]), wx[lx])
                        out[z, ty0 + ly, tx0 + lx] = lerp(top, bot, wy[ly])
    return out, stats


def _k1_launch(src, rects, dsize, **kw_):
    read = T.resize_batch(torch.from_numpy(src) if isinstance(src, np.ndarray) else src,
                          rects=rects, dsize=T.Size(*dsize), **kw_)
    pipeline = T.build_pipeline(read, T.write_tensor())
    return kbr.prepare(pipeline, kbr.build_plan(pipeline), CPU)


def _check_k1(a, offset=0):
    out, stats = emulate_batch_resize(a, offset)
    ref = kbr.batch_resize_reference(a).numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.array_equal(out.view(np.uint32), ref.view(np.uint32)), \
        f"{(out != ref).sum()} values differ; {stats}"
    return stats


def _src(seed, h, w, c, dtype=np.uint8):
    v = np.random.default_rng(seed).integers(0, 256, (h, w, c))
    return v.astype(dtype) if dtype == np.uint8 else (v / F32(3)).astype(F32)


INSIDE = np.array([[3 + 5 * i, 2 + 3 * i, 30, 44] for i in range(4)], np.int32)


@pytest.mark.parametrize("nch", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_rects_inside_the_frame(nch, dtype):
    stats = _check_k1(_k1_launch(_src(1, 64, 96, nch, dtype), INSIDE, (32, 48)))
    assert stats["tiles"] == 4 * 3 and stats["background"] == 0  # 32x16 tiles of 32x48 planes


@pytest.mark.parametrize("width", [96, 36, 35])
def test_row_pitches_of_any_alignment(width):
    """288-byte rows (a multiple of 16), 108-byte rows (of 4), 105-byte rows."""
    rects = np.array([[1, 2, 20, 30], [10, 20, 24, 36]], np.int32)
    _check_k1(_k1_launch(_src(2, 64, width, 3), rects, (32, 48)))


@pytest.mark.parametrize("offset", [1, 2, 3, 5, 15])
def test_a_source_view_at_an_odd_address(offset):
    """A source that starts ``offset`` bytes past an aligned address: the
    taps of its first and last pixel stay inside the buffer."""
    rects = np.array([[0, 0, 96, 64], [60, 30, 36, 34]], np.int32)  # the first and last bytes
    _check_k1(_k1_launch(_src(3, 64, 96, 3), rects, (32, 48)), offset)


NEGATIVE = {
    "left_of_the_frame": [[-7, 4, 30, 40]],
    "above_the_frame": [[5, -9, 30, 40]],
    "past_minus_width": [[-100, 3, 30, 40]],
    "past_the_right_edge": [[80, 5, 30, 40]],
    "past_the_bottom_edge": [[10, 50, 30, 40]],
    "past_both_edges": [[90, 60, 30, 40]],
}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("name", sorted(NEGATIVE))
def test_rects_that_leave_the_frame_wrap_and_clamp(name, dtype):
    rects = np.array(NEGATIVE[name] + [[4, 4, 30, 40]], np.int32)
    _check_k1(_k1_launch(_src(4, 64, 96, 3, dtype), rects, (32, 48)))


def test_a_crop_of_most_of_a_large_frame():
    rects = np.array([[2, 3, 380, 250], [5, 5, 40, 30]], np.int32)
    _check_k1(_k1_launch(_src(5, 260, 400, 3), rects, (64, 32)))


@pytest.mark.parametrize("mode", [m for m in T.AspectRatio if m != T.AspectRatio.IGNORE_AR],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("cw,chh", [(26, 44), (50, 20), (7, 45)])
def test_letterbox_borders_cut_through_a_threads_pixels(mode, cw, chh):
    rects = np.array([[3 + 4 * i, 2 + i, cw, chh] for i in range(3)], np.int32)
    a = _k1_launch(_src(6, 64, 96, 3), rects, (30, 44), aspect_ratio=mode,
                   background=(7.0, 8.0, 9.0))
    stats = _check_k1(a)
    assert stats["background"] > 0
    nw, nh, ox, oy = letterbox(cw, chh, 30, 44, mode)
    assert (nw, nh) != (30, 44)
    if mode != T.AspectRatio.PRESERVE_AR_LEFT:
        assert ox % K_PIX or (ox + nw) % K_PIX or nw == 30, "no group is cut: pick another size"


@pytest.mark.parametrize("dsize", [(30, 20), (33, 7), (5, 70), (270, 6), (64, 128)])
def test_output_widths_off_the_pixel_group_and_tile_grid(dsize):
    rects = np.array([[3, 2, 40, 44], [20, 10, 64, 50]], np.int32)
    _check_k1(_k1_launch(_src(7, 64, 96, 3), rects, dsize))


def test_tile_shapes():
    assert tile_shape(64) == (64, 8)        # the flagship: 800 blocks of 128 threads
    assert tile_shape(30) == (32, 16)
    assert tile_shape(3) == (4, 64)
    assert tile_shape(1920) == (256, 2)
    for w in range(1, 600):
        tw, th = tile_shape(w)
        assert tw % K_PIX == 0 and tw // K_PIX * th <= THREADS and tw <= MAX_TILE_W


def test_stack_mode_and_ragged_used_planes():
    imgs = [torch.from_numpy(_src(8 + i, h, w, 3)) for i, (h, w) in
            enumerate([(40, 60), (64, 96), (17, 9), (50, 50)])]
    read = T.resize_batch(imgs, dsize=T.Size(32, 48), used_planes=3, background=5.0)
    pipeline = T.build_pipeline(read, T.write_tensor())
    a = kbr.prepare(pipeline, kbr.build_plan(pipeline), CPU)
    stats = _check_k1(a, offset=1)
    assert stats["sampled"] == 3 * 32 * 48  # the fourth plane holds the background


# ---------------------------------------------------------------------------
# the warp kernel's packed tap fetch
# ---------------------------------------------------------------------------

def load_run(mem, p, nch):
    """``csrc/warp.cu::load_run``: ``(left, right)`` words of the 2 * nch
    bytes at address ``p``, from the three aligned 4-byte words at
    ``p & ~3``."""
    words = mem.view(np.uint32)
    k = p & 3
    a = (p - k) // 4
    w0, w1, w2 = (int(words[a + i]) for i in range(3))
    lo = (((w1 << 32) | w0) >> (8 * k)) & 0xFFFFFFFF
    hi = (((w2 << 32) | w1) >> (8 * k)) & 0xFFFFFFFF
    return lo, (((hi << 32) | lo) >> (8 * nch)) & 0xFFFFFFFF


def emulate_warp(a: kw.Launch, offset: int = 0):
    """``warp_kernel`` before its chain: ``(values (N, H, W, C) float32,
    stats)``; planes from ``used`` on hold the batch default."""
    plan = a.plan
    dst_w, dst_h = plan.dsize
    nch, src_h, src_w = plan.nch, plan.src_h, plan.src_w
    coeffs = a.coeffs.numpy().reshape(-1, 9)
    border = a.border.numpy().reshape(-1, 4)
    out = np.empty((plan.n_planes, dst_h, dst_w, nch), F32)
    out[:] = a.default.numpy()[:nch]
    stats = {"packed": 0, "plain": 0, "border": 0}  # pixels by the path their thread took
    xs = np.arange(dst_w, dtype=F32)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for z in range(min(int(a.used.item()), plan.n_planes)):
            src = a.srcs[a.plane_src[z]].numpy()
            item = src.dtype.itemsize
            mem, lo, hi = place(src, offset * item)
            flat = mem[lo:hi].view(src.dtype)
            c, b = coeffs[z], border[z]
            for y in range(dst_h):
                fy = F32(y)
                px = c[0] * xs + (c[1] * fy + c[2])      # the row sum is its own rounded step
                py = c[3] * xs + (c[4] * fy + c[5])
                if plan.perspective:
                    den = c[6] * xs + (c[7] * fy + c[8])
                    den = np.where(den == 0, F32(1), den)
                    px, py = px / den, py / den
                x0f, y0f = np.floor(px), np.floor(py)
                wx, wy = px - x0f, py - y0f
                inside = ((x0f >= 0) & (x0f < F32(src_w) - 1) & (y0f >= 0)
                          & (y0f < F32(src_h) - 1))
                for x in range(dst_w):
                    fx0, fy0 = x0f[x], y0f[x]
                    # a thread owns K_PIX pixels and takes one path for all of them
                    g0 = x // K_PIX * K_PIX
                    group = range(g0, g0 + K_PIX)
                    interior = g0 + K_PIX <= dst_w and bool(inside[g0:g0 + K_PIX].all())
                    if interior and item == 1:
                        for gx in group:
                            e = (int(y0f[gx]) * src_w + int(x0f[gx])) * nch
                            a0, a1 = (lo + e) & ~3, (lo + e + src_w * nch) & ~3
                            interior = interior and a0 >= lo and a1 + 12 <= hi
                    if interior:
                        e0 = (int(fy0) * src_w + int(fx0)) * nch   # element of the first tap
                        e1 = e0 + src_w * nch
                        if item == 1:
                            stats["packed"] += 1
                            l0, t0 = load_run(mem, lo + e0, nch)
                            l1, t1 = load_run(mem, lo + e1, nch)
                            byte = lambda w, i: F32((w >> (8 * i)) & 0xFF)  # noqa: E731
                            taps = [[byte(w, i) for i in range(nch)] for w in (l0, t0, l1, t1)]
                            v00, v01, v10, v11 = (np.array(t, F32) for t in taps)
                        else:
                            stats["plain"] += 1
                            ch = np.arange(nch)
                            v00, v01 = flat[e0 + ch].astype(F32), flat[e0 + nch + ch].astype(F32)
                            v10, v11 = flat[e1 + ch].astype(F32), flat[e1 + nch + ch].astype(F32)
                    else:  # sample_point: a tap outside the source reads the border
                        stats["border"] += 1
                        vx = (fx0 >= 0 and fx0 < src_w, fx0 >= -1 and fx0 < src_w - 1)
                        vy = (fy0 >= 0 and fy0 < src_h, fy0 >= -1 and fy0 < src_h - 1)

                        def tap(i, j):
                            if not (vx[i] and vy[j]):
                                return b[:nch].astype(F32)
                            e = ((int(fy0) + j) * src_w + int(fx0) + i) * nch
                            return flat[e + np.arange(nch)].astype(F32)

                        v00, v01, v10, v11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
                    out[z, y, x] = lerp(lerp(v00, v01, wx[x]), lerp(v10, v11, wx[x]), wy[x])
    return out, stats


def rotation(center, angle, scale, to=None):
    a = np.deg2rad(angle)
    al, be = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    m = np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])
    if to is not None:
        m[:, 2] += (to[0] - cx, to[1] - cy)
    return m


def _check_warp(read, offset=0, batch=False):
    pipeline = T.build_pipeline(read, T.write_tensor() if batch else T.write())
    a = kw.prepare(pipeline, kw.build_plan(pipeline), CPU)
    out, stats = emulate_warp(a, offset)
    ref = kw.warp_reference(a).numpy()
    ref = ref if batch else ref[None]
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.array_equal(out.view(np.uint32), ref.view(np.uint32)), \
        f"{(out != ref).sum()} values differ; {stats}"
    return stats


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("nch", [1, 3, 4])
def test_packed_fetch_at_every_alignment(nch, offset):
    """A rotation whose footprint covers the source's corners: interior
    pixels fetch packed runs at every byte alignment, the first and last
    words of the buffer and every border pixel take the per-byte paths."""
    img = torch.from_numpy(_src(20 + nch, 24, 37, nch))
    m = rotation((18, 12), 9.0, 1.1, to=(24, 16))
    stats = _check_warp(T.warp(T.image(img), m, T.Size(48, 32),
                               default=tuple(float(10 * i + 1) for i in range(nch))), offset)
    assert stats["packed"] > 0 and stats["border"] > 0


def test_the_buffers_first_and_last_words_are_not_fetched_packed():
    """An identity map reads every pixel; at an odd address the threads
    whose runs start in the buffer's first word or end in its last take the
    per-byte path, those in between the packed one."""
    img = torch.from_numpy(_src(30, 6, 9, 3))
    ident = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    a = _check_warp(T.warp(T.image(img), ident, T.Size(9, 6)), offset=1)
    b = _check_warp(T.warp(T.image(img), ident, T.Size(9, 6)), offset=0)
    assert a["packed"] > 0 and a["border"] > b["border"]


def test_float32_sources_take_the_plain_interior_path():
    img = torch.from_numpy(_src(31, 24, 37, 3, np.float32))
    stats = _check_warp(T.warp(T.image(img), rotation((18, 12), -12.0, 0.9), T.Size(40, 28)))
    assert stats["packed"] == 0 and stats["plain"] > 0 and stats["border"] > 0


def test_taps_with_one_valid_side():
    """Half-pixel shifts put x0 = -1 and x0 = w - 1 (one valid tap of two)
    on the first and last columns, the same for rows."""
    img = torch.from_numpy(_src(32, 12, 16, 3))
    m = np.array([[1.0, 0.0, 1.5], [0.0, 1.0, 1.5]])
    stats = _check_warp(T.warp(T.image(img), m, T.Size(20, 16), default=(9.0, 8.0, 7.0)))
    assert stats["border"] > 0 and stats["packed"] > 0


@pytest.mark.parametrize("case", ["den_zero", "beyond_int32", "ordinary"])
def test_perspective_denominators_and_far_coordinates(case):
    img = torch.from_numpy(_src(33, 20, 28, 3))
    m = {
        # the inverse map's denominator 1 - x/8 is 0 on the output's column 8: taken as 1
        "den_zero": np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.125, 0.0, 1.0]]),
        # the inverse map scales by 1e9: coordinates far past 2^31
        "beyond_int32": np.array([[1e-9, 0.0, 3.0], [0.0, 1e-9, 5.0], [0.0, 0.0, 1.0]]),
        "ordinary": np.array([[0.9, 0.05, 1.0], [0.02, 1.1, -2.0], [1e-3, -2e-3, 1.0]]),
    }[case]
    read = T.warp(T.image(img), m, T.Size(24, 20), warp_type=T.WarpType.PERSPECTIVE,
                  default=(1.0, 2.0, 3.0))
    _check_warp(read)
    c = np.asarray(read.coeffs, np.float32).reshape(3, 3)
    if case == "den_zero":
        assert c[2, 0] * np.float32(8) + c[2, 2] == 0
    if case == "beyond_int32":
        assert abs(c[0, 0]) * 20 > 2.0 ** 31


def test_a_ragged_batch_of_one_shared_frame():
    img = T.image(torch.from_numpy(_src(34, 24, 37, 3)))
    mats = [rotation((18, 12), 5.0 * i - 8.0, 1.0 + 0.05 * i) for i in range(4)]
    stats = _check_warp(T.warp_batch([img] * 4, mats, T.Size(32, 20), used_planes=3, default=3.0),
                        offset=3, batch=True)
    assert stats["packed"] > 0


# ---------------------------------------------------------------------------
# pixel groups: the divergent kernel's copy kinds and the frame kernel
# ---------------------------------------------------------------------------

def group_block(dst_w, pix):
    """``csrc/chain.cuh::group_block``: the (x, y) threads of a block."""
    tx = 64
    while pix > 1 and tx > 16 and (tx // 2) * pix >= dst_w:
        tx //= 2
    return tx, 256 // tx


def load_pixels(mem, lo, hi, p, dtype, nch, n):
    """The ``n`` pixels of ``nch`` elements at address ``p``, element by
    element as ``csrc/chain.cuh::load_pixel`` reads them: ``(n, nch)``
    float32. Nothing outside the source buffer is read."""
    item = np.dtype(dtype).itemsize
    assert lo <= p and p + n * nch * item <= hi, (p, n, lo, hi)
    return mem[p:p + n * nch * item].view(dtype).astype(F32).reshape(n, nch)


def emulate_divergent_copy(a: kd.Launch, pix: int, offset: int = 0):
    """``divergent_kernel`` on a batch of ``image`` and ``circ`` groups,
    before the chains: ``(values (N, H, W, C) float32, stats)``. Everything
    is read as the kernel reads it, from the parameter block: the group
    table, the address table, the 16-word descriptors at a multiple of 4
    words, ``first``."""
    plan = a.plan
    dst_w, dst_h = plan.dsize
    blk = a.block.numpy()
    assert a.desc_off % 4 == 0 and a.ptr_off % 2 == 0
    ptrs = blk[a.ptr_off:a.ptr_off + 2 * plan.n_planes].view(np.uint64)
    by_ptr = {s.data_ptr(): s for s in a.srcs}
    placed = {}
    out = np.zeros((plan.n_planes, dst_h, dst_w, plan.out_ch), F32)
    stats = {"pixels": 0, "threads": 0, "tails": 0}
    tx, ty = group_block(dst_w, pix)
    grid = (-(-dst_w // (tx * pix)), -(-dst_h // ty))
    for z in range(plan.n_planes):
        d = blk[a.desc_off + kd.DESC_INTS * int(blk[z]):][:kd.DESC_INTS]
        kind, src_h, src_w, nch, u8, n_src, first_off, asc = (int(v) for v in d[:8])
        assert kd.KINDS[kind] in ("image", "circ")
        src = by_ptr[int(ptrs[z])].numpy()
        assert (src.dtype == np.uint8) == bool(u8)
        item = src.dtype.itemsize
        if id(src) not in placed:
            placed[id(src)] = place(src, offset * item)
        mem, lo, hi = placed[id(src)]
        pz = z
        if kd.KINDS[kind] == "circ":
            first = int(blk[first_off])
            pz = (first + z if asc else first - z) % n_src  # Python's % is the floor modulo
        for by in range(grid[1]):
            for bx in range(grid[0]):
                for t_y in range(ty):
                    for t_x in range(tx):
                        x, y = (bx * tx + t_x) * pix, by * ty + t_y
                        if x >= dst_w or y >= dst_h:
                            continue
                        stats["threads"] += 1
                        n = min(pix, dst_w - x)
                        stats["pixels"] += n
                        stats["tails"] += n < pix
                        p = lo + (((pz * src_h + y) * src_w + x) * nch) * item
                        out[z, y, x:x + n, :nch] = load_pixels(mem, lo, hi, p, src.dtype, nch, n)
    return out, stats


def _copy_launch(src_a, src_b, first, ascendent=True):
    """Even planes read the stack ``src_a`` as an image, odd ones the ring
    ``src_b`` from ``first``; no chain, so the batch holds the raw values."""
    seqs = (T.build_operation_sequence(T.image(torch.from_numpy(src_a)), T.write_tensor()),
            T.build_operation_sequence(
                T.circular_batch_read(torch.from_numpy(src_b), first=first, ascendent=ascendent),
                T.write_tensor()))
    ids = [1 + z % 2 for z in range(src_a.shape[0])]
    return kd.prepare(seqs, kd.build_plan(seqs, ids), CPU)


def _check_copy(a, pix, offset=0):
    out, stats = emulate_divergent_copy(a, pix, offset)
    ref = kd.divergent_reference(a).numpy()
    assert out.shape == ref.shape
    assert np.array_equal(out.astype(ref.dtype), ref), f"{(out != ref).sum()} values differ; {stats}"
    return stats


def _stack(seed, n, h, w, c, dtype):
    v = np.random.default_rng(seed).integers(0, 256, (n, h, w, c))
    return v.astype(np.uint8) if dtype == np.uint8 else (v / F32(3)).astype(F32)


@pytest.mark.parametrize("pix", [1, 4])
@pytest.mark.parametrize("nch", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_copy_kinds_read_each_pixel_once(dtype, nch, pix):
    a = _copy_launch(_stack(40, 4, 6, 16, nch, dtype), _stack(41, 4, 6, 16, nch, dtype), first=1)
    stats = _check_copy(a, pix)
    assert stats["pixels"] == 4 * 6 * 16 and stats["threads"] == 4 * 6 * 16 // pix
    assert stats["tails"] == 0


@pytest.mark.parametrize("width", [16, 12, 7, 5, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_copy_kinds_take_row_pitches_and_widths_of_any_alignment(dtype, width):
    """3-channel rows of 48, 36, 21, 15 and 9 elements; a width off the
    group of 4 leaves a tail of 1 to 3 pixels in every row."""
    a = _copy_launch(_stack(42, 4, 5, width, 3, dtype), _stack(43, 4, 5, width, 3, dtype), first=-3)
    stats = _check_copy(a, 4)
    assert stats["pixels"] == 4 * 5 * width
    assert stats["tails"] == (4 * 5 if width % 4 else 0)


@pytest.mark.parametrize("offset", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_copy_kinds_at_a_source_view_off_the_vector(dtype, offset):
    """A source ``offset`` elements past an aligned address: nothing before
    the buffer's first or past its last element is read."""
    a = _copy_launch(_stack(44, 2, 4, 8, 3, dtype), _stack(45, 2, 4, 8, 3, dtype), first=0)
    _check_copy(a, 4, offset)
    four = _copy_launch(_stack(46, 2, 4, 8, 4, dtype), _stack(47, 2, 4, 8, 4, dtype), first=0)
    _check_copy(four, 4, offset)


@pytest.mark.parametrize("ascendent", [True, False])
@pytest.mark.parametrize("first", [-9, -1, 0, 3, 4, 11])
def test_copy_kinds_wrap_first_both_ways(first, ascendent):
    ring = _stack(48, 4, 3, 8, 3, np.uint8)
    ring[..., 0] = np.arange(4, dtype=np.uint8)[:, None, None]  # a plane names itself
    a = _copy_launch(_stack(49, 4, 3, 8, 3, np.uint8), ring, first, ascendent)
    out, _ = emulate_divergent_copy(a, 4)
    for z in (1, 3):
        assert out[z, 0, 0, 0] == ((first + z) if ascendent else (first - z)) % 4
    _check_copy(a, 4)


def test_group_blocks():
    assert group_block(1920, 1) == (64, 4) and group_block(64, 1) == (64, 4)
    assert group_block(1920, 4) == (64, 4) and group_block(256, 4) == (64, 4)
    assert group_block(255, 4) == (64, 4) and group_block(128, 4) == (32, 8)
    assert group_block(64, 4) == (16, 16) and group_block(3, 4) == (16, 16)
    for w in range(1, 400):
        for pix in (1, 2, 4):
            tx, ty = group_block(w, pix)
            assert tx * ty == 256 and tx in (16, 32, 64)


def bilerp_values(a, b, d, e, wx, wy, keep):
    """``csrc/frame_resize.cuh::bilerp_values``."""
    h0, h1 = a, d
    if not (keep and wx == 0):
        h0, h1 = lerp(a, b, wx), lerp(d, e, wx)
    return h0 if keep and wy == 0 else lerp(h0, h1, wy)


def emulate_frame_resize(a: kfr.Launch, pix: int, offset: int = 0):
    """``frame_resize_kernel`` before its chain: ``(values (H, W, C)
    float32, stats)``; ``stats`` counts the threads and the row tails. A
    thread reads its row's taps once, then each of its pixels' taps element
    by element; no address leaves the source buffer."""
    plan = a.plan
    dst_w, dst_h = plan.dsize
    taps, wts = a.taps.numpy(), a.weights.numpy()
    x0s, x1s, y0s, y1s = (taps[o:o + m] for o, m in ((0, dst_w), (dst_w, dst_w),
                                                     (2 * dst_w, dst_h), (2 * dst_w + dst_h, dst_h)))
    wxs, wys = wts[:dst_w], wts[dst_w:]
    keep = plan.keep_edge
    src = a.src.numpy()
    item, nch, src_w, src_h = src.dtype.itemsize, plan.nch, plan.src_w, plan.src_h
    mem, lo, hi = place(src, offset * item)
    stats = {"threads": 0, "tails": 0}

    def elem(p):
        assert lo <= p and p + item <= hi
        return F32(mem[p:p + item].view(src.dtype)[0])

    if plan.yuv:
        ct = taps[2 * (dst_w + dst_h):]
        cx0s, cx1s, cy0s, cy1s = (ct[o:o + m] for o, m in ((0, dst_w), (dst_w, dst_w), (
            2 * dst_w, dst_h), (2 * dst_w + dst_h, dst_h)))
        limited, alpha, ys, cs, rv, gu, gv, bu = plan.conv
        ys, cs, rv, gu, gv, bu = (F32(v) for v in (ys, cs, rv, gu, gv, bu))
        out = np.zeros((dst_h, dst_w, 4 if alpha else 3), F32)
        uv = lo + src_h * src_w
        iu = 1 if plan.nv21 else 0

        def pair(row, c):
            assert uv <= row + c and row + c + 2 <= hi
            return F32(mem[row + c + iu]), F32(mem[row + c + 1 - iu])
    else:
        out = np.zeros((dst_h, dst_w, nch), F32)

    tx, ty = group_block(dst_w, pix)
    for y in range(dst_h):  # every thread row of every block: the grid covers the frame
        wy = wys[y]
        r0, r1 = lo + int(y0s[y]) * src_w * nch * item, lo + int(y1s[y]) * src_w * nch * item
        for x in range(0, -(-dst_w // (tx * pix)) * tx * pix, pix):
            if x >= dst_w:
                continue
            n = min(pix, dst_w - x)
            stats["threads"] += 1
            stats["tails"] += n < pix
            if plan.yuv:
                u0, u1 = uv + int(cy0s[y]) * src_w, uv + int(cy1s[y]) * src_w
                for q in range(n):
                    c = x + q
                    lum = bilerp_values(elem(r0 + int(x0s[c])), elem(r0 + int(x1s[c])),
                                        elem(r1 + int(x0s[c])), elem(r1 + int(x1s[c])), wxs[c], wy,
                                        keep)
                    p00, p01 = pair(u0, 2 * int(cx0s[c])), pair(u0, 2 * int(cx1s[c]))
                    p10, p11 = pair(u1, 2 * int(cx0s[c])), pair(u1, 2 * int(cx1s[c]))
                    u = bilerp_values(p00[0], p01[0], p10[0], p11[0], wxs[c], wy, keep) - F32(128)
                    w = bilerp_values(p00[1], p01[1], p10[1], p11[1], wxs[c], wy, keep) - F32(128)
                    if limited:
                        lum, u, w = (lum - F32(16)) * ys, u * cs, w * cs
                    rgb = [lum + rv * w, lum - gu * u - gv * w, lum + bu * u]
                    out[y, x + q] = rgb + ([F32(1)] if alpha else [])
                continue
            for q in range(n):
                c0, c1, wx = int(x0s[x + q]) * nch, int(x1s[x + q]) * nch, wxs[x + q]
                out[y, x + q] = [bilerp_values(
                    elem(r0 + (c0 + c) * item), elem(r0 + (c1 + c) * item),
                    elem(r1 + (c0 + c) * item), elem(r1 + (c1 + c) * item), wx, wy, keep)
                    for c in range(nch)]
    return out, stats


def _frame_launch(read):
    pipeline = T.build_pipeline(read, T.write())
    return kfr.prepare(pipeline, kfr.build_plan(pipeline), CPU)


def _check_frame(a, pix, offset=0):
    out, stats = emulate_frame_resize(a, pix, offset)
    ref = kfr.frame_resize_reference(a).numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.array_equal(out.view(np.uint32), ref.view(np.uint32)), \
        f"{(out != ref).sum()} values differ; {stats}"
    return stats


@pytest.mark.parametrize("pix", [1, 4])
@pytest.mark.parametrize("nch", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_frame_pixel_groups(dtype, nch, pix):
    a = _frame_launch(T.resize(T.image(torch.from_numpy(_src(50 + nch, 24, 36, nch, dtype))),
                               T.Size(12, 8)))
    assert a.plan.keep_edge
    stats = _check_frame(a, pix)
    assert stats["threads"] == 8 * 12 // pix and stats["tails"] == 0


@pytest.mark.parametrize("src_hw,dsize,keep", [
    ((11, 37), (35, 7), False), ((11, 41), (33, 5), False), ((40, 12), (5, 37), False),
    ((4, 7), (14, 8), True), ((6, 35), (70, 3), True), ((11, 37), (13, 7), True)])
def test_frame_output_widths_off_the_group_and_both_edge_rules(src_hw, dsize, keep):
    """More than 32 phases on an axis zero the weight at a clamped edge;
    at most 32 keep it, and an upscale then clamps an edge's two taps onto
    one column."""
    a = _frame_launch(T.resize(T.image(torch.from_numpy(_src(54, *src_hw, 3))), T.Size(*dsize)))
    assert a.plan.keep_edge == keep
    _check_frame(a, 4)
    _check_frame(a, 1)


@pytest.mark.parametrize("width", [36, 35, 33])
def test_frame_row_pitches_of_any_alignment(width):
    a = _frame_launch(T.resize(T.image(torch.from_numpy(_src(55, 16, width, 3))), T.Size(11, 5)))
    assert _check_frame(a, 4)["tails"] == 5


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_frame_reads_stay_inside_the_buffer(offset):
    """A nearly identity-sized resize reads the buffer's first and last
    pixels, at every byte alignment of the source (every address is
    asserted inside the buffer; the poison around it is never read)."""
    img = torch.from_numpy(_src(56, 6, 9, 3))
    a = _frame_launch(T.resize(T.image(img), T.Size(8, 5)))
    _check_frame(a, 1, offset)
    _check_frame(a, 4, offset)


def _nv12_read(buf, dsize, fmt=T.PixelFormat.NV12, **conv):
    return T.resize(T.fuse(T.read_yuv(torch.from_numpy(buf), pixel_format=fmt),
                           T.convert_yuv_to_rgb(out_dtype=np.float32, **conv)), T.Size(*dsize))


@pytest.mark.parametrize("pix", [1, 4])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("fmt", [T.PixelFormat.NV12, T.PixelFormat.NV21], ids=lambda f: f.name)
def test_nv12_and_nv21_at_even_and_odd_addresses(fmt, offset, pix):
    buf = np.random.default_rng(57).integers(0, 256, (24 * 3 // 2, 36), dtype=np.uint8)
    a = _frame_launch(_nv12_read(buf, (14, 8), fmt, standard=T.ColorStandard.BT709))
    stats = _check_frame(a, pix, offset)
    assert stats["tails"] == (8 if pix == 4 else 0)


@pytest.mark.parametrize("dsize,keep", [((35, 7), False), ((18, 12), True), ((72, 48), True)])
def test_nv12_edge_rules_limited_range_and_alpha(dsize, keep):
    buf = np.random.default_rng(58).integers(0, 256, (24 * 3 // 2, 36), dtype=np.uint8)
    a = _frame_launch(_nv12_read(buf, dsize, T.PixelFormat.NV21, alpha=True,
                                 color_range=T.ColorRange.LIMITED))
    assert a.plan.keep_edge == keep
    _check_frame(a, 4)


def emulate_store_pixels(values, strides, dtype, pix, base):
    """``csrc/chain.cuh::store_pixels`` for every thread of an (N, H, W, C)
    batch of float32 ``values`` written as ``dtype`` at byte address ``base``
    of a poisoned buffer with element strides ``(sn, sc, sy, sx)``:
    ``(mem, stats)``. A vector store must be aligned and whole."""
    n_planes, h, w, ch = values.shape
    sn, sc, sy, sx = strides
    item = np.dtype(dtype).itemsize
    vec = 4 * item
    elems = 1 + (n_planes - 1) * sn + (ch - 1) * sc + (h - 1) * sy + (w - 1) * sx
    mem = np.full(base + elems * item + 64, POISON, np.uint8)
    stats = {"vector": 0, "scalar": 0}

    def put(addr, vals):
        assert base <= addr and addr + len(vals) * item <= base + elems * item
        if len(vals) == 4:
            assert addr % vec == 0
        mem[addr:addr + len(vals) * item] = np.asarray(vals, F32).astype(dtype).view(np.uint8)
        stats["vector" if len(vals) == 4 else "scalar"] += 1

    for z in range(n_planes):
        for y in range(h):
            for x in range(0, w, pix):
                n = min(pix, w - x)
                o = base + (z * sn + y * sy + x * sx) * item
                v = values[z, y, x:x + n]
                if pix == 4 and n == 4 and sc == 1 and sx == ch and o % vec == 0:
                    run = v.reshape(-1)  # element j is channel j % ch of pixel j // ch
                    for k in range(ch):
                        put(o + 4 * k * item, run[4 * k:4 * k + 4])
                    continue
                for c in range(ch):
                    p = o + c * sc * item
                    if pix == 4 and n == 4 and sx == 1 and p % vec == 0:
                        put(p, v[:, c])
                    else:
                        for q in range(n):
                            put(p + q * sx * item, v[q:q + 1, c])
    return mem, stats


@pytest.mark.parametrize("pix", [1, 4])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("width", [8, 5])
@pytest.mark.parametrize("ch", [1, 3, 4])
@pytest.mark.parametrize("layout", ["packed", "split", "tsplit"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_stores_of_every_layout_fill_the_buffer_and_nothing_else(dtype, layout, ch, width, offset,
                                                                 pix):
    """Packed and planar writes, widths off the group of 4 and an output at
    an address off the vector: the stores, vector or scalar, leave exactly
    the layout's tensor in memory and the poison around it."""
    n, h, w = 2, 3, width
    values = np.random.default_rng(60).integers(0, 256, (n, h, w, ch)).astype(F32)
    strides = {"packed": (h * w * ch, 1, w * ch, ch), "split": (ch * h * w, h * w, w, 1),
               "tsplit": (h * w, n * h * w, w, 1)}[layout]
    item = np.dtype(dtype).itemsize
    base = 64 + offset * item
    mem, stats = emulate_store_pixels(values, strides, dtype, pix, base)
    want = {"packed": values, "split": values.transpose(0, 3, 1, 2),
            "tsplit": values.transpose(3, 0, 1, 2)}[layout].astype(dtype)
    size = want.size * item
    assert np.array_equal(mem[base:base + size].view(dtype), want.reshape(-1))
    assert (mem[:base] == POISON).all() and (mem[base + size:] == POISON).all()
    if pix == 1:
        assert stats["vector"] == 0
    elif offset % 4 == 0 and width % 4 == 0:
        assert stats["scalar"] == 0 and stats["vector"] == n * h * w * ch // 4


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.uint16, np.int16],
                         ids=["u8", "i8", "u16", "i16"])
@pytest.mark.parametrize("kernel", ["batch_resize", "frame_resize", "warp"])
def test_clamp_store_of_the_resampling_kernels(kernel, dtype):
    """K1, K2 and the warp kernel store a float32 chain into an integer
    buffer (``clamp_store``): each value clamped to the buffer's range, then
    truncated by the store (``chain.cuh::clamp_to_range``, ``to_out``), as
    ``utils.dtypes.astype`` casts; the wrappers' ``out=`` on the CPU equals
    it, and the plan passes clamp_store 1 and the buffer's type code."""
    img = torch.from_numpy(_src(70, 24, 32, 3))
    rects = np.array([[i, i, 10, 12] for i in range(2)], np.int32)
    module, read = {
        "batch_resize": (kbr, T.resize_batch(img, rects=rects, dsize=T.Size(8, 6))),
        "frame_resize": (kfr, T.resize(T.image(img), T.Size(8, 6))),
        "warp": (kw, T.warp(T.image(img), np.array([[0.5, 0, 1.0], [0, 0.5, 2.0]]), T.Size(8, 6))),
    }[kernel]
    pipeline = T.build_pipeline(read, T.multiply(600.0), T.subtract(70000.25), T.split_tensor())
    plan = module.build_plan(pipeline)
    td = T._dt.to_torch_dtype(dtype)
    assert plan.out_dtype == torch.float32 and module.can_store(plan, td)
    assert kbr.store_cast(plan.out_dtype, td) == 1 and kbr.TYPE_CODES[td] == _NP_TYPES.index(dtype)
    vals = module.run(pipeline, plan, CPU)
    values = (vals if vals.ndim == 4 else vals[None]).permute(0, 2, 3, 1).numpy()
    info = np.iinfo(dtype)
    assert values.min() < info.min or values.max() > info.max  # the clamp has work to do
    n, h, w, ch = values.shape
    strides = (ch * h * w, h * w, w, 1)
    item = np.dtype(dtype).itemsize
    for pix in (1, 4):
        mem, _ = emulate_store_pixels(np.clip(values, info.min, info.max), strides, dtype, pix,
                                      64)
        got = mem[64:64 + values.size * item].view(dtype).reshape(n, ch, h, w)
        want = T._dt.astype(vals, td)
        assert np.array_equal(got, (want if want.ndim == 4 else want[None]).numpy())
    view = torch.zeros(tuple(vals.shape), dtype=td)
    assert module.run(pipeline, plan, CPU, out=view) is view
    assert torch.equal(view, T._dt.astype(vals, td))


# ---------------------------------------------------------------------------
# the pointwise kernel: heads, the op table with the wide dtypes, the store
# ---------------------------------------------------------------------------

from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp  # noqa: E402

_SAT_RANGE = {kbr.OP_SAT_U8: (0, 255), kbr.OP_SAT_I8: (-128, 127), kbr.OP_SAT_U16: (0, 65535),
              kbr.OP_SAT_I16: (-32768, 32767)}
_CAST_TYPE = {kbr.OP_CAST_U8: np.uint8, kbr.OP_CAST_I8: np.int8, kbr.OP_CAST_U16: np.uint16,
              kbr.OP_CAST_I16: np.int16}
_NP_TYPES = (np.uint8, np.int8, np.uint16, np.int16, np.float32)  # csrc/chain.cuh PW_U8..


def crop_start(start, length, size):
    """``csrc/pointwise.cuh::crop_start``."""
    s = int(start)
    if s < 0:
        s += length
    return min(max(s, 0), length - size)


def fold_index(i, n, mode):
    """``csrc/pointwise.cuh::fold_index`` on an array of positions (0 at the
    source's first element); Python's % is the floor modulo."""
    if mode == 4:  # WRAP
        return i % n
    if mode == 2:  # REFLECT
        t = i % (2 * n)
        return np.where(t < n, t, 2 * n - 1 - t)
    if mode == 3:  # REFLECT_101
        if n == 1:
            return np.zeros_like(i)
        t = i % (2 * n - 2)
        return np.where(t < n, t, 2 * n - 2 - t)
    return np.clip(i, 0, n - 1)


# csrc/pointwise_chain.cuh, csrc/pointwise.cu; an H100's resident threads
STAGE_ROWS, WIDE_P, RESIDENT = 256, 16, 132 * 2048
ARITH = {kbr.OP_MUL: np.multiply, kbr.OP_ADD: np.add, kbr.OP_SUB: np.subtract,
         kbr.OP_DIV: np.divide}


def pixels_per_thread(outputs, width, stages=0, resident=RESIDENT):
    """``csrc/pointwise.cu::pixels_per_thread``."""
    if width == 1 and stages == 0 and 3 * outputs >= 8 * resident:
        return WIDE_P
    return 4 if 3 * outputs >= 4 * resident else 1


def stage_rows(words, n_ops, fp):
    """``csrc/pointwise_chain.cuh::stage_rows`` over the whole table: the
    kernel's op words (the rows, the sentinel, each row's channel count) into
    chunks of at most ``STAGE_ROWS`` records ``(code, aux, ch, q)``, ``q``
    the row's four scalars, 0 at and above its channel count."""
    words = np.asarray(words)
    assert words.size == 4 * n_ops + 1 + n_ops and words[4 * n_ops] == 0
    rows, chs = words[:4 * n_ops].reshape(-1, 4), words[4 * n_ops + 1:]
    chunks = []
    for k0 in range(0, n_ops, STAGE_ROWS):
        chunk = []
        for (code, off, stride, aux), ch in zip(rows[k0:k0 + STAGE_ROWS].tolist(),
                                                chs[k0:k0 + STAGE_ROWS].tolist()):
            q = np.zeros(4, F32)
            if code in ARITH:
                for c in range(ch):
                    q[c] = fp[off + c * stride]
            chunk.append((code, aux, ch, q))
        chunks.append(chunk)
    return chunks


def truncate_to(v, np_type):
    """``cast_u8`` .. ``cast_i16``: truncate, keep the low bits."""
    return np.trunc(v).astype(np.int64).astype(np_type).astype(F32)


def emulate_rows(v, chunk):
    """``csrc/pointwise_chain.cuh::run_rows`` on float32 values ``v`` of
    shape (..., L): every staged row on all L lanes, every float op rounded
    once; an alpha into lane ``ch``, a reorder and a gray row read lanes
    below it only."""
    lanes = v.shape[-1]
    for code, aux, ch, q in chunk:
        if code in ARITH:
            v[...] = ARITH[code](v, q[:lanes], dtype=F32)
        elif code in _SAT_RANGE:
            v[...] = np.clip(np.rint(v), *_SAT_RANGE[code])
        elif code in _CAST_TYPE:
            v[...] = truncate_to(v, _CAST_TYPE[code])
        elif code == kbr.OP_REORDER:
            if lanes == 1:
                assert aux == 1 << 16, "a one-lane chain holds no reorder but the identity"
                continue
            idx = [(aux >> (4 * c)) & 15 for c in range(4)]
            assert all(i < ch for i in idx[:aux >> 16]), "a reorder reads live lanes only"
            v[...] = v[..., [i if i <= 3 else 0 for i in idx]]  # chain.cuh::pick
        elif code == kbr.OP_ALPHA:
            assert lanes == 4 and ch < 4
            v[..., ch] = aux
        elif code in (kbr.OP_GRAY_U8, kbr.OP_GRAY_F32):
            assert lanes == 4 and all(((aux >> s) & 15) < ch for s in (0, 4, 8))
            if code == kbr.OP_GRAY_U8:
                r, g, b = (v[..., (aux >> s) & 15].astype(np.int64) for s in (0, 4, 8))
                v[..., 0] = (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15
            else:
                r, g, b = (v[..., (aux >> s) & 15] for s in (0, 4, 8))
                k = [F32(0.299), F32(0.587), F32(0.114)]
                v[..., 0] = (r * k[0] + g * k[1]) + b * k[2]
        else:
            raise AssertionError(f"op code {code}")


def emulate_pointwise(a: kp.Launch, pix=None, out=None):
    """``pointwise_kernel`` from the launch's own arguments: the head's
    words with the chain's width, the block of runtime values, the op table
    with each row's channel count, staged in chunks; the lanes and the
    pixels per thread the width and the output count choose (``pix`` given:
    that many, one lane if the chain is one channel wide); the store through
    the layout's element strides. ``(result, stats)``."""
    plan = a.plan
    hw = plan.head
    assert len(hw) == kp.HEAD_INTS
    (base, src_h, src_w, nch, src_type, n_src, first_off, asc, nv21, n_stages, conv_first,
     limited) = hw[:12]
    width = hw[kp.HEAD_INTS - 1]
    assert nch <= width and plan.out_ch <= width <= 4 and width == plan.width
    blk = a.block.numpy()
    fblk = blk.view(F32)
    dst_w, dst_h = plan.dsize
    if pix is None:
        pix = pixels_per_thread(plan.n_planes * dst_w * dst_h, width, n_stages)
    assert pix <= 4 or (width == 1 and n_stages == 0), "16 pixels: one lane, no stage"
    lanes = 1 if width == 1 and pix > 1 else 4
    src = a.src.numpy().reshape(-1)
    assert src.dtype == _NP_TYPES[src_type]
    y, x = (g.astype(np.int64) for g in np.meshgrid(np.arange(dst_h), np.arange(dst_w),
                                                    indexing="ij"))
    fill = np.full((dst_h, dst_w), -1, np.int64)
    for s in range(n_stages):
        kind, sh, sw, mode, p0, p1, p2, p3 = hw[12 + 8 * s:20 + 8 * s]
        if kind == kp.STAGE_CROP:
            x = x + crop_start(blk[p0], sw, p2)
            y = y + crop_start(blk[p1], sh, p3)
        else:
            i, j = x - p1, y - p0
            if mode == 0:
                outside = (fill < 0) & ((i < 0) | (i >= sw) | (j < 0) | (j >= sh))
                fill[outside] = p2
            x, y = fold_index(i, sw, mode), fold_index(j, sh, mode)
    live = fill < 0
    assert ((x[live] >= 0) & (x[live] < src_w) & (y[live] >= 0) & (y[live] < src_h)).all()
    x, y = np.clip(x, 0, src_w - 1), np.clip(y, 0, src_h - 1)  # filled pixels read nothing
    vals = np.zeros((plan.n_planes, dst_h, dst_w, lanes), F32)
    for z in range(plan.n_planes):
        pz = z
        if base == 1:
            first = int(blk[first_off])
            pz = (first + z if asc else first - z) % n_src
        if base == 2:
            assert lanes == 4
            uv = src_h * src_w + (y // 2) * src_w + 2 * (x // 2)
            vals[z, ..., 0] = src[y * src_w + x]
            vals[z, ..., 1] = src[uv + (1 if nv21 else 0)]
            vals[z, ..., 2] = src[uv + (0 if nv21 else 1)]
        else:
            off = ((pz * src_h + y) * src_w + x) * nch
            for c in range(nch):
                vals[z, ..., c] = src[off + c]
        for c in range(nch if not live.all() else 0):
            border = fblk[np.maximum(fill, 0) + c]
            if src_type != 4:
                border = truncate_to(border, _NP_TYPES[src_type])
            vals[z, ..., c] = np.where(live, vals[z, ..., c], border)
    if conv_first:
        assert lanes == 4
        ys, cs, rv, gu, gv, bu = (F32(c) for c in plan.conv)
        yv, u, w = vals[..., 0], vals[..., 1] - F32(128), vals[..., 2] - F32(128)
        if limited:
            yv, u, w = (yv - F32(16)) * ys, u * cs, w * cs
        vals[..., 0], vals[..., 1], vals[..., 2] = (yv + rv * w, (yv - gu * u) - gv * w,
                                                    yv + bu * u)
        vals[..., 3] = 1
    n_ops = plan.ops.shape[0]
    chunks = stage_rows(a.ops.numpy(), n_ops, fblk[plan.fp_off:])
    assert [r[2] for chunk in chunks for r in chunk] == plan.row_ch.tolist()
    with np.errstate(all="ignore"):
        for chunk in chunks:
            emulate_rows(vals, chunk)
    ch = plan.out_ch
    buf, (sn, sc, sy, sx), result = kp._alloc_out(plan, CPU, out)
    np_out = _NP_TYPES[kp.TYPE_CODES[buf.dtype]]
    item = buf.element_size()
    if kbr.store_cast(plan.out_dtype, buf.dtype):
        info = np.iinfo(np_out)
        vals = np.clip(vals, info.min, info.max)
    flat = torch.as_strided(buf, (buf.untyped_storage().nbytes() // buf.element_size(),),
                            (1,), 0).numpy()
    zi, yi, xi, ci = np.meshgrid(np.arange(plan.n_planes), np.arange(dst_h), np.arange(dst_w),
                                 np.arange(ch), indexing="ij")
    flat[buf.storage_offset() + zi * sn + ci * sc + yi * sy + xi * sx] = (
        np.trunc(vals[..., :ch]).astype(np.int64).astype(np_out) if np_out != F32
        else vals[..., :ch])
    # the thread groups: x0 of each, how many of its pixels are present, and
    # which whole-word paths its read and its store take
    x0 = np.arange(0, dst_w, pix)
    n = np.minimum(pix, dst_w - x0)
    whole = int((n == pix).sum())
    groups = plan.n_planes * dst_h * len(x0)
    stats = {"threads": groups, "tails": plan.n_planes * dst_h * (dst_w % pix != 0),
             "lanes": lanes, "pix": pix, "chunks": len(chunks), "run_reads": 0,
             "nv12_words": 0, "pixel_words": 0, "word_stores": 0}
    if n_stages == 0 and pix > 1 and (lanes == 1 or base == 2):
        # whole runs; a one-lane row's tail is read element by element
        stats["run_reads" if lanes == 1 else "nv12_words"] = plan.n_planes * dst_h * whole
    src_item = a.src.element_size()
    if lanes == 4 and pix == 4 and base != 2 and nch in (3, 4) and src_item != 2:
        # four whole adjacent live pixels as words (load_pixels4), where aligned
        word = 16 if (4 * nch * src_item) % 16 == 0 else 4
        for z in range(plan.n_planes):
            pz = z if base != 1 else ((int(blk[first_off]) + z if asc else int(blk[first_off]) - z)
                                      % n_src)
            for g0 in range(0, dst_w - 3, 4):
                xg, yg, lg = x[:, g0:g0 + 4], y[:, g0], live[:, g0:g0 + 4]
                run = lg.all(axis=1) & (np.diff(xg, axis=1) == 1).all(axis=1)
                addr = a.src.data_ptr() + ((pz * src_h + yg) * src_w + xg[:, 0]) * nch * src_item
                stats["pixel_words"] += int((run & (addr % word == 0)).sum())
    zg, yg, xg = np.meshgrid(np.arange(plan.n_planes), np.arange(dst_h), x0[n == pix],
                             indexing="ij")
    addr = buf.data_ptr() + (zg * sn + yg * sy + xg * sx) * item
    if lanes == 1 and pix > 1 and sx == 1 and pix * item >= 4:
        vec = min(pix * item, 16)
        stats["word_stores"] = int((addr % vec == 0).sum())
    return result, stats


def _check_pointwise(*ops, pix=4):
    p = T.build_pipeline(*ops)
    a = kp.prepare(p, kp.build_plan(p), CPU)
    got, stats = emulate_pointwise(a, pix)
    want = kp.pointwise_reference(a)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        assert torch.equal(g, w), f"{int((g != w).sum())} values differ"
    return a.plan, stats


def _pw_source(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.integers(-300, 600, shape) / F32(3)).astype(F32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


PW_DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.float32]
PW_IDS = ["u8", "i8", "u16", "i16", "f32"]


@pytest.mark.parametrize("pix", [1, 4])
@pytest.mark.parametrize("nch", [1, 3, 4])
@pytest.mark.parametrize("dtype", PW_DTYPES, ids=PW_IDS)
def test_pointwise_image_heads_of_every_dtype(dtype, nch, pix):
    """A single image and a stack, a width off the group of 4: an arithmetic
    chain saturates to the source's own integer range after every op."""
    img = _pw_source(70, (5, 7, nch), dtype)
    _, stats = _check_pointwise(T.image(img), T.multiply(1.7), T.add(-20.5), T.write(), pix=pix)
    assert stats["threads"] == 5 * -(-7 // pix) and stats["tails"] == (5 if pix == 4 else 0)
    stack = _pw_source(71, (3, 4, 8, nch), dtype)
    _check_pointwise(T.image(stack), T.subtract(3.25), T.divide(0.5), T.split_tensor(), pix=pix)


@pytest.mark.parametrize("dst", PW_DTYPES, ids=PW_IDS)
@pytest.mark.parametrize("src", PW_DTYPES, ids=PW_IDS)
@pytest.mark.parametrize("kind", ["saturate", "truncate"])
def test_pointwise_casts_between_every_pair_of_dtypes(kind, src, dst):
    """``SaturateCast`` rounds half to even and clamps; ``Cast`` truncates and
    keeps the low bits; both through the wide table's rows. Values in range
    of the target for the truncating cast (out of range it is undefined in
    PyTorch too)."""
    img = _pw_source(72, (4, 6, 3), src)
    if kind == "truncate":
        if dst != np.float32:
            info = np.iinfo(dst)
            img = np.clip(img.astype(np.float64), info.min, info.max).astype(src)
        cast = T.Cast(dst=T._dt.to_torch_dtype(dst))
    else:
        cast = T.convert_to(dst)
    plan, _ = _check_pointwise(T.image(img), cast, T.multiply(0.75), T.write())
    assert plan.out_dtype == T._dt.to_torch_dtype(dst)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("ascendent", [True, False])
@pytest.mark.parametrize("first", [-9, -1, 0, 3, 11])
def test_pointwise_ring_reads_by_the_floor_modulo(first, ascendent, packed):
    ring = _pw_source(73, (4, 3, 8, 3), np.uint8)
    ring[..., 0] = np.arange(4, dtype=np.uint8)[:, None, None]  # a plane names itself
    data = ring if packed else torch.from_numpy(ring)  # a host ring is packed by the factory
    p = T.build_pipeline(T.circular_batch_read(data, first=first, ascendent=ascendent),
                         T.write_tensor())
    a = kp.prepare(p, kp.build_plan(p), CPU)
    out, _ = emulate_pointwise(a, 4)
    for z in range(4):
        assert int(out[z, 0, 0, 0]) == ((first + z) if ascendent else (first - z)) % 4
    _check_pointwise(T.circular_batch_read(data, first=first, ascendent=ascendent),
                     T.convert_to(np.float32, alpha=0.5), T.split_tensor_transposed())


@pytest.mark.parametrize("origin", [(0, 0), (3, 2), (-3, -2), (-100, 1), (100, 100), (15, 7),
                                    (-20, -12), (-21, -13)])
def test_pointwise_crop_starts_follow_crop_start(origin):
    """Negative origins count from the far edge, then every start clamps so
    that the crop lies inside the source (``ops/crop.py::crop_start``)."""
    from cvgpuspeedup_tpu_torch.ops.crop import crop_start as torch_crop_start

    img = _pw_source(74, (12, 20, 3), np.uint8)
    x0, y0 = origin
    assert crop_start(x0, 20, 5) == int(torch_crop_start(x0, 20, 5, CPU))
    assert crop_start(y0, 12, 4) == int(torch_crop_start(y0, 12, 4, CPU))
    _check_pointwise(T.crop(T.image(img), T.Rect(x0, y0, 5, 4)), T.write())
    _check_pointwise(T.crop(T.image(_pw_source(75, (2, 12, 20, 3), np.int16)), T.Rect(x0, y0, 5, 4)),
                     T.convert_to(np.float32), T.split_tensor())


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("mode", [T.BorderMode.REPLICATE, T.BorderMode.REFLECT,
                                  T.BorderMode.REFLECT_101, T.BorderMode.WRAP], ids=lambda m: m.name)
def test_pointwise_border_folds_as_numpy_pad(mode, n):
    """Borders narrower and (several times) wider than the source fold as
    ``numpy.pad`` does, on the index map and through a whole launch."""
    from cvgpuspeedup_tpu_torch.ops.border import border_index

    for before, after in ((0, 0), (1, 2), (n, n), (2 * n + 1, 3 * n + 2), (7 * n, 0)):
        want = border_index(n, before, after, mode)
        got = fold_index(np.arange(n + before + after) - before, n, kp.BORDER_MODES[mode])
        assert np.array_equal(got, want), (before, after)
    img = _pw_source(76, (n, n + 1, 3), np.uint8)
    _check_pointwise(T.make_border(T.image(img), 2 * n + 1, 1, 3, 3 * n + 2, mode), T.write())


@pytest.mark.parametrize("dtype", PW_DTYPES, ids=PW_IDS)
@pytest.mark.parametrize("value", [7.0, (1.0, 2.9, 250.0)], ids=["scalar", "per_channel"])
def test_pointwise_constant_border_holds_the_value_in_the_sources_dtype(value, dtype):
    if dtype == np.int8 and not np.isscalar(value):
        value = (1.0, -2.9, 120.0)
    img = _pw_source(77, (6, 9, 3), dtype)
    _check_pointwise(T.make_border(T.image(img), 2, 3, 1, 4, T.BorderMode.CONSTANT, value=value),
                     T.convert_to(np.float32, alpha=0.5), T.split_tensor())


def test_pointwise_border_over_crop_over_ring_and_crop_over_border():
    """The stages nest in the order ``lower()`` applies them, outermost last:
    a border of a crop of a ring, a crop of a constant border of a reflected
    border."""
    ring = torch.from_numpy(_pw_source(78, (4, 10, 12, 3), np.uint8))
    head = T.make_border(T.crop(T.circular_batch_read(ring, first=2), T.Rect(3, -4, 6, 5)),
                         2, 1, 3, 2, T.BorderMode.REFLECT_101)
    plan, _ = _check_pointwise(head, T.convert_to(np.float32, alpha=1 / 255.0), T.split_tensor())
    assert plan.head[9] == 2 and plan.dsize == T.Size(11, 8)
    img = _pw_source(79, (7, 9, 3), np.uint8)
    inner = T.make_border(T.image(img), 2, 2, 2, 2, T.BorderMode.REFLECT)
    outer = T.make_border(inner, 3, 3, 3, 3, T.BorderMode.CONSTANT, value=(9.0, 8.0, 7.0))
    plan, _ = _check_pointwise(T.crop(outer, T.Rect(1, 2, 15, 12)), T.write())
    assert plan.head[9] == 3


@pytest.mark.parametrize("fmt", [T.PixelFormat.NV12, T.PixelFormat.NV21], ids=lambda f: f.name)
@pytest.mark.parametrize("color_range", list(T.ColorRange), ids=lambda r: r.name)
@pytest.mark.parametrize("out_dtype,alpha", [(np.uint8, True), (np.uint8, False),
                                             (np.float32, True), (np.int16, False)])
def test_pointwise_nv12_reads_its_chroma_at_half_resolution(out_dtype, alpha, color_range, fmt):
    """Y at (y, x), the pair at (y / 2, x / 2); YUV -> RGB in the reference's
    op order, then the saturate and the alpha as rows of the table."""
    buf = _pw_source(80, (12, 10), np.uint8)
    for standard in T.ColorStandard:
        _check_pointwise(T.read_yuv(buf, fmt),
                         T.convert_yuv_to_rgb(color_range, standard, alpha, out_dtype), T.write())
    _check_pointwise(T.crop(T.read_yuv(buf, fmt), T.Rect(3, 1, 5, 6)),
                     T.convert_yuv_to_rgb(color_range, alpha=alpha, out_dtype=out_dtype),
                     T.split_tensor())


@pytest.mark.parametrize("write", [T.write_tensor, T.split_tensor, T.split_tensor_transposed,
                                   T.split_tensor_packed, T.split], ids=lambda w: w.__name__)
def test_pointwise_writes_every_batched_layout(write):
    stack = _pw_source(81, (3, 4, 8, 3), np.uint8)
    _check_pointwise(T.image(stack), T.cvt_color(T.ColorConversionCode.COLOR_RGB2BGRA),
                     T.convert_to(np.float32, alpha=1 / 255.0), write())


@pytest.mark.parametrize("write", [T.write, T.split_tensor, T.split], ids=lambda w: w.__name__)
def test_pointwise_writes_every_single_layout(write):
    img = _pw_source(82, (5, 6, 4), np.float32)
    _check_pointwise(T.image(img), T.cvt_color(T.ColorConversionCode.COLOR_BGRA2GRAY),
                     T.vector_reorder(0), T.multiply(2.0), write())


def test_pointwise_mad_chain_unrolls_into_one_table():
    """The reference's stress chain: 200 multiplies and adds on one channel,
    each rounded once, unrolled by the encoder into 200 rows over 2 scalars."""
    img = _pw_source(83, (8, 8, 1), np.float32)
    body = T.fuse(T.multiply(1.0009765625), T.add(0.001))
    plan, _ = _check_pointwise(T.image(img), T.static_loop(body, 100), T.write())
    assert plan.ops.shape == (200, 4) and plan.n_block == 2


@pytest.mark.parametrize("ring_dtype", PW_DTYPES, ids=PW_IDS)
@pytest.mark.parametrize("layout", ["packed", "standard", "transposed"])
def test_pointwise_stores_into_a_strided_slot(layout, ring_dtype):
    """``out=`` a ring slot of any strides: an integer chain into a float32
    ring is exact, a float32 chain into an integer ring clamps, then
    truncates (``utils.dtypes.astype``)."""
    img = _pw_source(84, (5, 6, 3), np.uint8)
    td = T._dt.to_torch_dtype(ring_dtype)
    ring = torch.zeros({"packed": (4, 5, 6, 3), "standard": (4, 3, 5, 6),
                        "transposed": (3, 4, 5, 6)}[layout], dtype=td)
    view = ring[:, 2] if layout == "transposed" else ring[2]
    write = T.write() if layout == "packed" else T.split_tensor()
    for chain in ((), (T.convert_to(np.float32, alpha=1.7), T.add(-70.25))):
        p = T.build_pipeline(T.image(img), *chain, write)
        plan = kp.build_plan(p)
        a = kp.prepare(p, plan, CPU)
        if not kp.can_store(plan, td):
            assert plan.out_dtype == torch.uint8 and td not in (torch.uint8, torch.float32)
            continue
        want = T._dt.astype(kp.pointwise_reference(a), td)
        got, _ = emulate_pointwise(a, 4, out=view)
        assert got is view and torch.equal(view, want)
        assert float(ring.to(torch.float64).abs().sum()) == float(view.to(torch.float64).abs().sum())
        assert torch.equal(kp.pointwise(a, out=torch.zeros_like(view)), want)


# ---------------------------------------------------------------------------
# the pointwise kernel's staged chain: chunks, the chain's width and lanes,
# one-lane groups of 8 and 16
# ---------------------------------------------------------------------------


def _mad(n):
    return T.static_loop(T.fuse(T.multiply(1.0009765625), T.add(0.001)), n)


@pytest.mark.parametrize("pix", [None, 1, 4])
@pytest.mark.parametrize("nch,dtype", [(1, np.float32), (3, np.uint8), (4, np.int16)],
                         ids=["1ch_f32", "3ch_u8", "4ch_i16"])
def test_pointwise_chain_longer_than_one_staging_chunk(nch, dtype, pix):
    """300 rows are staged in two chunks, the block synchronizing between
    them; a one-channel chain takes the one-lane instance under groups."""
    img = _pw_source(85, (6, 9, nch), dtype)
    plan, stats = _check_pointwise(T.image(img), T.convert_to(np.float32), _mad(150), T.write(),
                                   pix=pix)
    assert plan.ops.shape[0] == 300 and stats["chunks"] == 2 and plan.width == nch
    assert stats["lanes"] == (1 if nch == 1 and stats["pix"] > 1 else 4)


@pytest.mark.parametrize("pix", [1, 4])
def test_pointwise_chains_whose_width_changes(pix):
    """RGB -> RGBA -> multiply -> RGB is four channels wide at its widest;
    RGBA -> GRAY with a long one-channel tail too: a chain that narrows to
    one channel still holds four lanes, and each row sees its own count."""
    C = T.ColorConversionCode
    rgb = _pw_source(86, (5, 11, 3), np.uint8)
    plan, stats = _check_pointwise(
        T.image(rgb), T.cvt_color(C.COLOR_RGB2RGBA), T.convert_to(np.float32, alpha=0.5),
        T.multiply((1.0, 2.0, 0.5, 3.0)), T.cvt_color(C.COLOR_RGBA2RGB), T.split_tensor(), pix=pix)
    assert plan.width == 4 and plan.out_ch == 3 and stats["lanes"] == 4
    assert plan.row_ch[0] == 3 and max(plan.row_ch) == 4 and plan.row_ch[-1] == 4
    rgba = _pw_source(87, (4, 13, 4), np.float32)
    plan, stats = _check_pointwise(T.image(rgba), T.cvt_color(C.COLOR_RGBA2GRAY), _mad(40),
                                   T.write(), pix=pix)
    assert plan.width == 4 and plan.out_ch == 1 and stats["lanes"] == 4
    assert plan.row_ch.tolist() == [4] + [1] * 80


_SCALARS = (1.5, -0.75, 3.0, 0.5)
_ROW_OPS = {
    "multiply": lambda n: (T.multiply(_SCALARS[:n]),),
    "add": lambda n: (T.add(_SCALARS[:n]),),
    "subtract": lambda n: (T.subtract(2.25),),
    "divide": lambda n: (T.divide(_SCALARS[:n]),),
    "sat_u8": lambda n: (T.convert_to(np.uint8),),
    "sat_i8": lambda n: (T.convert_to(np.int8),),
    "sat_u16": lambda n: (T.convert_to(np.uint16, alpha=300.0),),
    "sat_i16": lambda n: (T.convert_to(np.int16, alpha=-400.0),),
    "cast_u8": lambda n: (T.multiply(0.5), T.add(50.0), T.Cast(dst=torch.uint8)),
    "cast_i8": lambda n: (T.multiply(0.5), T.Cast(dst=torch.int8)),
    "cast_u16": lambda n: (T.add(100.5), T.Cast(dst=torch.uint16)),
    "cast_i16": lambda n: (T.multiply(-7.5), T.Cast(dst=torch.int16)),
}


@pytest.mark.parametrize("nch", [1, 2, 3, 4])
@pytest.mark.parametrize("op", list(_ROW_OPS))
def test_pointwise_every_row_on_every_channel_count(op, nch):
    """Each arithmetic row and each row of the wide table, on 1 to 4
    channels, under one and four lanes: the lanes above a row's count take
    0 scalars and are never stored."""
    img = _pw_source(88, (3, 10, nch), np.float32)
    ops = _ROW_OPS[op](nch)
    for pix in (1, 4):
        plan, stats = _check_pointwise(T.image(img), *ops, T.write(), pix=pix)
        assert stats["lanes"] == (1 if nch == 1 and pix == 4 else 4)
        assert plan.row_ch.tolist() == [nch] * plan.ops.shape[0]


@pytest.mark.parametrize("pix", [8, 16])
@pytest.mark.parametrize("width", [16, 37, 5])
@pytest.mark.parametrize("dtype", PW_DTYPES, ids=PW_IDS)
def test_pointwise_one_lane_groups_with_row_tails(dtype, width, pix):
    """Groups of 8 and 16 pixels of a one-channel source: the whole groups
    of a row are read as runs, a row's tail pixel by pixel; planar and
    packed stores of one channel are the same run."""
    img = _pw_source(89, (3, width, 1), dtype)
    plan, stats = _check_pointwise(T.image(img), T.multiply(1.5), T.add(-2.25), T.write(),
                                   pix=pix)
    full = width // pix
    assert plan.width == 1 and stats["lanes"] == 1 and stats["threads"] == 3 * -(-width // pix)
    assert stats["run_reads"] == 3 * full and stats["tails"] == (3 if width % pix else 0)
    assert stats["word_stores"] <= 3 * full
    stack = _pw_source(90, (2, 3, width, 1), dtype)
    _, stats = _check_pointwise(T.image(stack), T.convert_to(np.float32, alpha=0.25),
                                T.split_tensor(), pix=pix)
    assert stats["run_reads"] == 6 * full
    # a stage above the base: 4 pixels at most, walked and gathered
    crop = T.crop(T.image(_pw_source(91, (5, width + 3, 1), dtype)), T.Rect(1, 2, width, 3))
    _, stats = _check_pointwise(crop, T.add(1.0), T.write(), pix=4)
    assert stats["lanes"] == 1 and stats["run_reads"] == 0


@pytest.mark.parametrize("outputs,width,stages,want", [
    (2048 * 2048, 1, 0, 16), (1920 * 1080, 1, 0, 16), (1920 * 1080, 1, 1, 4),
    (1024 * 1024, 1, 0, 16), (768 * 768, 1, 0, 4), (256 * 256, 1, 0, 1), (2048 * 2048, 3, 0, 4),
    (1920 * 1080, 4, 0, 4), (256 * 256, 3, 2, 1)])
def test_pointwise_pixels_per_thread_follow_the_width(outputs, width, stages, want):
    """On an H100 (132 SMs x 2048 threads): 16 pixels per thread for a
    one-channel chain on a base with no stage from 720,896 outputs, else 4
    from 360,448."""
    assert pixels_per_thread(outputs, width, stages) == want


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_pointwise_nv12_groups_and_rgba_word_stores(offset):
    """A bare NV12 -> RGBA u8 conversion: whole groups of 4 read one luma
    and one chroma word; the RGBA groups go out through store_any into a
    view on a 16-byte address and off it alike."""
    buf = _pw_source(92, (12, 16), np.uint8)
    p = T.build_pipeline(T.read_yuv(buf), T.convert_yuv_to_rgb(alpha=True), T.write())
    plan = kp.build_plan(p)
    a = kp.prepare(p, plan, CPU)
    assert plan.width == 4 and plan.out_ch == 4
    storage = torch.zeros(8 * 16 * 4 + 64, dtype=torch.uint8)
    shift = (-storage.data_ptr()) % 16 + offset
    view = storage[shift:shift + 8 * 16 * 4].view(8, 16, 4)
    got, stats = emulate_pointwise(a, 4, out=view)
    assert got is view and torch.equal(view, kp.pointwise_reference(a))
    assert stats["nv12_words"] == 8 * 4 and stats["word_stores"] == 0


@pytest.mark.parametrize("nch,dtype", [(3, np.uint8), (4, np.uint8), (3, np.float32),
                                       (4, np.float32), (3, np.int16)],
                         ids=["3ch_u8", "4ch_u8", "3ch_f32", "4ch_f32", "3ch_i16"])
def test_pointwise_whole_pixel_groups_read_as_words(nch, dtype):
    """Four adjacent pixels of 3 or 4 channels of 1 or 4 bytes whose source
    columns follow each other are read as words where aligned: every group
    of an image with no stage, the groups a border leaves in order, none of
    a 16-bit source."""
    img = _pw_source(93, (3, 16, nch), dtype)
    _, stats = _check_pointwise(T.image(img), T.convert_to(np.float32, alpha=0.5),
                                T.split_tensor(), pix=4)
    if dtype == np.int16:
        assert stats["pixel_words"] == 0
    else:
        assert 0 < stats["pixel_words"] <= 3 * 4
    border = T.make_border(T.image(img), 1, 1, 4, 4, T.BorderMode.REFLECT)
    _, stats = _check_pointwise(border, T.convert_to(np.float32), T.split_tensor(), pix=4)
    assert stats["pixel_words"] <= 5 * 6
