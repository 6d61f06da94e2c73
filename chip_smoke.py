#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``cvgpuspeedup_tpu_torch/csrc`` and drives the port's main paths through the
public entry points: the flagship batched crop-resize (kernel
``batch_resize``), the two full-frame paths (kernel ``frame_resize``),
(a) a 1080p RGB u8 frame -> 640x360 with ImageNet normalization and (b) a 6K
NV12 buffer -> 1920x1080 RGB f32 (bt709, x1/255), both written planar, and
the warp path (kernel ``warp``): eight rotations of one shared 1080p frame
in one launch, ragged at 7 planes, -> 640x360 x1/255 planar, and one
rotation of it; the divergent path (kernel ``divergent``,
``launch_divergent_batch``) at the reference's divergent rows; a
32-deep ``CircularTensor`` of 1080p frames resized into 128x64 planes; the
pointwise path (kernel ``pointwise``): every pipeline with no resampling
head, P1 the reference's 200-op multiply-add chain on 2048x2048 f32, P2 a
ring read from ``first`` = 3, P3 a 1080p frame with an 8-pixel border in each
mode, P4 crops at a negative and an overhanging origin, P5 a bare 1080p
NV12/NV21 -> RGBA conversion, P6 int16 and uint16 chains; the four
presets, the cv2-typed shim and the frame loader through their public calls;
and the batch axis of the flagship, W6, P2, D1 and D3 sharded over a device
mesh (``parallel/mesh.py``).
In phases; any failure ends the run with a non-zero exit
code and no result line:

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build: compile every kernel source, in parallel, into one library (timed);
3. each kernel against its plain PyTorch version on the card. batch_resize at
   the flagship shapes (3840x2160 u8 frame, 50 crops -> 64x128): every
   aspect-ratio mode, ragged ``used_planes``, stack mode, a uint8 chain,
   every write layout, a float32 source with rects off the frame edge, rects
   left of and above the frame with a gray conversion, and the tiled
   kernel's own paths: a letterbox border through a thread's pixels, an
   output width off the pixel group, a source view at an odd address, row
   pitches off 16 and off 4 bytes, a uint8 output off the group. frame_resize at the
   frame paths' sizes: (a), (b), a >32-phase ratio, an upscale, a uint8
   chain with ``split()``, NV21 limited range with alpha, BGR -> RGBA, and
   the pixel groups' paths (h-o): a width off the group of 4 with a packed
   write, source views at an odd address, a row pitch of no alignment,
   uint8 vector stores, a float32 RGBA source, NV12 and NV21 under 4 pixels
   and 1 pixel per thread.
   warp on a 1080p frame, a case per class of the reference's warp kernels
   (W1 separable, W2 rotation, W3 flip, W4 upscaled rotation, W5
   perspective, W6 the batch of eight) and a uint8 chain on 4 channels with
   a per-channel border (W7), a float32 source (W8) and the packed tap
   fetch's exits (W9-W13: a source view at an odd address, taps with one
   valid side, a perspective denominator that crosses 0, coordinates past
   int32, one channel). divergent in D1-D7:
   a 16-plane ring read by two sequences from first = 3 and -5, eight NV12
   cameras with pass-through planes (and NV21 limited range), crops of the
   flagship frame with pass-through, warp | crop | pass, a whole-plane stack
   resize with an image group, a uint8 chain, D4 written planar, and D8-D14:
   groups of both output dtypes in one batch (each way round), a ring view
   at an odd address with rows of 253 pixels, a float32 RGBA ring into
   planar uint8, the sampled kinds under 4 pixels per thread, and ragged
   BatchRead groups of warps and of images (D14). pointwise
   in P1-P10 bit for bit: P7-P10 run the staged chain's own paths (300-row
   chains on four lanes and one, chains whose width changes, one-channel
   groups of 16 with a row's tail, NV12 into RGB and a crop of NV12 off the
   group of 4) and P5 goes into out= views on and off 16-byte alignment.
   uint8 must match bit for bit, float32 within 1e-6, warp float32 bit for
   bit too;
4. the main paths: ``execute_operations`` twice each (new rects, new frame
   contents, new warp matrices and ``used_planes``) and
   ``launch_divergent_batch`` twice each for D1, D3, D4 (a new ``first``,
   shifted rects, new matrices) and once for a batch whose groups differ in
   output dtype; each must take its kernel, launch it once per call and
   build no new plan; the outputs are held against
   independent float64 versions. 40 ``CircularTensor`` updates must each
   launch the frame kernel once and nothing else, build no plan after the
   first, and leave every logical plane equal to an eager ring. P1-P5 twice
   each through ``execute_operations`` with new values (``cuda:pointwise``,
   also under ``ParBackend.CUDA``); the presets at full width, each call one
   launch: ``detection_preprocessor`` at the flagship's shapes,
   ``temporal_window`` of 32 frames, ``video_stream`` over raw RGB and NV12
   files of 16 1080p frames written to a temporary directory (the native
   loader asserted), ``camera_pipeline`` with and without ``out_size``; one
   flagship call through ``cv2_compat``; D14 twice; ring updates in every
   layout and order, a float32 chain behind a resize head into uint8 and
   int16 rings and behind a warp head into a uint8 ring in one launch each;
5. times: device time of each kernel and of its plain PyTorch version
   (CUDA events, median), alternating plain, kernel, kernel, plain, and the
   kernel's duration in a ``torch.profiler`` trace of 20 launches (events
   carry the floor of any launch, the trace does not); beside each its
   bound, the larger of its bytes (output, plus the 32-byte source sectors
   its taps touch) over the card's published memory rate and its float32
   operations over the published rate, and the same bytes over the copy
   bandwidth this run measured; for frame path (a), the affine warps, P3
   and P4 one library call that does the read alone (``F.interpolate``,
   ``F.grid_sample``, ``F.pad``, a contiguous slice), by events and by
   ``torch.profiler``, timed here and used nowhere in the port; the
   host-inclusive time of one ``execute_operations`` call of each path, the
   flagship call split into its host layers; the device's busy time and idle
   share in a ``torch.profiler`` trace of the flagship path; the event floor
   of a one-element launch, a device copy of the flagship output's bytes, and
   the copy bandwidth of a 256 MiB device copy; warp cases W1, W2, W5 and
   W6 and the host-inclusive call of the warp batch; the divergent kernel
   in D1-D4, the host-inclusive ``launch_divergent_batch`` call of D4 and
   one ``CircularTensor.update``, before (a temporary, a cast and a
   ``copy_``, as updates ran until the wrappers took ``out=``) and after;
   the pointwise kernel in P1-P5 (P1's bound is its operations at the
   unfused rate, half the published one: the build forbids FMAs); one eager
   int32 pipeline, which no kernel takes;
6. sharding: (a) every rank of meshes of 2 and 5 (the flagship, 50 crops
   ragged at ``used_planes`` = 37) and of 2, 4 and 8 (W6; P2's ring from
   ``first`` = 3 and -5; D1 and D3) run on this card through the rank-local
   function both sharded entry points use, in two rounds of new rects,
   ``first`` and ``used_planes``: each rank is one launch of the path's
   kernel and equals its plain version, no plan is built after a mesh's
   first rank (a divergent batch: one per distinct local routing), and the
   ranks joined equal the unsharded call bit for bit; (b) ``execute_sharded``
   and ``execute_divergent_sharded`` through a one-rank NCCL process group:
   DTensors on the write layout's plane axis (``Shard(1)`` for the
   transposed split), ``full_tensor()`` equal to the unsharded call, one
   launch per call and no NCCL kernel in a trace of 20 calls; the device
   time of one rank of two (25 planes) beside the 50-plane batch, and the
   host-inclusive calls: ``execute_operations``, ``execute_sharded`` on the
   one-rank mesh, rank 0 of 2 and the wrapper's own layers. Two processes
   on the one card over gloo are not run: gloo's gather of CUDA tensors
   ends a process with SIGSEGV in the card machine's torch build
   (``tools/gloo_cuda_gather.py`` shows it);
7. the system's own benchmarks (``cvgpuspeedup_tpu_torch/benchmarks``) with
   ``--quick``, fewer repetitions at the reference's shapes: the 5 rows of
   ``vertical_fusion``, the 13 of ``aux_pipelines``, ``host_overhead`` and
   ``scaling`` in phase 6's one-rank group; every fused call must be one
   launch of its kernel and equal its per-op step (uint8 bit for bit,
   float32 within 1e-4), host overhead and scaling must equal K1's plain
   version, every row must be physical; then the three examples once.

The last three lines are the card's name and power limit, one JSON object
describing the kernels, and ``{"ok": true, "device": {...}}``. The script
imports neither jax nor cv2 and needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SRC_H, SRC_W, BATCH = 2160, 3840, 50
ALPHA, SUB, DIV = 0.3, (3.2, 0.6, 11.8), (128.0, 128.0, 128.0)
FRAME_H, FRAME_W, FRAME_DST = 1080, 1920, (640, 360)     # path (a)
NV12_H, NV12_W, NV12_DST = 3240, 5760, (1920, 1080)      # path (b)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
BT709 = (0.2126, 0.0722)
F32_TOL = 1e-6      # kernel vs plain version on the card (0 expected)
ORACLE_TOL = 1e-4   # the repo's float contract against an independent resize
WARP_DST = (640, 360)
MAD_SIDE, MAD_OPS = 2048, 200
BORDER = 8
# cv2.getPerspectiveTransform of the 1080p frame's corners to
# (20, 10), (620, 25), (8, 370), (630, 380), as the reference's perspective
# row builds it (benchmarks/aux_pipelines.py:702-705)
PERSPECTIVE_W5 = np.array([
    [3.1753744470832196e-01, -1.1385448318718986e-02, 2.0e+01],
    [8.0131275612985130e-03, 3.2143042953172146e-01, 1.0e+01],
    [7.8622572200489309e-06, -3.3004950868603552e-05, 1.0],
])


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def axis_f64(dst: int, src: int):
    """OpenCV INTER_LINEAR taps in float64, ``s = (q + 0.5) * src/dst - 0.5``,
    the weight zeroed where the left tap clamps."""
    s = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(s).astype(np.int64)
    f = s - i0
    f = np.where(i0 < 0, 0.0, f)
    i0 = np.maximum(i0, 0)
    f = np.where(i0 >= src - 1, 0.0, f)
    i0 = np.minimum(i0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), f


def crop_f64(frame: np.ndarray, rect, dst_w: int, dst_h: int) -> np.ndarray:
    """One crop inside the frame resized by INTER_LINEAR in float64; (H, W, C)."""
    x, y, w, h = (int(v) for v in rect)
    crop = frame[y:y + h, x:x + w].astype(np.float64)
    x0, x1, fx = axis_f64(dst_w, w)
    y0, y1, fy = axis_f64(dst_h, h)
    fx = fx[None, :, None]
    fy = fy[:, None, None]
    top = crop[y0][:, x0] * (1 - fx) + crop[y0][:, x1] * fx
    bot = crop[y1][:, x0] * (1 - fx) + crop[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def oracle_plane(frame: np.ndarray, rect, dst_w: int, dst_h: int) -> np.ndarray:
    """One crop of the flagship chain in float64; planar (C, H, W)."""
    val = (crop_f64(frame, rect, dst_w, dst_h) * ALPHA - np.asarray(SUB)) / np.asarray(DIV)
    return val.transpose(2, 0, 1)


def oracle_frame(frame: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Path (a) in float64: resize, x/255, ImageNet normalization; (C, H, W)."""
    src = frame.astype(np.float64)
    x0, x1, fx = axis_f64(dst_w, src.shape[1])
    y0, y1, fy = axis_f64(dst_h, src.shape[0])
    rows = src[y0] * (1 - fy[:, None, None]) + src[y1] * fy[:, None, None]
    val = rows[:, x0] * (1 - fx[None, :, None]) + rows[:, x1] * fx[None, :, None]
    val = (val / 255.0 - np.asarray(MEAN)) / np.asarray(STD)
    return val.transpose(2, 0, 1)


def oracle_nv12_rows(buf: np.ndarray, out_rows, dst_w: int, dst_h: int) -> np.ndarray:
    """Path (b) in float64 at some output rows: bt709 full-range YUV->RGB of
    the frame with nearest-upsampled chroma, resized, x/255; (C, rows, W)."""
    src_h, src_w = buf.shape[0] * 2 // 3, buf.shape[1]
    kr, kb = BT709
    kg = 1.0 - kr - kb
    x0, x1, fx = axis_f64(dst_w, src_w)
    y0, y1, fy = axis_f64(dst_h, src_h)

    def rgb_row(r):
        y = buf[r].astype(np.float64)
        uv = buf[src_h + r // 2].astype(np.float64)
        u = np.repeat(uv[0::2], 2) - 128.0
        v = np.repeat(uv[1::2], 2) - 128.0
        rgb = np.stack([y + 2 * (1 - kr) * v,
                        y - 2 * kb * (1 - kb) / kg * u - 2 * kr * (1 - kr) / kg * v,
                        y + 2 * (1 - kb) * u])
        return rgb[:, x0] * (1 - fx) + rgb[:, x1] * fx

    out = [rgb_row(y0[q]) * (1 - fy[q]) + rgb_row(y1[q]) * fy[q] for q in out_rows]
    return np.stack(out, axis=1) / 255.0


def rotation(center, angle: float, scale: float, to=None) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the forward 2x3 matrix; with ``to``, the
    map is shifted so that ``center`` lands on ``to`` in the output."""
    a = np.deg2rad(angle)
    al, be = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    m = np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])
    if to is not None:
        m[:, 2] += (to[0] - cx, to[1] - cy)
    return m


def oracle_warp(frame: np.ndarray, m: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """An affine warp with a zero border: the inverse map in float64, its
    coordinate terms in float32 (coefficients rounded first, each product
    and sum once), the taps and lerps in float64; (H, W, C)."""
    a = np.linalg.inv(m[:, :2])
    inv = np.concatenate([a, (-a @ m[:, 2])[:, None]], axis=1).astype(np.float32)
    xs = np.arange(dst_w, dtype=np.float32)[None, :]
    ys = np.arange(dst_h, dtype=np.float32)[:, None]
    sx = (inv[0, 0] * xs + (inv[0, 1] * ys + inv[0, 2])).astype(np.float64)
    sy = (inv[1, 0] * xs + (inv[1, 1] * ys + inv[1, 2])).astype(np.float64)
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    h, w = frame.shape[:2]
    src = frame.astype(np.float64)

    def tap(ix, iy):
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        return np.where(ok[..., None], src[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)], 0.0)

    top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def flagship_ops(cvgs, frame, rects, used=None, write=None):
    """The flagship pipeline: crops of ``frame`` at ``rects`` -> 64x128,
    scaled, shifted and divided per channel, written planar (or by
    ``write``); ragged at ``used`` planes where given."""
    return (cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128), used_planes=used),
            cvgs.convert_to(np.float32, alpha=ALPHA), cvgs.subtract(SUB), cvgs.divide(DIV),
            (write or cvgs.split_tensor)())


def warp_batch_ops(cvgs, read, angle0, used, planes=8):
    """``planes`` rotations of one shared frame in one launch, the first
    ``used`` sampled -> 640x360, x1/255, planar."""
    mats = [rotation((960, 540), angle0 + 3.0 * i, 1.0 + 0.04 * i) for i in range(planes)]
    return (cvgs.warp_batch([read] * planes, mats, cvgs.Size(*WARP_DST), used_planes=used,
                            default=3.0),
            cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.split_tensor())


def warp_one_ops(cvgs, read, angle):
    """One rotation at 1/3 scale -> 640x360, x1/255, planar. The reference's
    rotation row (rotation((960, 540), 10, 1/3) -> 640x360) maps the frame's
    center to (960, 540), outside its output, so every output pixel reads
    the border; here the frame's center lands on the output's center, and
    the map keeps its class (|a| >= 2, e > 0)."""
    mid = (WARP_DST[0] / 2, WARP_DST[1] / 2)
    return (cvgs.warp(read, rotation((960, 540), angle, 1 / 3.0, to=mid), cvgs.Size(*WARP_DST)),
            cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.split_tensor())


def timed_warp_cases(cvgs, read) -> dict:
    """The warp cases that phase 5 times, of one 1080p frame ``read``: a
    case per class of the reference's warp kernels."""
    to_f32 = cvgs.convert_to(np.float32, alpha=1 / 255.0)
    return {
        "w1_k3_separable": (cvgs.warp(read, np.array([[0.55, 0.0, 23.0], [0.0, 0.62, 11.0]]),
                                      cvgs.Size(*WARP_DST)), to_f32, cvgs.split_tensor()),
        "w2_k4_rotation": warp_one_ops(cvgs, read, 10.0),
        "w5_k5a_perspective_640x384": (
            cvgs.warp(read, PERSPECTIVE_W5, cvgs.Size(640, 384),
                      warp_type=cvgs.WarpType.PERSPECTIVE), to_f32, cvgs.split_tensor()),
        "w6_k5b_batch8_ragged7": warp_batch_ops(cvgs, read, -10.0, 7),
    }


def nv12_read(cvgs, buf, dst, fmt=None, **conv):
    """An NV12 (or ``fmt``) buffer converted to float32 RGB (bt709 unless
    given) and resized to ``dst``."""
    conv.setdefault("standard", cvgs.ColorStandard.BT709)
    return cvgs.resize(cvgs.fuse(cvgs.read_yuv(buf, pixel_format=fmt or cvgs.PixelFormat.NV12),
                                 cvgs.convert_yuv_to_rgb(out_dtype=np.float32, **conv)),
                       cvgs.Size(*dst))


def frame_a_ops(cvgs, img, dst=FRAME_DST):
    """Frame path (a): an RGB u8 frame -> ``dst``, x1/255, ImageNet
    normalization, planar."""
    return (cvgs.resize(cvgs.image(img), cvgs.Size(*dst)),
            cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN), cvgs.divide(STD),
            cvgs.split_tensor())


def frame_b_ops(cvgs, buf, dst=NV12_DST):
    """Frame path (b): an NV12 buffer -> ``dst`` RGB f32 (bt709), x1/255, planar."""
    return (nv12_read(cvgs, buf, dst), cvgs.multiply(1 / 255.0), cvgs.split_tensor())


class DivergentRows:
    """The reference's divergent rows (benchmarks/aux_pipelines.py) over
    data made from one seed on ``dev``: D1 a ring of 16 planes read by two
    sequences, D2 eight NV12 cameras and pass-through planes, D3 crops of
    the flagship ``frame`` and pass-through, D4 warp | crop | pass. Each
    method returns ``(plane ids, sequences)``."""

    def __init__(self, cvgs, dev, frame):
        import torch

        rng = np.random.default_rng(9)
        self.cvgs, self.frame, self.dsize = cvgs, frame, cvgs.Size(64, 128)

        def to_dev(a):
            return torch.from_numpy(a).to(dev)

        self.ring_np = rng.integers(0, 256, (16, 128, 256, 3), dtype=np.uint8)
        self.ring = to_dev(self.ring_np)
        self.cams = [to_dev(rng.integers(0, 256, (192, 512), dtype=np.uint8))
                     for _ in range(8)]
        self.pass_d2 = to_dev(rng.integers(0, 200, (8, 64, 256, 3)).astype(np.float32))
        self.flat_np = rng.integers(0, 200, (8, 128, 64, 3)).astype(np.float32)
        self.flat = to_dev(self.flat_np)
        self.imgs_np = [rng.integers(0, 256, (512, 768, 3), dtype=np.uint8) for _ in range(8)]
        self.imgs = [to_dev(im) for im in self.imgs_np]
        self.batch_u8 = to_dev(rng.integers(0, 256, (8, 128, 64, 3), dtype=np.uint8))

    def d1(self, first, ring=None):
        cvgs, seq = self.cvgs, self.cvgs.build_operation_sequence
        ring = self.ring if ring is None else ring
        read = cvgs.circular_batch_read(ring, first=first)
        return [1 if z % 2 == 0 else 2 for z in range(ring.shape[0])], (
            seq(read, cvgs.convert_to(np.float32, alpha=0.3), cvgs.subtract((1.0, 2.0, 3.0)),
                cvgs.write_tensor()),
            seq(read, cvgs.convert_to(np.float32, alpha=0.5), cvgs.multiply((2.0, 1.0, 0.5)),
                cvgs.write_tensor()))

    def d2(self, fmt=None, repeat=1, **conv):
        cvgs, seq = self.cvgs, self.cvgs.build_operation_sequence
        reads = [nv12_read(cvgs, b, (256, 64), fmt, **conv) for b in self.cams * repeat]
        return [1 if z % 2 == 0 else 2 for z in range(8 * repeat)], (
            seq(cvgs.batch_read(reads), cvgs.multiply(0.5), cvgs.write_tensor()),
            seq(cvgs.image(self.pass_d2.repeat(repeat, 1, 1, 1)), cvgs.write_tensor()))

    @staticmethod
    def d3_rects(shift=0, n=8):
        return np.array([[13 * z + shift, 9 * z + shift, 60, 120] for z in range(n)], np.int32)

    def d3(self, rects):
        cvgs, seq = self.cvgs, self.cvgs.build_operation_sequence
        return [1 if z % 3 else 2 for z in range(8)], (
            seq(cvgs.resize_batch(self.frame, rects=rects, dsize=self.dsize),
                cvgs.convert_to(np.float32, alpha=0.5), cvgs.subtract((1.0, 2.0, 3.0)),
                cvgs.write_tensor()),
            seq(cvgs.image(self.flat), cvgs.multiply(2.0), cvgs.write_tensor()))

    @staticmethod
    def d4_mats(angle0, n=8):
        return [rotation((384, 256), 4.0 * z + angle0, 1.0) for z in range(n)]

    def d4(self, angle0=-14.0, write=None, repeat=1):
        cvgs, seq = self.cvgs, self.cvgs.build_operation_sequence
        write = write or cvgs.write_tensor
        n = 8 * repeat
        return [1, 2, 3, 1, 2, 3, 1, 2] * repeat, (
            seq(cvgs.warp_batch([cvgs.image(im) for im in self.imgs * repeat],
                                self.d4_mats(angle0, n), self.dsize), cvgs.multiply(0.5), write()),
            seq(cvgs.resize_batch(self.frame, rects=self.d3_rects(n=n), dsize=self.dsize),
                cvgs.convert_to(np.float32, alpha=0.5), write()),
            seq(cvgs.image(self.flat.repeat(repeat, 1, 1, 1)), cvgs.multiply(2.0), write()))

    def d14(self, used=5):
        """Ragged BatchRead groups: D4's warps from ``used`` planes on, and an
        image per plane from ``used`` - 2 on, hold their defaults."""
        cvgs, seq = self.cvgs, self.cvgs.build_operation_sequence
        return [1, 2] * 4, (
            seq(cvgs.warp_batch([cvgs.image(im) for im in self.imgs], self.d4_mats(-14.0),
                                self.dsize, used_planes=used, default=(7.5, 8.5, 9.5)),
                cvgs.multiply(0.5), cvgs.write_tensor()),
            seq(cvgs.batch_read([cvgs.image(self.batch_u8[z]) for z in range(8)],
                                used_planes=used - 2, default=200.0),
                cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.write_tensor()))

    def timed(self) -> dict:
        """The rows that phase 5 times."""
        return {"d1_circular_first3": self.d1(3), "d2_nv12_bt709": self.d2(),
                "d3_crop_resize": self.d3(self.d3_rects()), "d4_warp_crop_pass": self.d4()}


def mad_chain(cvgs):
    """The reference's stress chain (benchmarks/vertical_fusion.py): nested
    static loops of a multiply and an add, ``MAD_OPS`` ops in all."""
    mad = cvgs.fuse(cvgs.multiply(1.0009), cvgs.add(0.0001))
    return cvgs.static_loop(cvgs.static_loop(mad, 10), MAD_OPS // 2 // 10)


def p2_ops(cvgs, ring, first, scale=0.3):
    """P2: the ring from ``first``, a two-op float chain, written planar."""
    return (cvgs.circular_batch_read(ring, first=first), cvgs.convert_to(np.float32, alpha=scale),
            cvgs.subtract((1.0, 2.0, 3.0)), cvgs.split_tensor())


def pointwise_rows(cvgs, mad_src, ring, first, hd, origin, nv12_hd, scale=0.3) -> dict:
    """The pointwise rows P1-P5 that phases 4 and 5 drive: the MAD chain, the
    ring from ``first`` with a two-op float chain written planar, a 1080p
    frame with a replicated border scaled into planar float32, a 256x256
    crop at ``origin``, a bare NV12 -> RGBA conversion."""
    to_unit = cvgs.convert_to(np.float32, alpha=1 / 255.0)
    return {
        "p1_mad_200_ops_2048x2048": (cvgs.image(mad_src), mad_chain(cvgs), cvgs.write()),
        "p2_ring_first3_two_op_chain": p2_ops(cvgs, ring, first, scale),
        "p3_border8_replicate_1080p": (
            cvgs.make_border(cvgs.image(hd), BORDER, BORDER, BORDER, BORDER,
                             cvgs.BorderMode.REPLICATE), to_unit, cvgs.split_tensor()),
        "p4_crop_256x256": (cvgs.crop(cvgs.image(hd), cvgs.Rect(*origin, 256, 256)), to_unit,
                            cvgs.write()),
        "p5_nv12_1080p_rgba": (cvgs.read_yuv(nv12_hd), cvgs.convert_yuv_to_rgb(alpha=True)),
    }


def phase7(mesh, modules: dict) -> dict:
    """The system's own benchmarks and examples on the card: the four
    benchmark scripts at their full shapes with ``--quick`` (fewer
    repetitions), scaling in this process's one-rank group ``mesh``, and the
    three examples once. Each case asserts its own output check, its kernel
    and its one launch, and every row is physical; any failure raises.
    Returns, per kernel of ``modules`` (name -> kernel module), its launches
    in this phase (the counts set to 0 just before) and the rows that took
    it."""
    import contextlib
    import io
    import tempfile

    import torch
    from cvgpuspeedup_tpu_torch.benchmarks import (aux_pipelines, host_overhead, scaling,
                                                   vertical_fusion)
    from cvgpuspeedup_tpu_torch.examples import (detection_preprocessing, nv12_camera_stream,
                                                 temporal_window_slam)

    examples = {"detection_preprocessing": ("batch_resize", detection_preprocessing),
                "nv12_camera_stream": ("frame_resize", nv12_camera_stream),
                "temporal_window_slam": ("frame_resize", temporal_window_slam)}
    for m in modules.values():
        m.LAUNCHES = 0
    t0 = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory() as out, \
            contextlib.redirect_stdout(io.StringIO()) as printed:
        rows["vertical_fusion"] = vertical_fusion.main(["--quick", "--out", out])
        rows["aux_pipelines"] = aux_pipelines.main(["--quick", "--out", out])
        rows["host_overhead"] = [host_overhead.main(["--quick"])]
        rows["scaling"] = scaling.run(iters=5, mesh=mesh)
        for name, (_, example) in examples.items():
            example.main([])
        torch.cuda.synchronize()
    launches = {name: m.LAUNCHES for name, m in modules.items()}
    for line in printed.getvalue().splitlines():
        log(f"phase7 {line}")
    by_kernel = {name: [] for name in modules}
    for script, found in rows.items():
        for r in found:
            by_kernel[r["kernel"].split(":")[1]].append(f"{script}/{r['case']}")
    for name, (kernel, _) in examples.items():
        by_kernel[kernel].append(f"examples/{name}")
    log(f"phase7 {sum(map(len, rows.values()))} benchmark rows and {len(examples)} examples in "
        f"{time.perf_counter() - t0:.1f} s: every fused call one launch of its kernel, equal to "
        f"its per-op step, every row physical; launches {launches}")
    for name, n in launches.items():
        assert n > 0, f"phase 7 launched {name} no time"
    return {"launches": launches, "rows": by_kernel}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cvgpuspeedup_tpu_torch as cvgs
    from cvgpuspeedup_tpu_torch.exec import _build, executor
    from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
    from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
    from cvgpuspeedup_tpu_torch.exec import cuda_frame_resize as kfr
    from cvgpuspeedup_tpu_torch.exec import cuda_pointwise as kp
    from cvgpuspeedup_tpu_torch.exec import cuda_warp as kw
    from cvgpuspeedup_tpu_torch.graph import map_leaves
    from cvgpuspeedup_tpu_torch.ops.arithmetic import Mul, StaticLoop
    from cvgpuspeedup_tpu_torch.interop import cv2_compat
    from cvgpuspeedup_tpu_torch.ops.color import VectorReorder
    from cvgpuspeedup_tpu_torch.pipelines import presets
    from cvgpuspeedup_tpu_torch.utils import dtypes as dt
    from cvgpuspeedup_tpu_torch.utils import frameloader
    from cvgpuspeedup_tpu_torch.utils.dtypes import as_device_tensor
    from cvgpuspeedup_tpu_torch.benchmarks import host_overhead
    from cvgpuspeedup_tpu_torch.utils import bounds
    from cvgpuspeedup_tpu_torch.utils import profiling
    from cvgpuspeedup_tpu_torch.utils.profiling import time_cuda

    dev = torch.device("cuda", torch.cuda.current_device())
    card = gpu_name_and_limit()

    # ---- phase 1: environment
    log(f"phase1 python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"phase1 nvcc {_build.find_nvcc()}")
    log(f"phase1 device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"phase1 nvidia-smi: {card}")

    # ---- phase 2: build
    t0 = time.perf_counter()
    _build.load()
    if not _build.BUILD_LOG:
        log("phase2 the library was built before this run: no compiler output")
    log(f"phase2 built {_build.library_path().name} from "
        f"{', '.join(src.name for src in _build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"phase2 ptxas: {line.strip()}")

    # ---- phase 3: kernel vs plain version on the card
    rng = np.random.default_rng(42)
    frame_np = rng.integers(0, 256, (SRC_H, SRC_W, 3), dtype=np.uint8)
    frame = torch.from_numpy(frame_np).to(dev)
    dsize = cvgs.Size(64, 128)
    rects_a = np.array([[i, i, 60, 120] for i in range(BATCH)], np.int32)
    rects_b = np.array([[i, i, 30, 120] for i in range(BATCH)], np.int32)
    chain = (cvgs.convert_to(np.float32, alpha=ALPHA), cvgs.subtract(SUB), cvgs.divide(DIV))
    kernels = {
        "batch_resize": (kbr, kbr.batch_resize, kbr.batch_resize_reference),
        "frame_resize": (kfr, kfr.frame_resize, kfr.frame_resize_reference),
        "warp": (kw, kw.warp, kw.warp_reference),
        "divergent": (kd, kd.divergent, kd.divergent_reference),
        "pointwise": (kp, kp.pointwise, kp.pointwise_reference),
    }
    max_err = {name: 0.0 for name in kernels}
    case_err = {}

    def compare(name, kernel, got, want, tol=F32_TOL):
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: kernel {g.shape} {g.dtype}, plain {w.shape} {w.dtype}")
            if not g.dtype.is_floating_point:
                if not torch.equal(g, w):
                    bad = int((g.to(torch.int32) != w.to(torch.int32)).sum())
                    raise AssertionError(f"{name}: {bad} {g.dtype} values differ")
                d = 0.0
            else:
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{name}: non-finite kernel output")
                d = float((g - w).abs().max())
            err = max(err, d)
        if err > tol:
            raise AssertionError(f"{name}: max |diff| {err} > {tol}")
        max_err[kernel] = max(max_err[kernel], err)
        case_err[name] = err
        log(f"phase3 {kernel} {name}: shape {tuple(got[0].shape)} {got[0].dtype} max|diff| {err!r}")

    def check(name, read, *ops, kernel="batch_resize", tol=F32_TOL):
        module, launch, plain = kernels[kernel]
        pipeline = cvgs.build_pipeline(read, *ops)
        a = module.prepare(pipeline, module.build_plan(pipeline), dev)
        compare(name, kernel, launch(a), plain(a), tol)
        return a.plan

    check("a_ignore_ar", *flagship_ops(cvgs, frame, rects_a))
    for mode in (cvgs.AspectRatio.PRESERVE_AR, cvgs.AspectRatio.PRESERVE_AR_RN_EVEN,
                 cvgs.AspectRatio.PRESERVE_AR_LEFT):
        check(f"b_{mode.name.lower()}",
              cvgs.resize_batch(frame, rects=rects_b, dsize=dsize, background=128.0,
                                aspect_ratio=mode),
              *chain, cvgs.split_tensor())
    check("c_used_planes_37",
          cvgs.resize_batch(frame, rects=rects_a, dsize=dsize, used_planes=37, background=128.0),
          *chain, cvgs.split_tensor())
    sizes = [(100, 50), (80, 120), (37, 61), (720, 1280), (64, 128), (300, 200), (1080, 1920),
             (17, 9)]
    images = [torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
              for h, w in sizes]
    check("d_stack_8", cvgs.resize_batch(images, dsize=dsize, used_planes=7, background=5.0),
          *chain, cvgs.split_tensor())
    check("e_u8_chain", cvgs.resize_batch(frame, rects=rects_a, dsize=dsize),
          cvgs.convert_to(np.uint8, alpha=0.5, beta=3), cvgs.split_tensor())
    check("e_u8_chain_packed_hwc", cvgs.resize_batch(frame, rects=rects_a, dsize=dsize),
          cvgs.convert_to(np.uint8, alpha=0.5, beta=3), cvgs.multiply(1.7), cvgs.write_tensor())
    for name, wr in (("f_tsplit", cvgs.split_tensor_transposed()), ("f_split_write", cvgs.split()),
                     ("f_split_packed", cvgs.split_tensor_packed())):
        check(name, cvgs.resize_batch(frame, rects=rects_a, dsize=dsize), *chain, wr)
    edge = np.array([[SRC_W - 40 - i, SRC_H - 100 - i, 60, 120] for i in range(BATCH)], np.int32)
    check("g_f32_source_edge_rects_reorder_loop",
          cvgs.resize_batch(frame.float(), rects=edge, dsize=dsize),
          VectorReorder(indices=(2, 1, 0)), StaticLoop(body=Mul(value=np.float32(1.01)), n=3),
          *chain, cvgs.split_tensor())
    # (h) origins left of and above the frame (one past -width), a gray chain
    negative = np.array([[-5 - 7 * i, -3 - 5 * i, 60, 120] for i in range(BATCH - 2)]
                        + [[-SRC_W - 70, 2, 60, 120], [SRC_W - 30, SRC_H - 50, 60, 120]], np.int32)
    check("h_negative_origins_bgr2gray",
          cvgs.resize_batch(frame, rects=negative, dsize=dsize),
          cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_BGR2GRAY),
          cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.split_tensor())

    # (i)-(m) the tiled kernel's paths: a letterbox border through a thread's
    # pixels, an output width off the pixel group with rows off the vector
    # alignment, a source view at an odd address (crops at the buffer's
    # first and last bytes), row pitches of 4 and of no alignment, a uint8
    # output off the group
    cut = np.array([[i, i, 27, 120] for i in range(BATCH)], np.int32)
    check("i_letterbox_cuts_a_pixel_group",
          cvgs.resize_batch(frame, rects=cut, dsize=dsize, background=128.0,
                            aspect_ratio=cvgs.AspectRatio.PRESERVE_AR),
          *chain, cvgs.split_tensor())
    check("j_dst_62x126_rows_off_the_vector",
          cvgs.resize_batch(frame, rects=rects_a, dsize=cvgs.Size(62, 126)), *chain,
          cvgs.split_tensor())
    flat_frame = torch.from_numpy(
        rng.integers(0, 256, SRC_H * SRC_W * 3 + 1, dtype=np.uint8)).to(dev)
    odd_view = flat_frame[1:].view(SRC_H, SRC_W, 3)
    assert odd_view.data_ptr() % 2 == 1
    ends = np.array([[0, 0, 60, 120], [SRC_W - 60, SRC_H - 120, 60, 120]]
                    + [[i, i, 60, 120] for i in range(BATCH - 2)], np.int32)
    check("k_source_view_at_byte_offset_1",
          cvgs.resize_batch(odd_view, rects=ends, dsize=dsize), *chain, cvgs.split_tensor())
    for name, width in (("l_row_pitch_multiple_of_4_only", 1284), ("l_row_pitch_odd", 1283)):
        narrow = torch.from_numpy(rng.integers(0, 256, (720, width, 3), dtype=np.uint8)).to(dev)
        assert (width * 3) % 16 != 0
        check(name, cvgs.resize_batch(narrow, rects=rects_a, dsize=dsize), *chain,
              cvgs.split_tensor())
    check("m_u8_out_dst_61", cvgs.resize_batch(frame, rects=rects_a, dsize=cvgs.Size(61, 128)),
          cvgs.convert_to(np.uint8, alpha=0.5, beta=3), cvgs.split_tensor())

    # frame_resize at the frame paths' sizes
    normalize = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                 cvgs.divide(STD))
    hd_np = rng.integers(0, 256, (FRAME_H, FRAME_W, 3), dtype=np.uint8)
    nv12_np = rng.integers(0, 256, (NV12_H * 3 // 2, NV12_W), dtype=np.uint8)
    hd = torch.from_numpy(hd_np).to(dev)
    nv12 = torch.from_numpy(nv12_np).to(dev)

    def frame_a(img):
        return frame_a_ops(cvgs, img)

    def frame_b(buf):
        return frame_b_ops(cvgs, buf)

    check("a_1080p_rgb_normalize", *frame_a(hd), kernel="frame_resize")
    check("b_nv12_6k_bt709", *frame_b(nv12), kernel="frame_resize")
    plan_c = check("c_416x416_over_32_phases", cvgs.resize(cvgs.image(hd), cvgs.Size(416, 416)),
                   *normalize, cvgs.split_tensor(), kernel="frame_resize")
    assert not plan_c.keep_edge, "1080 -> 416 has 52 phases: the zeroed-edge rule"
    check("d_upscale_640x360_to_1280x720",
          cvgs.resize(cvgs.image(hd[:360, :640].contiguous()), cvgs.Size(1280, 720)),
          *normalize, cvgs.split_tensor(), kernel="frame_resize")
    check("e_u8_chain_split", cvgs.resize(cvgs.image(hd), cvgs.Size(*FRAME_DST)),
          cvgs.convert_to(np.uint8, alpha=0.5, beta=3.0), cvgs.split(), kernel="frame_resize")
    check("f_nv21_limited_alpha",
          nv12_read(cvgs, nv12, NV12_DST, cvgs.PixelFormat.NV21, standard=cvgs.ColorStandard.BT601,
                    color_range=cvgs.ColorRange.LIMITED, alpha=True),
          cvgs.split_tensor(), kernel="frame_resize")
    check("g_bgr2rgba_normalize", cvgs.resize(cvgs.image(hd), cvgs.Size(*FRAME_DST)),
          cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_BGR2RGBA),
          cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract((*MEAN, 0.0)),
          cvgs.divide((*STD, 1.0)), cvgs.split_tensor(), kernel="frame_resize")
    # (h)-(o) the pixel groups' paths. Launches of 1280x720 and more take 4
    # pixels per thread, 640x360 takes 1: a width off the group of 4 with a
    # packed write, a source view at an odd address (packed runs at the
    # buffer's first and last words) under both, a row pitch of no
    # alignment, uint8 vector stores, a float32 RGBA source, an NV12 buffer
    # at an odd address (its UV pairs byte by byte), NV21 into a width off
    # the group. The wrappers allocate their outputs, so a strided `out`
    # view cannot be reached.
    flat_hd = torch.from_numpy(rng.integers(0, 256, FRAME_H * FRAME_W * 3 + 1, dtype=np.uint8)).to(dev)
    hd_odd = flat_hd[1:].view(FRAME_H, FRAME_W, 3)
    assert hd_odd.data_ptr() % 2 == 1
    flat_nv12 = torch.from_numpy(
        rng.integers(0, 256, NV12_H * 3 // 2 * NV12_W + 1, dtype=np.uint8)).to(dev)
    nv12_odd = flat_nv12[1:].view(NV12_H * 3 // 2, NV12_W)
    assert nv12_odd.data_ptr() % 2 == 1
    narrow_hd = torch.from_numpy(rng.integers(0, 256, (720, 1283, 3), dtype=np.uint8)).to(dev)
    hd4f = torch.from_numpy(rng.integers(0, 256, (FRAME_H, FRAME_W, 4)).astype(np.float32)).to(dev)
    check("h_1279x719_off_the_group_packed_write",
          cvgs.resize(cvgs.image(hd), cvgs.Size(1279, 719)), *normalize, cvgs.write(),
          kernel="frame_resize")
    check("i_source_view_at_byte_offset_1_to_1280x720", *frame_a_ops(cvgs, hd_odd, (1280, 720)),
          kernel="frame_resize")
    check("i_source_view_at_byte_offset_1_to_640x360", *frame_a(hd_odd), kernel="frame_resize")
    check("j_row_pitch_odd_to_960x600", *frame_a_ops(cvgs, narrow_hd, (960, 600)),
          kernel="frame_resize")
    check("k_u8_out_1280x720_planar", cvgs.resize(cvgs.image(hd), cvgs.Size(1280, 720)),
          cvgs.convert_to(np.uint8, alpha=0.5, beta=3.0), cvgs.split_tensor(),
          kernel="frame_resize")
    check("l_f32_rgba_source_to_1280x720", cvgs.resize(cvgs.image(hd4f), cvgs.Size(1280, 720)),
          cvgs.multiply(1 / 255.0), cvgs.split_tensor(), kernel="frame_resize")
    check("m_nv12_buffer_at_byte_offset_1", *frame_b(nv12_odd), kernel="frame_resize")
    check("n_nv21_to_1918x1078_packed_write",
          nv12_read(cvgs, nv12, (1918, 1078), cvgs.PixelFormat.NV21), cvgs.multiply(1 / 255.0),
          cvgs.write(), kernel="frame_resize")
    check("o_nv12_to_640x360_one_pixel_per_thread", *frame_b_ops(cvgs, nv12, FRAME_DST),
          kernel="frame_resize")

    # warp at the warp rows' sizes: one case per class of the reference's
    # warp kernels, all of a 1080p frame; the kernel must equal its plain
    # version bit for bit
    to_f32 = cvgs.convert_to(np.float32, alpha=1 / 255.0)
    hd4 = torch.from_numpy(rng.integers(0, 256, (FRAME_H, FRAME_W, 4), dtype=np.uint8)).to(dev)
    shared = cvgs.image(hd)

    mid = (WARP_DST[0] / 2, WARP_DST[1] / 2)
    warp_cases = {
        **timed_warp_cases(cvgs, shared),
        "w3_k5a_flip_960x540": (cvgs.warp(shared, np.array([[-0.5, 0.0, 960.0], [0.0, 0.5, 2.0]]),
                                          cvgs.Size(960, 540)), to_f32, cvgs.split_tensor()),
        "w4_k5a_upscale_rotation_1280x768": (
            cvgs.warp(shared, rotation((960, 540), 10.0, 1.2), cvgs.Size(1280, 768)), to_f32,
            cvgs.split_tensor()),
        "w7_u8_chain_4ch_border": (
            cvgs.warp(cvgs.image(hd4), rotation((960, 540), -20.0, 0.5, to=mid),
                      cvgs.Size(*WARP_DST), default=(10.0, 20.0, 30.0, 250.0)),
            cvgs.convert_to(np.uint8), cvgs.split_tensor()),
        "w8_f32_source": (
            cvgs.warp(cvgs.image(hd.float()), rotation((960, 540), 25.0, 0.4, to=mid),
                      cvgs.Size(*WARP_DST)), cvgs.multiply(1 / 255.0), cvgs.split_tensor()),
    }
    # W9-W13 the packed tap fetch and its exits: a source view at an odd
    # address (the runs in the buffer's first and last words), taps with one
    # valid side (half-pixel shifts), a perspective map whose denominator
    # crosses 0 and one whose coordinates leave int32, one channel
    hd1 = hd[..., :1].contiguous()
    warp_cases.update({
        "w9_source_view_at_byte_offset_1_identity": (
            cvgs.warp(cvgs.image(hd_odd), np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
                      cvgs.Size(FRAME_W, FRAME_H)), to_f32, cvgs.split_tensor()),
        "w10_half_pixel_shift_one_valid_tap": (
            cvgs.warp(shared, np.array([[1.0, 0.0, 1.5], [0.0, 1.0, 1.5]]),
                      cvgs.Size(FRAME_W + 4, FRAME_H + 4), default=(9.0, 8.0, 7.0)), to_f32,
            cvgs.split_tensor()),
        "w11_perspective_den_crosses_0": (
            cvgs.warp(shared, np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1 / 256.0, 0.0, 1.0]]),
                      cvgs.Size(*WARP_DST), warp_type=cvgs.WarpType.PERSPECTIVE,
                      default=(1.0, 2.0, 3.0)), to_f32, cvgs.split_tensor()),
        "w12_perspective_beyond_int32": (
            cvgs.warp(shared, np.array([[1e-9, 0.0, 0.0], [0.0, 1e-9, 0.0], [0.0, 0.0, 1.0]]),
                      cvgs.Size(*WARP_DST), warp_type=cvgs.WarpType.PERSPECTIVE,
                      default=(1.0, 2.0, 3.0)), to_f32, cvgs.split_tensor()),
        "w13_one_channel_rotation": (
            cvgs.warp(cvgs.image(hd1), rotation((960, 540), 7.0, 0.5, to=mid),
                      cvgs.Size(*WARP_DST)), to_f32, cvgs.split_tensor()),
    })
    for name, ops in warp_cases.items():
        check(name, *ops, kernel="warp", tol=0.0)

    # divergent at the reference's divergent rows (benchmarks/aux_pipelines.py):
    # D1 a ring of 16 planes read by two sequences, D2 eight NV12 cameras and
    # pass-through planes, D3 crops of the flagship frame and pass-through,
    # D4 warp | crop | pass; then D5 a whole-plane stack resize with an image
    # group, D6 a uint8 chain in every group, D7 D4 written planar
    rows = DivergentRows(cvgs, dev, frame)
    seq = cvgs.build_operation_sequence
    ring, ring_np, flat_np, imgs_np = rows.ring, rows.ring_np, rows.flat_np, rows.imgs_np
    d1, d2, d3, d3_rects, d4, d4_mats = (rows.d1, rows.d2, rows.d3, rows.d3_rects, rows.d4,
                                         rows.d4_mats)
    batch_u8 = rows.batch_u8

    # D8-D13 the pixel groups' paths and the store of a group into a batch
    # of another dtype. D1 and the batches of 16 x 128 x 253 outputs and more
    # take 4 pixels per thread, D2-D7 take 1: groups of both output dtypes
    # in one batch, uint8 first (the float32 groups store clamped, then
    # truncated) and float32 first; a ring view at an odd address with rows
    # of 253 pixels (misaligned groups and a tail in every row); a float32
    # ring of 4 channels into planar uint8 (16-byte loads, 4-byte stores);
    # the sampled kinds under 4 pixels per thread (48 planes of D4, 24 of D2)
    flat_ring = torch.from_numpy(
        np.random.default_rng(10).integers(0, 256, 16 * 128 * 253 * 3 + 1, dtype=np.uint8)).to(dev)
    ring_odd = flat_ring[1:].view(16, 128, 253, 3)
    assert ring_odd.data_ptr() % 2 == 1
    ring_f32 = torch.from_numpy(np.random.default_rng(11).integers(
        -40, 300, (16, 128, 256, 4)).astype(np.float32) / np.float32(3)).to(dev)
    mixed_u8 = seq(cvgs.circular_batch_read(ring, first=5),
                   cvgs.convert_to(np.uint8, alpha=0.5, beta=3.0), cvgs.write_tensor())
    mixed_f32 = seq(cvgs.image(ring), cvgs.convert_to(np.float32, alpha=1.7), cvgs.add(-70.25),
                    cvgs.write_tensor())
    divergent_cases = {
        **rows.timed(),
        "d1_circular_first_minus5": d1(-5),
        "d2_nv21_limited": d2(cvgs.PixelFormat.NV21, color_range=cvgs.ColorRange.LIMITED),
        "d8_mixed_dtypes_uint8_first": ([1, 2] * 8, (mixed_u8, mixed_f32)),
        "d9_mixed_dtypes_float32_first": ([1, 2] * 8, (mixed_f32, mixed_u8)),
        "d10_ring_view_at_byte_offset_1_rows_of_253": d1(-7, ring_odd),
        "d11_f32_rgba_ring_to_planar_uint8": ([1, 2] * 8, (
            seq(cvgs.circular_batch_read(ring_f32, first=2, ascendent=False),
                cvgs.convert_to(np.uint8, alpha=0.9), cvgs.split_tensor()),
            seq(cvgs.image(ring_f32), cvgs.convert_to(np.uint8), cvgs.split_tensor()))),
        "d12_warp_crop_pass_48_planes": d4(repeat=6),
        "d13_nv12_24_planes": d2(repeat=3),
        "d5_stack_resize_and_image": ([1, 2] * 4, (
            seq(cvgs.resize_batch(images, dsize=dsize), cvgs.convert_to(np.float32, alpha=1 / 255.0),
                cvgs.write_tensor()),
            seq(cvgs.image(batch_u8), cvgs.convert_to(np.float32, alpha=1 / 255.0),
                cvgs.write_tensor()))),
        "d6_uint8_chain": ([2, 1] * 8, (
            seq(cvgs.image(ring), cvgs.multiply(1.7), cvgs.add(-20.5), cvgs.write_tensor()),
            seq(cvgs.circular_batch_read(ring, first=-1, ascendent=False),
                cvgs.convert_to(np.uint8, alpha=0.5, beta=3.0), cvgs.write_tensor()))),
        "d7_warp_crop_pass_planar": d4(write=cvgs.split_tensor),
        "d14_ragged_warp_and_image_batch_reads": rows.d14(),
    }
    for name, (ids, seqs) in divergent_cases.items():
        dplan = kd.build_plan(seqs, ids)
        a = kd.prepare(seqs, dplan, dev)
        compare(name, "divergent", kd.divergent(a), kd.divergent_reference(a))
        log(f"phase3 divergent {name}: groups {[g.kind for g in dplan.groups]}")


    # pointwise: every pipeline with no resampling head, bit for bit in every
    # dtype. P1 the 200-op MAD chain, P2 D1's ring from first = 3 with a
    # two-op float chain written planar, P3 a 1080p frame with an 8-pixel
    # border in each mode, P4 crops at a negative and an overhanging origin,
    # P5 1080p NV12 and NV21 -> RGBA u8 in both ranges, P6 int16 and uint16
    # chains; then every write layout once
    mad_np = rng.random((MAD_SIDE, MAD_SIDE, 1), dtype=np.float32) * 255
    mad_src = torch.from_numpy(mad_np).to(dev)
    nv12_hd_np = rng.integers(0, 256, (FRAME_H * 3 // 2, FRAME_W), dtype=np.uint8)
    nv12_hd = torch.from_numpy(nv12_hd_np).to(dev)
    hd_i16 = (hd.to(torch.int16) - 128) * 200
    hd_u16 = hd.to(torch.int32).mul(257).to(torch.uint16)
    to_unit = cvgs.convert_to(np.float32, alpha=1 / 255.0)
    hd_rgba_f32 = torch.cat([hd, hd[..., :1]], dim=2).float() * 0.75
    pointwise_cases = dict(pointwise_rows(cvgs, mad_src, ring, 3, hd, (-300, -200), nv12_hd))
    for mode in cvgs.BorderMode:
        if mode != cvgs.BorderMode.REPLICATE:
            pointwise_cases[f"p3_border8_{mode.name.lower()}_1080p"] = (
                cvgs.make_border(cvgs.image(hd), BORDER, BORDER, BORDER, BORDER, mode,
                                 value=(10.0, 20.0, 30.0)), to_unit, cvgs.split_tensor())
    pointwise_cases["p4_crop_overhanging_origin"] = (
        cvgs.crop(cvgs.image(hd), cvgs.Rect(FRAME_W - 100, FRAME_H - 50, 256, 256)), to_unit,
        cvgs.write())
    for fmt in (cvgs.PixelFormat.NV12, cvgs.PixelFormat.NV21):
        for crange in cvgs.ColorRange:
            if (fmt, crange) != (cvgs.PixelFormat.NV12, cvgs.ColorRange.FULL):
                pointwise_cases[f"p5_{fmt.name.lower()}_{crange.name.lower()}_1080p_rgba"] = (
                    cvgs.read_yuv(nv12_hd, fmt),
                    cvgs.convert_yuv_to_rgb(color_range=crange, alpha=True))
    pointwise_cases.update({
        "p6_int16_saturating_chain": (cvgs.image(hd_i16), cvgs.multiply(1.7), cvgs.add(-2000.5),
                                      cvgs.split_tensor()),
        "p6_uint16_to_gray_to_int8": (
            cvgs.image(hd_u16), cvgs.multiply(1.5),
            cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_RGB2GRAY),
            cvgs.convert_to(np.int8, alpha=1 / 300.0, beta=-90.0), cvgs.write()),
        "p6_float32_to_int16_negative_saturate": (
            cvgs.image((hd.float() - 128) * 400), cvgs.convert_to(np.int16), cvgs.write()),
        "layout_split_single": (cvgs.image(hd), to_unit, cvgs.split()),
        "layout_write_tensor": (cvgs.image(ring), to_unit, cvgs.write_tensor()),
        "layout_tsplit": (cvgs.image(ring), to_unit, cvgs.split_tensor_transposed()),
        "layout_split_packed": (cvgs.circular_batch_read(ring, first=-5, ascendent=False),
                                to_unit, cvgs.split_tensor_packed()),
        "layout_split_write_batch": (cvgs.image(ring), cvgs.multiply(1.7), cvgs.split()),
        "border_over_crop_over_ring": (
            cvgs.make_border(cvgs.crop(cvgs.circular_batch_read(ring, first=2),
                                       cvgs.Rect(30, -40, 200, 100)),
                             2, 1, 3, 2, cvgs.BorderMode.REFLECT_101), to_unit,
            cvgs.split_tensor()),
    })
    # the staged chain and its groups: a chain longer than one staging chunk
    # (four lanes and one), the chain's width changing part way, one-channel
    # chains of 16-pixel groups with a row's tail, NV12 groups into RGB and
    # a crop of NV12 off the group of 4
    mad_long = cvgs.static_loop(cvgs.fuse(cvgs.multiply(1.0009765625), cvgs.add(0.001)), 150)
    C = cvgs.ColorConversionCode
    pointwise_cases.update({
        "p7_long_chain_300_rows_rgb_1080p": (cvgs.image(hd), cvgs.convert_to(np.float32),
                                             mad_long, cvgs.split_tensor()),
        "p7_long_chain_300_rows_1ch_f32": (cvgs.image(mad_src[:1531, :1999]), mad_long,
                                           cvgs.write()),
        "p8_rgb_rgba_multiply_rgb": (
            cvgs.image(hd), cvgs.cvt_color(C.COLOR_RGB2RGBA),
            cvgs.convert_to(np.float32, alpha=0.5), cvgs.multiply((1.0, 2.0, 0.5, 3.0)), cvgs.cvt_color(C.COLOR_RGBA2RGB),
            cvgs.split_tensor()),
        "p8_rgba_gray_long_tail": (
            cvgs.image(hd_rgba_f32), cvgs.cvt_color(C.COLOR_RGBA2GRAY), mad_long, cvgs.write()),
        "p9_1ch_u8_odd_width_groups_of_16": (cvgs.image(hd[:, :1917, :1].contiguous()),
                                             cvgs.multiply(1.5), cvgs.add(-20.25), cvgs.write()),
        "p9_1ch_f32_odd_width_groups_of_16": (cvgs.image(mad_src[:, :2045]), cvgs.multiply(0.5),
                                              cvgs.subtract(3.0), cvgs.split_tensor()),
        "p10_nv12_1080p_rgb_u8": (cvgs.read_yuv(nv12_hd), cvgs.convert_yuv_to_rgb()),
        "p10_nv12_crop_width_off_the_group": (
            cvgs.crop(cvgs.read_yuv(nv12_hd), cvgs.Rect(6, 4, 1001, 700)),
            cvgs.convert_yuv_to_rgb(alpha=True)),
    })
    for name, ops in pointwise_cases.items():
        check(name, *ops, kernel="pointwise", tol=0.0)

    # P5 into out= views at 16-byte alignment and 4 bytes off it: both equal
    # the plain version and leave the bytes around them as they were
    p5_pipe = cvgs.build_pipeline(*pointwise_rows(cvgs, mad_src, ring, 3, hd, (0, 0),
                                                  nv12_hd)["p5_nv12_1080p_rgba"])
    p5_args = kp.prepare(p5_pipe, kp.build_plan(p5_pipe), dev)
    p5_want = kp.pointwise_reference(p5_args)
    for shift in (0, 4):
        storage = torch.full((p5_want.numel() + 64,), 7, dtype=torch.uint8, device=dev)
        start = (-storage.data_ptr()) % 16 + shift
        view = storage[start:start + p5_want.numel()].view(p5_want.shape)
        assert view.data_ptr() % 16 == shift and kp.pointwise(p5_args, out=view) is view
        compare(f"p5_out_view_{'aligned' if shift == 0 else 'off_by_4_bytes'}", "pointwise", view,
                p5_want, 0.0)
        assert bool((storage[:start] == 7).all() and (storage[start + p5_want.numel():] == 7).all())

    # out= into a strided slot: the frame kernel and the pointwise kernel
    # store into plane 2 of a (C, N, H, W) ring, whose rows lie N planes apart
    for kernel, module, launch, ops, size in (
            ("frame_resize", kfr, kfr.frame_resize,
             (cvgs.resize(cvgs.image(hd), cvgs.Size(64, 128)), to_unit), (128, 64)),
            ("pointwise", kp, kp.pointwise,
             (cvgs.crop(cvgs.image(hd), cvgs.Rect(7, 9, 64, 128)), to_unit), (128, 64))):
        slots = torch.full((3, 4, *size), -1.0, device=dev)
        pipeline = cvgs.build_pipeline(*ops, cvgs.split_tensor())
        a = module.prepare(pipeline, module.build_plan(pipeline), dev)
        view = slots[:, 2]
        assert not view.is_contiguous() and launch(a, out=view) is view
        compare(f"out_into_a_strided_slot_{kernel}", kernel, view, module.run(pipeline, a.plan, dev),
                0.0)
        assert bool((slots[:, [0, 1, 3]] == -1.0).all()), "the store left its slot"

    # ---- phase 4: the main path through the public entry points
    path_calls = {name: 0 for name in kernels}

    def drive(kernel, call):
        """One call of an entry point on a main path, counted beside the
        kernel it must take: launches over these calls is launches per call."""
        path_calls[kernel] += 1
        return call()

    def main_path(rects):
        return cvgs.execute_operations(*flagship_ops(cvgs, frame, rects), device="cuda")

    shifted = rects_a.copy()
    shifted[:, :2] += 7
    kbr.LAUNCHES = 0
    builds0 = executor.PLAN_BUILDS
    out1 = drive("batch_resize", lambda: main_path(rects_a))
    backend1, launches1, builds1 = cvgs.last_backend(), kbr.LAUNCHES, executor.PLAN_BUILDS
    out2 = drive("batch_resize", lambda: main_path(shifted))
    backend2, launches2, builds2 = cvgs.last_backend(), kbr.LAUNCHES, executor.PLAN_BUILDS
    torch.cuda.synchronize()
    main_launches = kbr.LAUNCHES
    log(f"phase4 backends {backend1} {backend2}; launches {launches1} {launches2}; "
        f"plan builds {builds0} -> {builds1} -> {builds2}")
    assert backend1 == backend2 == "cuda:batch_resize", (backend1, backend2)
    assert (launches1, launches2) == (1, 2), (launches1, launches2)
    assert builds1 <= builds0 + 1 and builds2 == builds1, (builds0, builds1, builds2)
    for out in (out1, out2):
        assert tuple(out.shape) == (BATCH, 3, 128, 64) and out.dtype == torch.float32, out.shape
        assert bool(torch.isfinite(out).all()), "non-finite output"
    assert not torch.equal(out1, out2), "shifted rects gave the same output"
    plain2 = cvgs.execute_operations(*flagship_ops(cvgs, frame, shifted),
                                     backend=cvgs.ParBackend.TORCH)
    eager_err = float((plain2 - out2).abs().max())
    host2 = out2.cpu().numpy()
    oracle_err = max(
        float(np.abs(host2[z] - oracle_plane(frame_np, shifted[z], 64, 128)).max())
        for z in (0, 17, BATCH - 1)
    )
    log(f"phase4 output {tuple(out2.shape)} {out2.dtype}; max|diff| vs eager torch {eager_err!r}, "
        f"vs float64 oracle {oracle_err!r}")
    assert eager_err <= F32_TOL, eager_err
    assert oracle_err <= ORACLE_TOL, oracle_err

    # the frame paths, each driven twice with new frame contents
    def frame_path(ops):
        return cvgs.execute_operations(*ops, device="cuda")

    hd2_np = rng.integers(0, 256, hd_np.shape, dtype=np.uint8)
    nv12_2_np = rng.integers(0, 256, nv12_np.shape, dtype=np.uint8)
    frame_inputs = {
        "a": (frame_a, hd, torch.from_numpy(hd2_np).to(dev), (3, FRAME_DST[1], FRAME_DST[0])),
        "b": (frame_b, nv12, torch.from_numpy(nv12_2_np).to(dev), (3, NV12_DST[1], NV12_DST[0])),
    }
    frame_launches = 0
    frame_out = {}
    for path, (ops, src1, src2, shape) in frame_inputs.items():
        kfr.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        f1 = drive("frame_resize", lambda: frame_path(ops(src1)))
        backend1, launches1, builds1 = cvgs.last_backend(), kfr.LAUNCHES, executor.PLAN_BUILDS
        f2 = drive("frame_resize", lambda: frame_path(ops(src2)))
        backend2, launches2, builds2 = cvgs.last_backend(), kfr.LAUNCHES, executor.PLAN_BUILDS
        torch.cuda.synchronize()
        frame_launches += kfr.LAUNCHES
        log(f"phase4 frame path ({path}): backends {backend1} {backend2}; launches {launches1} "
            f"{launches2}; plan builds {builds0} -> {builds1} -> {builds2}")
        assert backend1 == backend2 == "cuda:frame_resize", (backend1, backend2)
        assert (launches1, launches2) == (1, 2), (launches1, launches2)
        assert builds1 <= builds0 + 1 and builds2 == builds1, (builds0, builds1, builds2)
        for out in (f1, f2):
            assert tuple(out.shape) == shape and out.dtype == torch.float32, out.shape
            assert bool(torch.isfinite(out).all()), "non-finite output"
        assert not torch.equal(f1, f2), "new frame contents gave the same output"
        eager = cvgs.execute_operations(*ops(src2), backend=cvgs.ParBackend.TORCH)
        frame_out[path] = (f2.cpu().numpy(), float((eager - f2).abs().max()))
    host_a, eager_a = frame_out["a"]
    oracle_a = float(np.abs(host_a - oracle_frame(hd2_np, *FRAME_DST)).max())
    rows_b = [0, 1, 2, 539, 540, NV12_DST[1] - 1]
    host_b, eager_b = frame_out["b"]
    oracle_b = float(np.abs(host_b[:, rows_b] - oracle_nv12_rows(nv12_2_np, rows_b, *NV12_DST)).max())
    log(f"phase4 frame path (a): max|diff| vs eager torch {eager_a!r}, vs float64 oracle "
        f"{oracle_a!r}; (b): vs eager torch {eager_b!r}, vs float64 oracle at rows {rows_b} "
        f"{oracle_b!r}")
    assert max(eager_a, eager_b) <= F32_TOL, (eager_a, eager_b)
    assert max(oracle_a, oracle_b) <= ORACLE_TOL, (oracle_a, oracle_b)

    # the warp path: the batch of eight, then one rotation, each twice with
    # new matrices (and a new used_planes for the batch)
    def warp_path(ops):
        return cvgs.execute_operations(*ops, device="cuda")

    warp_runs = {
        "batch": (lambda k: warp_batch_ops(cvgs, cvgs.image(hd), (-10.0, -8.5)[k], (7, 5)[k]),
                  (8, 3, WARP_DST[1], WARP_DST[0])),
        "single": (lambda k: warp_one_ops(cvgs, cvgs.image(hd), (10.0, 12.5)[k]),
                   (3, WARP_DST[1], WARP_DST[0])),
    }
    warp_launches = 0
    for path, (ops, shape) in warp_runs.items():
        kw.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        w1 = drive("warp", lambda: warp_path(ops(0)))
        backend1, launches1, builds1 = cvgs.last_backend(), kw.LAUNCHES, executor.PLAN_BUILDS
        w2 = drive("warp", lambda: warp_path(ops(1)))
        backend2, launches2, builds2 = cvgs.last_backend(), kw.LAUNCHES, executor.PLAN_BUILDS
        torch.cuda.synchronize()
        warp_launches += kw.LAUNCHES
        log(f"phase4 warp path ({path}): backends {backend1} {backend2}; launches {launches1} "
            f"{launches2}; plan builds {builds0} -> {builds1} -> {builds2}")
        assert backend1 == backend2 == "cuda:warp", (backend1, backend2)
        assert (launches1, launches2) == (1, 2), (launches1, launches2)
        assert builds1 <= builds0 + 1 and builds2 == builds1, (builds0, builds1, builds2)
        for out in (w1, w2):
            assert tuple(out.shape) == shape and out.dtype == torch.float32, out.shape
            assert bool(torch.isfinite(out).all()), "non-finite output"
        assert not torch.equal(w1, w2), "new matrices gave the same output"
        eager = cvgs.execute_operations(*ops(1), backend=cvgs.ParBackend.TORCH)
        eager_err = float((eager - w2).abs().max())
        host = w2.cpu().numpy()
        if path == "batch":
            checked = {z: rotation((960, 540), -8.5 + 3.0 * z, 1.0 + 0.04 * z) for z in (0, 2, 4)}
            fill = np.float32(3.0) * np.float32(1 / 255.0)
            assert bool((w2[5:] == float(fill)).all()), "planes past used_planes hold no default"
            planes = {z: host[z] for z in checked}
        else:
            checked = {0: rotation((960, 540), 12.5, 1 / 3.0, to=mid)}
            planes = {0: host}
        oracle_err = max(
            float(np.abs(planes[z].transpose(1, 2, 0) - oracle_warp(hd_np, m, *WARP_DST) / 255.0)
                  .max())
            for z, m in checked.items())
        log(f"phase4 warp path ({path}): max|diff| vs eager torch {eager_err!r}, vs float64 "
            f"oracle at planes {sorted(checked)} {oracle_err!r}")
        assert eager_err <= F32_TOL, eager_err
        assert oracle_err <= ORACLE_TOL, oracle_err

    # the divergent path: D1 with a new `first`, D3 with shifted rects, D4
    # with new matrices, each twice through launch_divergent_batch
    flat_f64 = flat_np.astype(np.float64)

    def d1_oracle(first, z):
        v = ring_np[(first + z) % 16].astype(np.float64)
        return v * 0.3 - np.array([1.0, 2.0, 3.0]) if z % 2 == 0 else v * 0.5 * np.array(
            [2.0, 1.0, 0.5])

    def d3_oracle(z, shift=7):
        if z % 3 == 0:
            return flat_f64[z] * 2.0
        return crop_f64(frame_np, d3_rects(shift)[z], *dsize) * 0.5 - np.array([1.0, 2.0, 3.0])

    def d4_oracle(z, angle0=-12.0):
        sid = (1, 2, 3, 1, 2, 3, 1, 2)[z]
        if sid == 1:
            return oracle_warp(imgs_np[z], d4_mats(angle0)[z], *dsize) * 0.5
        if sid == 2:
            return crop_f64(frame_np, d3_rects()[z], *dsize) * 0.5
        return flat_f64[z] * 2.0

    divergent_runs = {
        "d1_circular": (lambda k: d1((3, -5)[k]), (16, 128, 256, 3),
                        {z: d1_oracle(-5, z) for z in (0, 1, 15)}),
        "d3_crop_resize": (lambda k: d3(d3_rects((0, 7)[k])), (8, 128, 64, 3),
                           {z: d3_oracle(z) for z in (0, 1, 7)}),
        "d4_warp_crop_pass": (lambda k: d4((-14.0, -12.0)[k]), (8, 128, 64, 3),
                              {z: d4_oracle(z) for z in (0, 1, 2, 6)}),
    }
    divergent_launches = 0
    for path, (make, shape, oracles) in divergent_runs.items():
        kd.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        ids1, seqs1 = make(0)
        d_1 = drive("divergent", lambda: cvgs.launch_divergent_batch(ids1, *seqs1))
        backend1, launches1, builds1 = cvgs.last_backend(), kd.LAUNCHES, executor.PLAN_BUILDS
        ids2, seqs2 = make(1)
        d_2 = drive("divergent", lambda: cvgs.launch_divergent_batch(ids2, *seqs2))
        backend2, launches2, builds2 = cvgs.last_backend(), kd.LAUNCHES, executor.PLAN_BUILDS
        torch.cuda.synchronize()
        divergent_launches += kd.LAUNCHES
        log(f"phase4 divergent path ({path}): backends {backend1} {backend2}; launches "
            f"{launches1} {launches2}; plan builds {builds0} -> {builds1} -> {builds2}")
        assert backend1 == backend2 == "cuda:divergent", (backend1, backend2)
        assert (launches1, launches2) == (1, 2), (launches1, launches2)
        assert builds1 <= builds0 + 1 and builds2 == builds1, (builds0, builds1, builds2)
        for out in (d_1, d_2):
            assert tuple(out.shape) == shape and out.dtype == torch.float32, out.shape
            assert bool(torch.isfinite(out).all()), "non-finite output"
        assert not torch.equal(d_1, d_2), "new runtime values gave the same output"
        eager = cvgs.launch_divergent_batch(ids2, *seqs2, backend=cvgs.ParBackend.TORCH)
        eager_err = float((eager - d_2).abs().max())
        host = d_2.cpu().numpy()
        # the repo's float contract, 1e-4 on values of 0..255
        oracle_err = max(float(np.abs(host[z] - want).max() / max(1.0, np.abs(want).max() / 255))
                         for z, want in oracles.items())
        log(f"phase4 divergent path ({path}): max|diff| vs eager torch {eager_err!r}, vs float64 "
            f"oracle at planes {sorted(oracles)} {oracle_err!r} (on a 0..255 scale)")
        assert eager_err <= F32_TOL, eager_err
        assert oracle_err <= ORACLE_TOL, oracle_err

    # groups of both output dtypes in one batch: one launch of the kernel, and
    # what the eager merge gives (uint8, the float32 group clamped, then cut)
    ids8, seqs8 = divergent_cases["d8_mixed_dtypes_uint8_first"]
    kd.LAUNCHES = 0
    mixed = drive("divergent", lambda: cvgs.launch_divergent_batch(ids8, *seqs8))
    mixed_backend, mixed_launches = cvgs.last_backend(), kd.LAUNCHES
    divergent_launches += kd.LAUNCHES
    eager = cvgs.launch_divergent_batch(ids8, *seqs8, backend=cvgs.ParBackend.TORCH)
    torch.cuda.synchronize()
    log(f"phase4 divergent path (mixed dtypes): backend {mixed_backend}; launches "
        f"{mixed_launches}; {tuple(mixed.shape)} {mixed.dtype}; equal to the eager merge "
        f"{torch.equal(mixed, eager)}")
    assert mixed_backend == "cuda:divergent" and mixed_launches == 1, (mixed_backend, mixed_launches)
    assert mixed.dtype == torch.uint8 and torch.equal(mixed, eager)

    # ragged BatchRead groups (D14), which the reference's TPU kernel refuses:
    # one launch, a new used_planes building no plan, equal to the eager merge
    kd.LAUNCHES = 0
    new_plans = []
    for used in (5, 3):
        ids14, seqs14 = rows.d14(used)
        builds0 = executor.PLAN_BUILDS
        ragged = drive("divergent", lambda: cvgs.launch_divergent_batch(ids14, *seqs14))
        new_plans.append(executor.PLAN_BUILDS - builds0)
        assert cvgs.last_backend() == "cuda:divergent", cvgs.last_backend()
        eager = cvgs.launch_divergent_batch(ids14, *seqs14, backend=cvgs.ParBackend.TORCH)
        assert torch.equal(ragged, eager), f"D14 at used_planes {used} differs from the eager merge"
    torch.cuda.synchronize()
    divergent_launches += kd.LAUNCHES
    log(f"phase4 divergent path (ragged BatchRead groups, D14): backend cuda:divergent; launches "
        f"{kd.LAUNCHES} in 2 calls; plans built by each call {new_plans}; equal to the eager merge")
    assert kd.LAUNCHES == 2 and new_plans[0] <= 1 and new_plans[1] == 0, (kd.LAUNCHES, new_plans)

    # CircularTensor at the reference's row: a 32-deep STANDARD ring of
    # 128x64 planes, 40 updates of a 1080p frame resized and scaled; each
    # update runs the frame kernel and writes one slot
    ct = cvgs.CircularTensor(64, 128, 3, 32, device=dev)
    eager_ring = torch.zeros(ct.shape, device=dev)

    def ct_ops(k):
        return (cvgs.resize(cvgs.image(torch.roll(hd, 7 * k, dims=1)), cvgs.Size(64, 128)),
                cvgs.convert_to(np.float32, alpha=1 / 255.0))

    kfr.LAUNCHES = 0
    ct_backends, ct_new_plans = set(), 0
    for k in range(40):
        b0 = executor.PLAN_BUILDS
        ct.update(*ct_ops(k))
        ct_backends.add(cvgs.last_backend())
        ct_new_plans += (executor.PLAN_BUILDS - b0) if k else 0
        x = cvgs.execute_operations(*ct_ops(k), backend=cvgs.ParBackend.TORCH)
        eager_ring[k % 32].copy_(x.permute(2, 0, 1))
    torch.cuda.synchronize()
    ct_launches = kfr.LAUNCHES
    perm = torch.tensor([(39 - z) % 32 for z in range(32)], device=dev)
    ct_err = float((ct.tensor - eager_ring.index_select(0, perm)).abs().max())
    log(f"phase4 CircularTensor {ct.shape}: backends {sorted(ct_backends)}; frame_resize launches "
        f"{ct_launches} in 40 updates; plans built after the first update {ct_new_plans}; "
        f"every logical plane vs the eager ring max|diff| {ct_err!r}")
    assert ct_backends == {"cuda:frame_resize"}, ct_backends
    assert ct_launches == 40 and ct_new_plans == 0, (ct_launches, ct_new_plans)
    assert ct_err <= F32_TOL, ct_err


    # the pointwise path: P1-P5 twice each through execute_operations with
    # new values (another frame, first, origin, buffer, scale); one launch
    # per call, no plan on the second, equal to the eager version; AUTO and
    # an explicit ParBackend.CUDA both take the pointwise kernel
    mad_src2 = torch.from_numpy(rng.random((MAD_SIDE, MAD_SIDE, 1), dtype=np.float32) * 255).to(dev)
    hd2 = torch.from_numpy(hd2_np).to(dev)
    nv12_hd2 = torch.roll(nv12_hd, 5, dims=1)
    pw_values = ((mad_src, ring, 3, hd, (-300, -200), nv12_hd, 0.3),
                 (mad_src2, torch.roll(ring, 1, dims=2), -5, hd2, (1700, 900), nv12_hd2, 0.5))
    pointwise_launches = 0
    for name in pointwise_rows(cvgs, *pw_values[0]):
        kp.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        outs, backends, seen = [], [], []
        for values in pw_values:
            ops = pointwise_rows(cvgs, *values)[name]
            outs.append(drive("pointwise", lambda: cvgs.execute_operations(*ops)))
            backends.append(cvgs.last_backend())
            seen.append((kp.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        pointwise_launches += kp.LAUNCHES
        ops2 = pointwise_rows(cvgs, *pw_values[1])[name]
        forced = cvgs.describe_backend(*ops2, backend=cvgs.ParBackend.CUDA)
        eager = cvgs.execute_operations(*ops2, backend=cvgs.ParBackend.TORCH)
        same = torch.equal(outs[1], eager)
        log(f"phase4 pointwise path ({name}): backends {backends}, under ParBackend.CUDA {forced}; "
            f"launches {seen[0][0]} {seen[1][0]}; plan builds {builds0} -> {seen[0][1]} -> "
            f"{seen[1][1]}; {tuple(outs[1].shape)} {outs[1].dtype}; equal to eager torch {same}")
        assert backends == ["cuda:pointwise"] * 2 and forced == "cuda:pointwise", (backends, forced)
        assert (seen[0][0], seen[1][0]) == (1, 2), seen
        assert seen[0][1] <= builds0 + 1 and seen[1][1] == seen[0][1], (builds0, seen)
        assert same and not torch.equal(outs[0], outs[1])
        if outs[1].dtype.is_floating_point:
            assert bool(torch.isfinite(outs[1]).all()), "non-finite output"
    # P1 against an independent float64 version: 200 ops amplify float32's
    # rounding, so the contract's 1e-4 holds relative to the values
    mad64 = mad_src2.double()
    for _ in range(MAD_OPS // 2):
        mad64 = mad64 * 1.0009 + 0.0001
    mad_out = cvgs.execute_operations(*pointwise_rows(cvgs, *pw_values[1])["p1_mad_200_ops_2048x2048"])
    mad_err = float(((mad_out.double() - mad64).abs() / mad64.abs().clamp(min=1.0)).max())
    log(f"phase4 pointwise path (p1): max relative |diff| vs float64 {mad_err!r}")
    assert mad_err <= ORACLE_TOL, mad_err

    # what an f32 register cannot hold stays eager, one launch per op
    for what, ops in (("int32 source", (cvgs.image(hd.to(torch.int32)), cvgs.multiply(2.0))),
                      ("float64 source", (cvgs.image(hd.double()), cvgs.multiply(2.0))),
                      ("int32 cast", (cvgs.image(hd), cvgs.convert_to(np.int32, alpha=1000.0)))):
        cvgs.execute_operations(*ops)
        assert cvgs.last_backend() == "torch", (what, cvgs.last_backend())
    log("phase4 int32 and float64 sources and an int32 cast run on the eager path (torch)")

    # the presets at full width, each call one launch
    def preset_calls(label, kernel, module, backend, calls):
        """Drive ``calls`` (thunks of a preset whose plan exists), each one
        launch of ``module``'s kernel with ``backend`` reported and no plan
        built; returns the outputs and the launches."""
        module.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        outs = []
        for call in calls:
            before = module.LAUNCHES
            outs.append(drive(kernel, call))
            assert cvgs.last_backend() == backend, (label, cvgs.last_backend())
            assert module.LAUNCHES == before + 1, (label, module.LAUNCHES - before)
        torch.cuda.synchronize()
        log(f"phase4 preset {label}: {len(calls)} calls with new values, backend {backend}, "
            f"1 launch each, plans built {executor.PLAN_BUILDS - builds0}")
        assert executor.PLAN_BUILDS == builds0, (label, builds0, executor.PLAN_BUILDS)
        return outs, module.LAUNCHES

    prep = presets.detection_preprocessor(dsize=cvgs.Size(64, 128), mean=SUB, scale=DIV, alpha=ALPHA)
    prep(frame, rects_a)  # the plan of this structure
    (det1, det2), n = preset_calls("detection_preprocessor", "batch_resize", kbr,
                                   "cuda:batch_resize",
                                   [lambda: prep(frame, rects_a), lambda: prep(frame, shifted)])
    main_launches += n
    assert torch.equal(det2, out2) and not torch.equal(det1, det2)

    window = presets.temporal_window(window=32, dsize=cvgs.Size(64, 128))
    window.ring.update(*ct_ops(0))
    pushes = [torch.roll(hd, 11 * k, dims=0) for k in range(1, 4)]
    _, n = preset_calls("temporal_window", "frame_resize", kfr, "cuda:frame_resize",
                        [lambda f=f: window.push(f) for f in pushes])
    frame_launches += n
    newest = cvgs.execute_operations(cvgs.resize(cvgs.image(pushes[-1]), cvgs.Size(64, 128)), to_unit,
                                     cvgs.split_tensor(), backend=cvgs.ParBackend.TORCH)
    assert tuple(window.tensor.shape) == (32, 3, 128, 64)
    assert float((window.tensor[0] - newest).abs().max()) <= F32_TOL

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        n_frames = 16
        rgb_frames = rng.integers(0, 256, (n_frames, FRAME_H, FRAME_W * 3), dtype=np.uint8)
        nv12_frames = rng.integers(0, 256, (n_frames, FRAME_H * 3 // 2, FRAME_W), dtype=np.uint8)
        for fmt, frames in (("rgb", rgb_frames), ("nv12", nv12_frames)):
            path = os.path.join(tmp, f"stream.{fmt}")
            frames.tofile(path)
            stream = presets.video_stream(path, FRAME_W, FRAME_H, dsize=cvgs.Size(*FRAME_DST),
                                          mean=MEAN, scale=STD, fmt=fmt,
                                          standard=cvgs.ColorStandard.BT709)
            assert stream.loader.native, "the native frame loader did not build"
            assert stream.loader.num_frames == n_frames
            kfr.LAUNCHES = 0
            outs, builds = [], []
            for out in stream:
                path_calls["frame_resize"] += 1
                assert cvgs.last_backend() == "cuda:frame_resize", cvgs.last_backend()
                outs.append(out)
                builds.append(executor.PLAN_BUILDS)
            torch.cuda.synchronize()
            stream.loader.close()
            frame_launches += kfr.LAUNCHES
            assert len(outs) == n_frames == kfr.LAUNCHES and builds[-1] == builds[0], (
                len(outs), kfr.LAUNCHES, builds)
            last = torch.from_numpy(frames[-1]).to(dev)
            head = (cvgs.resize(cvgs.image(last, channels=3), cvgs.Size(*FRAME_DST)) if fmt == "rgb"
                    else nv12_read(cvgs, last, FRAME_DST))
            eager = cvgs.execute_operations(head, to_unit, cvgs.subtract(MEAN), cvgs.divide(STD),
                                            cvgs.split_tensor(), backend=cvgs.ParBackend.TORCH)
            err = float((outs[-1] - eager).abs().max())
            first_differs = not torch.equal(outs[0], outs[-1])
            log(f"phase4 preset video_stream ({fmt}): {n_frames} frames of {FRAME_W}x{FRAME_H} "
                f"through the native loader ({frameloader.library_path().name}, built from "
                f"native/{frameloader.SOURCE.name}), 1 launch each, plans built after the first frame "
                f"{builds[-1] - builds[0]}; last frame vs eager torch max|diff| {err!r}")
            assert err <= F32_TOL and first_differs, (err, first_differs)

    cam_resize = presets.camera_pipeline(standard=cvgs.ColorStandard.BT709, alpha=True,
                                         out_size=cvgs.Size(*FRAME_DST))
    cam_resize(nv12_hd)
    (cam1, cam2), n = preset_calls("camera_pipeline(out_size)", "frame_resize", kfr,
                                   "cuda:frame_resize",
                                   [lambda: cam_resize(nv12_hd), lambda: cam_resize(nv12_hd2)])
    frame_launches += n
    assert tuple(cam2.shape) == (FRAME_DST[1], FRAME_DST[0], 4) and cam2.dtype == torch.uint8
    assert bool((cam2[..., 3] == 255).all()) and not torch.equal(cam1, cam2)
    cam_plain = presets.camera_pipeline(alpha=True)
    cam_plain(nv12_hd)
    (cam3, cam4), n = preset_calls("camera_pipeline()", "pointwise", kp, "cuda:pointwise",
                                   [lambda: cam_plain(nv12_hd), lambda: cam_plain(nv12_hd2)])
    pointwise_launches += n
    assert tuple(cam4.shape) == (FRAME_H, FRAME_W, 4) and cam4.dtype == torch.uint8
    assert torch.equal(cam4, cvgs.execute_operations(
        cvgs.read_yuv(nv12_hd2), cvgs.convert_yuv_to_rgb(alpha=True),
        backend=cvgs.ParBackend.TORCH))

    # the flagship through the cv2-typed shim, OpenCV's codes as literals
    kbr.LAUNCHES = 0
    shim = drive("batch_resize", lambda: cv2_compat.executeOperations(
        cv2_compat.resize_batch(frame, shifted, (64, 128), interpolation=cv2_compat.INTER_LINEAR),
        cv2_compat.convertTo(cv2_compat.CV_32F, alpha=ALPHA), cv2_compat.subtract(SUB),
        cv2_compat.divide(DIV), cv2_compat.split_tensor()))
    main_launches += kbr.LAUNCHES
    log(f"phase4 cv2_compat flagship: backend {cvgs.last_backend()}, launches {kbr.LAUNCHES}, "
        f"equal to the factories' call {torch.equal(shim, out2)}")
    assert cvgs.last_backend() == "cuda:batch_resize" and kbr.LAUNCHES == 1
    assert torch.equal(shim, out2)

    # ring updates in one launch: a resize head in all three layouts and both
    # orders, a warp head, a plain and a cropped frame through the pointwise
    # kernel, a float32 chain into uint8 and int16 rings (clamped, then
    # truncated in the store of each kernel)
    ring_alloc = 0
    ring_dtypes = {"resize": (np.float32, np.uint8, np.int16), "warp": (np.uint8,)}
    ring_kernels = {"resize": "frame_resize", "warp": "warp"}
    for planes in cvgs.ColorPlanes:
        for order in cvgs.CircularTensorOrder:
            for head, module in (("resize", kfr), ("warp", kw), ("plain", kp), ("crop", kp)):
                for ring_dtype in ring_dtypes.get(head, (np.float32, np.uint8)):
                    rt = cvgs.CircularTensor(64, 128, 3, 4, order=order, planes=planes,
                                             dtype=ring_dtype, device=dev)
                    twin = cvgs.CircularTensor(64, 128, 3, 4, order=order, planes=planes,
                                               dtype=ring_dtype, device="cpu")
                    small = hd[:128, :64].contiguous()

                    def ring_ops(k, src=None):
                        if head == "resize" and ring_dtype == np.float32:
                            return ct_ops(k) if src is None else (
                                cvgs.resize(cvgs.image(torch.roll(hd, 7 * k, dims=1).cpu()),
                                            cvgs.Size(64, 128)), to_unit)
                        base = (torch.roll(small, 3 * k, dims=1) if head == "plain"
                                else torch.roll(hd, 7 * k, dims=1))
                        base = base if src is None else base.cpu()
                        read = {"plain": lambda: cvgs.image(base),
                                "crop": lambda: cvgs.crop(cvgs.image(base),
                                                          cvgs.Rect(50 * k, 30 * k, 64, 128)),
                                "resize": lambda: cvgs.resize(cvgs.image(base), cvgs.Size(64, 128)),
                                "warp": lambda: cvgs.warp(
                                    cvgs.image(base), rotation((960, 540), 5.0 + k, 0.1, to=(32, 64)),
                                    cvgs.Size(64, 128))}[head]()
                        return (read, cvgs.convert_to(np.float32, alpha=1.7), cvgs.add(-70.25))

                    rt.update(*ring_ops(0))
                    twin.update(*ring_ops(0, "cpu"))
                    inputs = [ring_ops(k) for k in range(1, 6)]
                    module.LAUNCHES = 0
                    builds0 = executor.PLAN_BUILDS
                    torch.cuda.synchronize()
                    allocated0 = torch.cuda.memory_stats(dev)["allocated_bytes.all.allocated"]
                    for ops in inputs:
                        drive(ring_kernels.get(head, "pointwise"), lambda: rt.update(*ops))
                    torch.cuda.synchronize()
                    grown = (torch.cuda.memory_stats(dev)["allocated_bytes.all.allocated"]
                             - allocated0)
                    for k in range(1, 6):
                        twin.update(*ring_ops(k, "cpu"))
                    if head == "resize":
                        frame_launches += module.LAUNCHES
                    elif head == "warp":
                        warp_launches += module.LAUNCHES
                    else:
                        pointwise_launches += module.LAUNCHES
                    err = float((rt.tensor.cpu().double() - twin.tensor.double()).abs().max())
                    assert module.LAUNCHES == 5 and executor.PLAN_BUILDS == builds0, (
                        head, planes, order, ring_dtype, module.LAUNCHES)
                    tol = F32_TOL if (head, ring_dtype) == ("resize", np.float32) else 0.0
                    assert err <= tol, (head, planes, order, ring_dtype, err)
                    # five updates allocate their blocks of runtime values and
                    # nothing of a plane's size: no temporary of the frame
                    assert grown < 64 * 128 * 3, (head, planes, order, grown)
                    ring_alloc = max(ring_alloc, grown)
    log("phase4 CircularTensor.update: 1 launch per update and no plan, resize head (frame_resize: "
        "float32, uint8 and int16 rings), warp head (warp: a uint8 ring), plain and cropped frames "
        "(pointwise, float32 and uint8 rings), 3 layouts x 2 orders; every ring equal to a ring "
        f"updated on the CPU; device bytes allocated by 5 updates at most {ring_alloc} (one "
        f"128x64x3 uint8 plane is {64 * 128 * 3})")

    # ---- phase 5: times at the flagship shape
    def profiler_ms(fn, calls=20, what="a kernel"):
        """``utils.profiling.profiler_ms``, its empty traces logged here."""
        return profiling.profiler_ms(fn, calls, what, log=lambda msg: log(f"phase5 {msg}"))

    def measure(kernel_fn, plain_fn, iters, what="a kernel", plain_iters=None):
        """Event medians of the kernel and its plain version, alternating
        plain, kernel, kernel, plain, and the kernel's profiler duration."""
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            runs[which] += time_cuda(kernel_fn if which == "kernel" else plain_fn,
                                     iters=iters if which == "kernel" else (plain_iters or iters))
        return {"ms": float(np.median(runs["kernel"])), "plain_ms": float(np.median(runs["plain"])),
                "profiler_ms": profiler_ms(kernel_fn, what=what)}

    def library(t, fn, iters, what):
        """One library call's time by events (``library_ms``, as the kernel's
        ``ms``) and by the profiler (``library_profiler_ms``, as its
        ``profiler_ms``: the sum of its kernels), so either clock compares."""
        t["library_ms"] = float(np.median(time_cuda(fn, iters=iters)))
        t["library_profiler_ms"] = profiler_ms(fn, what=what)

    def describe(t):
        by_profiler = f"{t['profiler_ms'] * 1e3:.2f} us"
        text = (f"kernel {t['ms'] * 1e3:.2f} us by events, {by_profiler} by torch.profiler, "
                f"plain torch {t['plain_ms'] * 1e3:.2f} us (medians); bound "
                f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} at the published peaks, "
                f"{t['floor_ms'] * 1e3:.2f} us at the copy bandwidth = ({t['out_bytes']} out + "
                f"{t['src_bytes_touched']} source bytes touched, {t['flops']} flop at "
                f"{bounds.OP_PER_S / 1e12:.1f} T/s)")
        if t["library_ms"] is not None:
            text += (f"; library call (the read alone) {t['library_ms'] * 1e3:.2f} us by events, "
                     f"{t['library_profiler_ms'] * 1e3:.2f} us by torch.profiler")
        return text + f"; card {card}"

    # the copy bandwidth: a 256 MiB device copy reads and writes its bytes
    big = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    big_dst = torch.empty_like(big)
    big_ms = float(np.median(time_cuda(lambda: big_dst.copy_(big), iters=20)))
    bandwidth = 2 * big.numel() * 4 / (big_ms * 1e-3)
    log(f"phase5 copy bandwidth: {big.numel() * 4 / 2**20:.0f} MiB D2D copy {big_ms * 1e3:.2f} us "
        f"(events, median of 20) = {bandwidth / 1e9:.1f} GB/s read + write; card {card}")
    del big, big_dst

    rects_dev = torch.from_numpy(rects_a).to(dev)
    pipeline = cvgs.build_pipeline(*flagship_ops(cvgs, frame, rects_dev))
    # every leaf on the card, so that neither version copies from the host
    # inside the timed region
    pipeline = map_leaves(pipeline, lambda v: as_device_tensor(v, dev))
    args = kbr.prepare(pipeline, kbr.build_plan(pipeline), dev)
    k1 = measure(lambda: kbr.batch_resize(args), lambda: kbr.batch_resize_reference(args), 100)
    # 12 float operations per output value for the three lerps, one per chain op
    k1.update(bounds.bound(*kbr.work(args), bandwidth))
    # no single PyTorch call crops at runtime rects and resizes
    k1["library_ms"] = k1["library_profiler_ms"] = None
    kernel_ms, plain_ms = k1["ms"], k1["plain_ms"]
    log(f"phase5 batch_resize flagship: {describe(k1)}")

    # one execute_operations call, whole and taken apart into its host
    # layers in its own order, alternating in one loop (the host-overhead
    # benchmark's own split)
    parts = host_overhead.host_layers(lambda: flagship_ops(cvgs, frame, rects_a), dev)
    host_ms = float(np.median(parts["whole"])) * 1e3
    log(f"phase5 kernel {kernel_ms * 1e3:.2f} us/batch, plain torch {plain_ms * 1e3:.2f} us/batch "
        f"(device time, events, median of 200); execute_operations host-inclusive "
        f"{host_ms * 1e3:.2f} us/call; card {card}")
    log("phase5 host layers, us/call, median of 100: "
        + ", ".join(f"{k} {np.median(v) * 1e6:.2f}" for k, v in parts.items()))

    # device busy time and idle share of the main path, from a profiler trace
    calls = 20
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            main_path(rects_a)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy.setdefault(e.name, []).append(e.time_range.elapsed_us())
    for name, v in busy.items():
        log(f"phase5 trace: {len(v)} x {name[:90]}: median {np.median(v):.2f} us")
    busy_us = sum(sum(v) for v in busy.values())
    log(f"phase5 trace: device busy {busy_us / calls:.2f} us/call of {wall_us / calls:.2f} us/call "
        f"on the host clock under the profiler; idle share {1 - busy_us / wall_us:.4f} under the "
        f"profiler, {1 - busy_us / calls / (host_ms * 1e3):.4f} against the unprofiled call")

    # floors: the event floor of any launch, and a copy of the output's bytes
    tiny = torch.empty(1, device=dev)
    copy_dst = torch.empty_like(out1)
    fill_ms = float(np.median(time_cuda(lambda: tiny.fill_(0.0), iters=100)))
    copy_ms = float(np.median(time_cuda(lambda: copy_dst.copy_(out1), iters=100)))
    log(f"phase5 floors: one-element fill_ {fill_ms * 1e3:.2f} us; D2D copy of "
        f"{out1.numel() * 4 / 1e6:.2f} MB {copy_ms * 1e3:.2f} us (events, median of 100)")

    # the frame paths: kernel vs plain version, the whole call, the bound; for
    # (a) one library call that does the resample alone
    import torch.nn.functional as F

    frame_times = {}
    for path, (ops, src1, _, shape) in frame_inputs.items():
        pipe = map_leaves(cvgs.build_pipeline(*ops(src1)), lambda v: as_device_tensor(v, dev))
        fplan = kfr.build_plan(pipe)
        fargs = kfr.prepare(pipe, fplan, dev)
        t = measure(lambda: kfr.frame_resize(fargs), lambda: kfr.frame_resize_reference(fargs), 50)
        whole = []
        for _ in range(60):
            t0 = time.perf_counter()
            frame_path(ops(src1))
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        # the lerps, and for NV12 the YUV -> RGB sums (about 3 per value)
        t.update(bounds.bound(*kfr.work(fargs), bandwidth))
        t["library_ms"] = t["library_profiler_ms"] = None
        if path == "a":
            # F.interpolate of a float32 NCHW copy: the resample alone, with
            # no uint8 read, no chain and no planar write of its own
            nchw = src1.permute(2, 0, 1)[None].float().contiguous()
            library(t, lambda: F.interpolate(nchw, size=(FRAME_DST[1], FRAME_DST[0]),
                                             mode="bilinear", align_corners=False), 50,
                    "F.interpolate")
        frame_times[path] = t
        log(f"phase5 frame path ({path}): {describe(t)}; execute_operations host-inclusive "
            f"{t['call_ms'] * 1e3:.2f} us/call (median of 50)")

    # the warp cases: kernel vs plain version, the bytes floor; the whole
    # call of the batch
    def grid_sample_theta(read, w_in, h_in):
        """``affine_grid``'s normalized 2x3 matrix of a warp's inverse map
        (pixel centres, ``align_corners=False``)."""
        c = np.asarray(torch.as_tensor(read.coeffs).cpu(), np.float64).reshape(-1)[:6].reshape(2, 3)
        w_out, h_out = read.dsize

        def to_norm(xn, yn):
            px, py = ((xn + 1) * w_out - 1) / 2, ((yn + 1) * h_out - 1) / 2
            sx, sy = c @ (px, py, 1.0)
            return np.array([(2 * sx + 1) / w_in - 1, (2 * sy + 1) / h_in - 1])

        o = to_norm(0.0, 0.0)
        return np.stack([to_norm(1.0, 0.0) - o, to_norm(0.0, 1.0) - o, o], axis=1)

    warp_times = {}
    for name in ("w1_k3_separable", "w2_k4_rotation", "w5_k5a_perspective_640x384",
                 "w6_k5b_batch8_ragged7"):
        pipe = map_leaves(cvgs.build_pipeline(*warp_cases[name]),
                          lambda v: as_device_tensor(v, dev))
        wargs = kw.prepare(pipe, kw.build_plan(pipe), dev)
        t = measure(lambda: kw.warp(wargs), lambda: kw.warp_reference(wargs), 25)
        # two coordinates and the lerps per value; a perspective map divides
        t.update(bounds.bound(*kw.work(wargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        t["library_ms"] = t["library_profiler_ms"] = None
        if not wargs.plan.perspective:
            # F.grid_sample over F.affine_grid on a float32 NCHW copy (one
            # frame, expanded over the batch): the resample alone, with no
            # uint8 read, no per-channel border, no chain, no ragged planes
            reads = pipe.read.ops if wargs.plan.batch else (pipe.read,)
            theta = torch.from_numpy(np.stack([grid_sample_theta(r, FRAME_W, FRAME_H)
                                               for r in reads])).float().to(dev)
            nchw = hd.permute(2, 0, 1)[None].float().contiguous().expand(len(reads), -1, -1, -1)
            size = (len(reads), 3, WARP_DST[1], WARP_DST[0])
            library(t, lambda: F.grid_sample(nchw, F.affine_grid(theta, size, align_corners=False),
                                             mode="bilinear", padding_mode="zeros",
                                             align_corners=False), 25, "F.grid_sample")
        warp_times[name] = t
        log(f"phase5 warp {name}: {describe(t)}")
    whole = []
    for _ in range(60):
        t0 = time.perf_counter()
        warp_path(warp_batch_ops(cvgs, cvgs.image(hd), -10.0, 7))
        torch.cuda.synchronize()
        whole.append(time.perf_counter() - t0)
    w6 = warp_times["w6_k5b_batch8_ragged7"]
    w6["call_ms"] = float(np.median(whole[10:])) * 1e3
    log(f"phase5 warp w6_k5b_batch8_ragged7: execute_operations host-inclusive "
        f"{w6['call_ms'] * 1e3:.2f} us/call (median of 50), kernel {w6['ms'] * 1e3:.2f} us; "
        f"card {card}")

    # the divergent kernel at the reference's rows D1-D4, the host-inclusive
    # call of D4, one CircularTensor update
    div_times = {}
    for name in ("d1_circular_first3", "d2_nv12_bt709", "d3_crop_resize", "d4_warp_crop_pass"):
        ids, seqs = divergent_cases[name]
        seqs = map_leaves(seqs, lambda v: as_device_tensor(v, dev))
        dargs = kd.prepare(seqs, kd.build_plan(seqs, ids), dev)
        t = measure(lambda: kd.divergent(dargs), lambda: kd.divergent_reference(dargs), 25)
        t.update(bounds.bound(*kd.work(dargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        # no PyTorch call runs a different sequence per plane
        t["library_ms"] = t["library_profiler_ms"] = None
        div_times[name] = t
        log(f"phase5 divergent {name}: {describe(t)}")
    whole = []
    for _ in range(60):
        t0 = time.perf_counter()
        ids, seqs = d4()
        cvgs.launch_divergent_batch(ids, *seqs)
        torch.cuda.synchronize()
        whole.append(time.perf_counter() - t0)
    d4t = div_times["d4_warp_crop_pass"]
    d4t["call_ms"] = float(np.median(whole[10:])) * 1e3
    whole = []
    for k in range(60):
        t0 = time.perf_counter()
        ct.update(*ct_ops(k))
        torch.cuda.synchronize()
        whole.append(time.perf_counter() - t0)
    ct_update_ms = float(np.median(whole[10:])) * 1e3
    log(f"phase5 divergent d4_warp_crop_pass: launch_divergent_batch host-inclusive "
        f"{d4t['call_ms'] * 1e3:.2f} us/call (median of 50), kernel {d4t['ms'] * 1e3:.2f} us; "
        f"CircularTensor.update host-inclusive {ct_update_ms * 1e3:.2f} us/call (median of 50); "
        f"card {card}")


    # one CircularTensor update, before and after: the three steps that ran
    # until the wrappers took out= (the pipeline into a temporary, the cast,
    # a copy_ of the permuted value into the slot), then update() itself
    def update_in_three_steps(k):
        x = cvgs.execute_operations(*ct_ops(k))
        ct._ring[k % 32].copy_(dt.astype(x, ct.dtype).permute(2, 0, 1))

    ring_update = {}
    for label, fn in (("three_steps", update_in_three_steps), ("one_launch", lambda k: ct.update(*ct_ops(k))),
                      ("one_launch", lambda k: ct.update(*ct_ops(k))), ("three_steps", update_in_three_steps)):
        whole = []
        for k in range(60):
            t0 = time.perf_counter()
            fn(k)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        ring_update.setdefault(label, []).append(float(np.median(whole[10:])) * 1e3)
    frame7 = torch.roll(hd, 7, dims=1)
    step_ops = (cvgs.resize(cvgs.image(frame7), cvgs.Size(64, 128)), to_unit)
    step_pipe = map_leaves(cvgs.build_pipeline(*step_ops), lambda v: as_device_tensor(v, dev))
    step_args = kfr.prepare(step_pipe, kfr.build_plan(step_pipe), dev)
    slot_pipe = map_leaves(cvgs.build_pipeline(*step_ops, cvgs.split_tensor()),
                           lambda v: as_device_tensor(v, dev))
    slot_args = kfr.prepare(slot_pipe, kfr.build_plan(slot_pipe), dev)

    def device_three_steps():
        ct._ring[5].copy_(kfr.frame_resize(step_args).permute(2, 0, 1))

    ring_update["device_three_steps_ms"] = profiler_ms(device_three_steps, what="the three-step update")
    ring_update["device_one_launch_ms"] = profiler_ms(
        lambda: kfr.frame_resize(slot_args, out=ct._ring[5]), what="the one-launch update")
    log(f"phase5 CircularTensor.update (32 x 3 x 128 x 64 f32 ring, a 1080p frame resized): the "
        f"three steps {ring_update['three_steps'][0] * 1e3:.2f}, {ring_update['three_steps'][1] * 1e3:.2f} "
        f"us/call on the host clock and {ring_update['device_three_steps_ms'] * 1e3:.2f} us of device "
        f"time by torch.profiler; update() in one launch {ring_update['one_launch'][0] * 1e3:.2f}, "
        f"{ring_update['one_launch'][1] * 1e3:.2f} us/call and "
        f"{ring_update['device_one_launch_ms'] * 1e3:.2f} us (medians of 50, of 20); card {card}")

    # the pointwise kernel in P1-P5: kernel vs plain version, bound, floor; a
    # library call where one PyTorch call does the read alone
    pw_times = {}
    for name, ops in pointwise_rows(cvgs, *pw_values[0]).items():
        pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: as_device_tensor(v, dev))
        pargs = kp.prepare(pipe, kp.build_plan(pipe), dev)
        mad = name.startswith("p1")
        t = measure(lambda: kp.pointwise(pargs), lambda: kp.pointwise_reference(pargs),
                    20 if mad else 50, what=name, plain_iters=5 if mad else None)
        # one operation per value and chain row (P5: the conversion's 7 too),
        # every row's whole source but P4's crop
        t.update(bounds.bound(*kp.work(pargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        # no single PyTorch call runs a chain, a ring read or NV12 -> RGBA
        t["library_ms"] = t["library_profiler_ms"] = None
        if name.startswith("p3"):
            # F.pad of a float32 NCHW copy: the border alone, with no uint8
            # read, no scale and no planar write of its own
            nchw = hd.permute(2, 0, 1)[None].float().contiguous()
            library(t, lambda: F.pad(nchw, (BORDER,) * 4, mode="replicate"), 50, "F.pad")
        if name.startswith("p4"):
            # a slice made contiguous: the crop alone, at a fixed origin, with
            # no x1/255 and no float cast (the kernel does both)
            library(t, lambda: hd[824:1080, 1620:1876].contiguous(), 50, "a contiguous slice")
        whole = []
        for _ in range(60):
            t0 = time.perf_counter()
            cvgs.execute_operations(*ops)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        pw_times[name] = t
        log(f"phase5 pointwise {name}: {describe(t)}; execute_operations host-inclusive "
            f"{t['call_ms'] * 1e3:.2f} us/call (median of 50)")

    # what no kernel takes: an int32 frame through a 3-op chain, one launch
    # per op on the eager path
    hd_i32 = hd.to(torch.int32)
    eager_ops = (cvgs.image(hd_i32), cvgs.convert_to(np.float32, alpha=1 / 255.0),
                 cvgs.subtract(MEAN), cvgs.divide(STD), cvgs.split_tensor())
    eager_ms = float(np.median(time_cuda(lambda: cvgs.execute_operations(*eager_ops), iters=20)))
    assert cvgs.last_backend() == "torch"
    same_u8 = (cvgs.image(hd), *eager_ops[1:])
    kernel_ms_u8 = float(np.median(time_cuda(lambda: cvgs.execute_operations(*same_u8), iters=20)))
    assert cvgs.last_backend() == "cuda:pointwise"
    log(f"phase5 eager int32 pipeline (1080p int32 -> x1/255, normalize, planar f32): "
        f"{eager_ms * 1e3:.2f} us by events on the eager path (torch), against {kernel_ms_u8 * 1e3:.2f} "
        f"us for the same chain on a uint8 frame through cuda:pointwise (host-bound: events around "
        f"whole execute_operations calls); card {card}")

    # ---- phase 6: the batch axis sharded over a device mesh (parallel/mesh.py)
    # (a) every rank of meshes of 2 to 8 on this card, through the rank-local
    # function both sharded entry points run: one launch of the path's kernel
    # per rank, no plan after the first (a divergent batch: one per distinct
    # local routing), a second round with new rects, first and used_planes
    # building none either; each rank against its kernel's plain version, the
    # ranks joined against the unsharded call bit for bit
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from cvgpuspeedup_tpu_torch.parallel import mesh as pmesh

    modules = {"batch_resize": kbr, "warp": kw, "pointwise": kp, "divergent": kd}
    hd_read = cvgs.image(hd)
    shard_rows = {  # name: (kernel, mesh sizes, one case per round)
        "flagship_50_ragged37": ("batch_resize", (2, 5), [
            cvgs.build_pipeline(*flagship_ops(cvgs, frame, rects_a, used=37)),
            cvgs.build_pipeline(*flagship_ops(cvgs, frame, shifted, used=23))]),
        "w6_batch8_ragged7": ("warp", (2, 4, 8), [
            cvgs.build_pipeline(*warp_batch_ops(cvgs, hd_read, -10.0, 7)),
            cvgs.build_pipeline(*warp_batch_ops(cvgs, hd_read, -8.0, 5))]),
        "p2_ring": ("pointwise", (2, 4, 8), [cvgs.build_pipeline(*p2_ops(cvgs, ring, 3)),
                                            cvgs.build_pipeline(*p2_ops(cvgs, ring, -5))]),
        "d1_circular": ("divergent", (2, 4, 8), [d1(3), d1(-5)]),
        "d3_crop_resize": ("divergent", (2, 4, 8), [d3(d3_rects(0)), d3(d3_rects(7))]),
    }

    def unsharded(kernel, case):
        if kernel == "divergent":
            return cvgs.launch_divergent_batch(case[0], *case[1])
        return executor.run_pipeline(case, device=dev)

    def rank_of(kernel, case, index, nsh):
        """Rank ``index``'s local pipeline (a divergent batch: its local
        sequences and its slice of the plane ids)."""
        if kernel != "divergent":
            return pmesh._local_pipeline(case, index, nsh), None
        ids, seqs = case
        ln = len(ids) // nsh
        return (tuple(pmesh._local_pipeline(s, index, nsh, len(ids)) for s in seqs),
                ids[index * ln:(index + 1) * ln])

    def plain_of(kernel, local, ids):
        module, _, plain = kernels[kernel]
        plan = module.build_plan(local, ids) if ids is not None else module.build_plan(local)
        return plain(module.prepare(local, plan, dev))

    def diff(got, want, what):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {got.shape} {got.dtype}, plain {want.shape} {want.dtype}")
        if not got.dtype.is_floating_point:
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: {got.dtype} values differ from the plain version")
            return 0.0
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite kernel output")
        return float((got - want).abs().max())

    wholes = {name: [unsharded(kernel, case) for case in cases]
              for name, (kernel, _, cases) in shard_rows.items()}
    torch.cuda.synchronize()
    shard_ranks = {name: 0 for name in modules}
    for module in (kbr, kfr, kw, kd, kp):
        module.LAUNCHES = 0
    for name, (kernel, meshes, cases) in shard_rows.items():
        module = modules[kernel]
        for nsh in meshes:
            builds0, plans, err = executor.PLAN_BUILDS, set(), 0.0
            for k, case in enumerate(cases):
                outs = []
                for i in range(nsh):
                    local, ids = rank_of(kernel, case, i, nsh)
                    launches, builds = module.LAUNCHES, executor.PLAN_BUILDS
                    out = (cvgs.launch_divergent_batch(ids, *local) if ids is not None
                           else executor.run_pipeline(local, device=dev))
                    outs.append(out)
                    shard_ranks[kernel] += 1
                    what = f"{name} rank {i} of {nsh}, round {k}"
                    assert cvgs.last_backend() == f"cuda:{kernel}", (what, cvgs.last_backend())
                    assert module.LAUNCHES == launches + 1, (what, module.LAUNCHES - launches)
                    routing = tuple(ids) if ids is not None else "one plan"
                    if routing in plans:
                        assert executor.PLAN_BUILDS == builds, f"{what} built a plan"
                    else:
                        assert executor.PLAN_BUILDS <= builds + 1, what
                        plans.add(routing)
                    err = max(err, diff(out, plain_of(kernel, local, ids), what))
                torch.cuda.synchronize()
                assert torch.equal(torch.cat(outs), wholes[name][k]), \
                    f"{name} over {nsh} ranks, round {k}: the ranks joined differ from unsharded"
            assert err <= F32_TOL, (name, nsh, err)
            max_err[kernel] = max(max_err[kernel], err)
            log(f"phase6 sharded {name} over {nsh} ranks: {2 * nsh} rank calls in 2 rounds, each 1 "
                f"launch of cuda:{kernel}; plans built {executor.PLAN_BUILDS - builds0} for "
                f"{len(plans)} distinct local routings; max|diff| vs plain {err!r}; the ranks "
                f"joined equal the unsharded call bit for bit")
    sharded_launches = {name: module.LAUNCHES for name, module in modules.items()}
    log(f"phase6 launches over the rank calls: {sharded_launches}, frame_resize {kfr.LAUNCHES}")
    assert sharded_launches == shard_ranks and kfr.LAUNCHES == 0, (sharded_launches, shard_ranks)

    # (b) the entry points through a one-rank NCCL process group on this card:
    # DTensors sharded on the write layout's plane axis, full_tensor() equal
    # to the unsharded call, one launch per call and no collective in a trace
    # of 20 calls; then the host cost the wrapper adds to the flagship call,
    # and one rank of two (25 planes) beside the unsharded 50-plane batch
    with tempfile.TemporaryDirectory() as tmp:
        mesh = pmesh.initialize_distributed(f"file://{tmp}/store", 1, 0)
        assert mesh.device_type == "cuda" and mesh.size() == 1, mesh
        flagship50 = wholes["flagship_50_ragged37"][0]
        d3_ids, d3_seqs = d3(d3_rects(0))
        entry_cases = {
            "flagship": (lambda: pmesh.execute_sharded(*flagship_ops(cvgs, frame, rects_a, used=37),
                                                       mesh=mesh), flagship50, 0),
            "flagship_transposed": (
                lambda: pmesh.execute_sharded(*flagship_ops(cvgs, frame, rects_a, used=37,
                                                            write=cvgs.split_tensor_transposed),
                                              mesh=mesh),
                flagship50.transpose(0, 1).contiguous(), 1),
            "w6_batch8_ragged7": (lambda: pmesh.execute_sharded(
                *warp_batch_ops(cvgs, hd_read, -10.0, 7), mesh=mesh),
                wholes["w6_batch8_ragged7"][0], 0),
            "p2_ring": (lambda: pmesh.execute_sharded(*p2_ops(cvgs, ring, 3), mesh=mesh),
                        wholes["p2_ring"][0], 0),
            "d3_crop_resize": (lambda: pmesh.execute_divergent_sharded(
                d3_ids, *d3_seqs, mesh=mesh), wholes["d3_crop_resize"][0], 0),
        }
        for module in (kbr, kfr, kw, kd, kp):
            module.LAUNCHES = 0
        for name, (call, want, dim) in entry_cases.items():
            before = {k: m.LAUNCHES for k, m in modules.items()}
            out = call()
            moved = {k: m.LAUNCHES - before[k] for k, m in modules.items() if m.LAUNCHES != before[k]}
            assert isinstance(out, DTensor), type(out)
            assert tuple(out.placements) == (Shard(dim),), (name, out.placements)
            assert tuple(out.shape) == tuple(want.shape), (name, out.shape, want.shape)
            assert list(moved.values()) == [1], (name, moved)
            full = out.full_tensor()
            assert torch.equal(full, want), f"execute_sharded {name}: full_tensor() differs"
            log(f"phase6 execute_sharded {name} on the one-rank NCCL mesh: {out.placements}, "
                f"global {tuple(out.shape)}, local {tuple(out.to_local().shape)}, launches {moved}; "
                f"full_tensor() equal to the unsharded call")
        for _ in range(8):  # an empty trace is taken again, as profiler_ms does
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    entry_cases["flagship"][0]()
                torch.cuda.synchronize()
            names = {e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA}
            if names:
                break
            time.sleep(0.5)
        log(f"phase6 trace of 20 execute_sharded calls: device kernels {sorted(n[:60] for n in names)}")
        assert any("batch_resize" in n for n in names), names
        assert not any("nccl" in n.lower() for n in names), names

        rects_dev = torch.from_numpy(rects_a).to(dev)
        p50 = map_leaves(cvgs.build_pipeline(*flagship_ops(cvgs, frame, rects_dev, used=37)),
                         lambda v: as_device_tensor(v, dev))
        loc25 = pmesh._local_pipeline(p50, 0, 2)
        a25 = kbr.prepare(loc25, kbr.build_plan(loc25), dev)
        a50 = kbr.prepare(p50, kbr.build_plan(p50), dev)
        shard_times = {
            "rank0_of_2_25_planes": measure(lambda: kbr.batch_resize(a25),
                                            lambda: kbr.batch_resize_reference(a25), 100),
            "unsharded_50_planes": measure(lambda: kbr.batch_resize(a50),
                                           lambda: kbr.batch_resize_reference(a50), 100),
        }
        host = {"execute_operations_50": [], "execute_sharded_1rank_50": [],
                "rank0_of_2_25": [], "local_pipeline": [], "from_local": []}
        for _ in range(110):
            t0 = time.perf_counter()
            cvgs.execute_operations(*flagship_ops(cvgs, frame, rects_a, used=37))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pmesh.execute_sharded(*flagship_ops(cvgs, frame, rects_a, used=37), mesh=mesh)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            p = cvgs.build_pipeline(*flagship_ops(cvgs, frame, rects_a, used=37))
            t3 = time.perf_counter()
            loc = pmesh._local_pipeline(p, 0, 2)
            t4 = time.perf_counter()
            out = executor.run_pipeline(loc, device=dev)
            t5 = time.perf_counter()
            pmesh._sharded(out, mesh, p.write)
            t6 = time.perf_counter()
            torch.cuda.synchronize()
            t7 = time.perf_counter()
            for k, v in zip(host, (t1 - t0, t2 - t1, (t5 - t2) + (t7 - t6), t4 - t3, t6 - t5)):
                host[k].append(v)
        host_us = {k: float(np.median(v[10:])) * 1e6 for k, v in host.items()}

        # ---- phase 7: the benchmarks and the examples, scaling on this group
        bench = phase7(mesh, {"batch_resize": kbr, "frame_resize": kfr, "warp": kw,
                              "divergent": kd, "pointwise": kp})
        dist.destroy_process_group()
    for name, t in shard_times.items():
        log(f"phase6 batch_resize {name}: kernel {t['ms'] * 1e3:.2f} us by events, "
            f"{t['profiler_ms'] * 1e3:.2f} us by torch.profiler, plain torch "
            f"{t['plain_ms'] * 1e3:.2f} us (medians); card {card}")
    log("phase6 host-inclusive flagship calls, us/call, median of 100: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host_us.items())
        + " (rank0_of_2_25: build, the rank's local pipeline, run_pipeline, sync; the last two "
        f"are the wrapper's own layers); card {card}")
    shard_times["host_us"] = host_us

    for mod in ("jax", "cv2"):
        assert mod not in sys.modules, f"{mod} was imported"
    def entry(name, source, replaces, launches, times, **more):
        """One kernel of the line: the contract's keys from the case of its
        main path, its launches over the calls phase 4 drove, then whatever
        else was measured."""
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "profiler_ms", "floor_ms",
                "library_profiler_ms")
        return {"name": name, "route": "cuda",
                "source": f"cvgpuspeedup_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": launches, "launches_per_call": launches / path_calls[name],
                "max_abs_err": max_err[name], **{k: times[k] for k in keys},
                "phase7_launches": bench["launches"][name], "phase7_rows": bench["rows"][name],
                **more}

    print(card)
    print(json.dumps({"kernels": [
        entry("batch_resize", "batch_resize.cu", "cvgpuspeedup_tpu/exec/pallas_backend.py:500",
              main_launches, k1, cases={"flagship": k1},
              sharded_launches=sharded_launches["batch_resize"], sharding=shard_times),
        # path (a); both paths below
        entry("frame_resize", "frame_resize.cu", "cvgpuspeedup_tpu/exec/pallas_frame.py:663",
              frame_launches, frame_times["a"],
              paths={"a_1080p_rgb_to_640x360": frame_times["a"],
                     "b_nv12_6k_to_1080p": frame_times["b"]}),
        # W6, the batch of the main path (the batched TPU kernel); the
        # single-image classes and the timed cases below
        entry("warp", "warp.cu", "cvgpuspeedup_tpu/exec/pallas_warp_universal.py:741",
              warp_launches, w6,
              also_replaces=["cvgpuspeedup_tpu/exec/pallas_warp.py:202",
                             "cvgpuspeedup_tpu/exec/pallas_warp_general.py:272",
                             "cvgpuspeedup_tpu/exec/pallas_warp_universal.py:359"],
              cases=warp_times, sharded_launches=sharded_launches["warp"]),
        # D4, the reference's warp | crop | pass row; D1-D4 below
        entry("divergent", "divergent.cu", "cvgpuspeedup_tpu/exec/pallas_divergent.py:686",
              divergent_launches, d4t, cases=div_times,
              circular_tensor_update_ms=ct_update_ms,
              sharded_launches=sharded_launches["divergent"]),
        # P1, the MAD stress (bound by its unfused operations); P1-P5 below. No
        # Pallas counterpart: it replaces the reference's jitted XLA program
        entry("pointwise", "pointwise.cu", "cvgpuspeedup_tpu/exec/executor.py:243",
              pointwise_launches, pw_times["p1_mad_200_ops_2048x2048"], cases=pw_times,
              circular_tensor_update=ring_update, eager_int32_pipeline_ms=eager_ms,
              sharded_launches=sharded_launches["pointwise"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
