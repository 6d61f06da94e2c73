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
the composed path (kernel ``composed``): C1-C8 (``composed_cases``), a
region of interest of the 4K frame resized, ComputeWhatYouSee, a 640x640
letterbox, a warp of a crop, a border then a resize, ``crop_batch``, a crop
of a fused gray conversion and a 6K NV12 buffer converted into uint8 per tap
and resized, and B1-B7 (``batch_cases``), ``batch_read`` of per-plane read
trees: eight 1080p cameras each resized to 640x360 (B1; B2 ragged at 5),
an 800x600 region of interest of each resized to 224x224, eight 640x640
letterboxes, warps of 960x540 crops, 50 crops of 224x224 of the 4K frame
ragged at 37, the bare cameras, M1-M5 (``mixed_cases``), ``batch_read`` of
planes of one shape and each its own geometry: eight cameras of three
resolutions (two 4K, three 1080p, three 720p) each resized to 640x360 (M1;
M2 ragged at 6), eight regions of interest of the 4K frame of eight sizes
each letterboxed into 640x640, crops of 640x480 to 1280x960 of the cameras
rotated into 640x360, NV12 buffers of 1080p and 720p converted into uint8
per tap and resized, and N1-N6 (``nested_cases``), two levels of
resampling or a fused read above the core: a 1080p top view resized, the
4K frame resized and rotated, a two-level downscale, a crop of a downscale
resized, a letterbox of a normalized resize, eight cameras' top views
ragged at 6, and two more in phase 3 alone (``budget_nested_cases``): a
warp at a quarter of the scale of a 1080p resize, whose blocks' footprints
pass the staging budget (they evaluate per tap), and a 640x360 downscale
resized back up to 1080p (a block's taps shared), and NM1-NM4
(``nested_mixed_cases``), ``batch_read`` of nested planes each of its own
geometry: N6's top views over the eight cameras of three resolutions, ragged
at 6, N5's normalized letterbox over eight ROIs of the 4K frame of eight
sizes, the cameras resized to half their size and rotated into 640x360, and
crops of eight sizes of each camera resized to 960x540, resized to 224x224
(its planes disagree on staging); DV1-DV4 (``divergent_composed_cases``),
divergent batches of composed read trees, which the divergent kernel
refuses, through ``launch_divergent_batch`` in one launch of the composed
kernel (``cuda:composed:divergent``): letterboxes of the 1080p cameras
beside warps of 1280x960 cameras into 640x640, regions of interest of 200 to
900 pixels of the 4K frame beside those of a 12-bit uint16 sensor frame into
224x224, a uint8 chain beside a ragged float32 group stored into a uint8
batch, ``crop_batch`` beside bordered crops; DVN1-DVN4
(``divergent_nested_cases``), divergent batches with a nested group in one
launch of the composed kernel's nested instances: letterboxes of the 1080p
cameras beside top views of the others into 640x640, per-tap top views
(ragged) beside staged rotated downscales into 640x360, N5's normalized
letterboxes beside regions of a 12-bit uint16 sensor frame resized twice
(two sources: the general nested instances), NV12 letterboxes beside NV12
top views; DK1-DK4 (``split_cases``), divergent batches that neither the
divergent kernel nor the composed kernel's divergent plan takes alone,
through ``launch_divergent_batch`` in one launch of the split kernel
(``cuda:divergent:split``: each block runs the divergent kernel's body or
the composed kernel's, by its plane's part): a tracker's ring of 640x640
planes beside letterboxes of the 1080p cameras, ``resize_batch`` crops of
the 4K frame beside similarity warps of crops of it into 112x112, a stack
of 720p images resized beside a 12-bit sensor's regions of interest into
640x360, 1080p NV12 cameras converted and resized beside top views of the
RGB cameras into 640x360; and the batch axis of the flagship, W6, P2, D1
and D3 sharded over a device mesh (``parallel/mesh.py``).
In phases; any failure ends the run with a non-zero exit
code and no result line:

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build: compile every kernel source, in parallel, into one library (timed;
   the composed kernel's nested instances' registers and spills logged on
   their own, and those of K6's instances and of its general instance, the
   staged mixed nested instance held at 64 registers, 4 blocks an SM, the
   three general nested instances of a divergent batch named, the split
   kernel's 20 instances with their shared memory, its staged ones held at
   64 registers), then read the library's SASS (``tools/kernel_sass.py``, ``cuobjdump
   -sass``): in every instance of the six kernels and the split kernel no float32 add, multiply,
   compare or min/max without ``.FTZ`` (``-ftz=true``: the reference's
   float32 rule, ``utils/dtypes.py::flush_subnormal``) but for a warp map's
   terms, an ``FMUL`` or ``FADD`` in the warp, divergent, composed and split
   kernels (``tools/kernel_sass.py::KEEP_TERMS``), and the float64 load's
   ``F2F.F32.F64`` without it;
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
   Every dtype of a chain (``dtype_cases``, ``dtype_store_cases``): K1, K2,
   the warp kernel and the pointwise kernel on int8, uint16, int16 and
   float16 sources at their main paths' shapes, chains through each of
   those dtypes back to float32 and stored in it (float16 planes among
   them) in all five kernels, a uint16 group stored into a uint8 batch and
   float16 crops with uint8 images in one batch, and a chain of one dtype
   into an ``out=`` view of another in each kernel that takes one (uint16
   into uint8, uint8 into int16, float16 into uint8).
   int32 (``int32_cases``, ``int32_store_cases``), max |diff| 0: int32
   sources of K1, K2 and the warp kernel (read into float32) and of the
   pointwise kernel (copies, rings, crops and borders of its bits), values
   past 2^24 and within 64 of int32's bounds (``as_int32``); chains through
   int32 in all five kernels (an op on it, its wraps, saturates, gray and
   alpha); int32 chains into uint8 and float32 views and float chains into
   int32 views; and a float32 source of values past every integer range,
   the infinities and NaN (``EDGES``) cast into uint8, int16 and int32 in
   every kernel.
   64-bit sources (``x64_cases``), max |diff| 0: int64 and float64 tensors on
   the card, read at load as int32 (the low 32 bits) and float32 (rounded),
   in K1, K2 and the warp kernel (W2, W6), in the pointwise kernel (a ring, a
   crop, a CONSTANT border, a one-channel image, an op; float64 values past
   float32's range and below its normals copied) and float64 groups of K6
   (D1, D4, a stack resize).
   Every source dtype of K6 (``k6_source_cases``, its general instance
   ``divergent_any.cu``), bit for bit as the outputs' bits: D1, D3 and D4
   with their ring, frame, images and flat planes in int8, uint16, int16,
   float16, int32 (values within 64 of its bounds and past 2^24) and int64
   (tensors read at load), a uint16 ring beside uint8 crops into uint8, a
   float16 stack beside float32 warps into float16, and groups of five
   source dtypes in a batch of 16 x 128 x 256 planes (4 pixels a thread).
   Subnormal float32 values (``subnormal_cases``): sources with a sixteenth
   of their values from ``EDGES32`` (subnormals, and values whose products
   underflow) through K1's flagship, K2's frame (a), W6, D1, P1 at 512x512
   and P3, chains with a subnormal scalar and a divide that flushes more
   than half the results; each kernel one launch, equal to its plain version as
   int32 bits (-0 and +0 differ), more than 0 outputs flushed to 0 and none
   subnormal; and a float64 crop of ``EDGES64`` that keeps 1e-40 and -1e-42.
   composed in C1-C8, B1-B7, M1-M5 (each plane's head in the consts, the
   mixed-geometry instances), N1-N6 and N7-N8 (``budget_nested_cases``, the
   per-tap form past the staging budget and an upscale's shared taps; each
   nested case's blocks' forms logged from ``nested_tiles``), NM1-NM4 (each
   plane's head and ``stage2`` in the consts, the mixed nested instances;
   each plane's blocks' forms logged), DV1-DV4 (each plane's head its
   group's, the divergent kernel's refusal logged), DVN1-DVN4 (every head a
   nested one, each plane's second level, stage2 and blocks' forms and the
   instance logged), DV1 with every plane lifted into the nested instances
   (an identity resize; an empty FusedRead2: bit-equal to DV1's own launch)
   and DVN1's trees over float32 cameras of ``EDGES32`` (NaN, infinities,
   subnormals) as int32 bits, DK1-DK4 and three more split batches
   (``split_form_cases``: one-pixel reads into a uint8 batch, a staged part
   into uint16, a FusedRead2 part into float16) through the split kernel
   (both other routes refusing each; the parts, groups, form and instance
   logged), and a resize of a crop that overhangs
   its frame (``overhang_cases``: past the right and the bottom edge and
   from a negative origin, one level, nested, a plane of a mixed batch, and
   K1's rects past the edges) at full width,
   max |diff| 0, and C1 on uint16, float16
   and float64 sources and on a float32 frame of ``EDGES32`` with a chain
   that flushes, as int32 bits, one launch each. Warp maps whose inverse
   holds -1e-39 at c01 or c10, with an infinite border channel, through
   the warp kernel and the composed kernel's warp core: each equal to its
   plain version as int32 bits (the host's terms keep the subnormal).
   uint8 must match bit for bit, float32 within 1e-6, warp float32 bit for
   bit too, every other dtype bit for bit;
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
   D1S (D1's pair of sequences over a ring of 8 planes of 1920x1080x3
   uint16, a 16-bit camera's last frames: 99.5 MB read, 199 MB of float32
   written) twice under AUTO and twice under ``ParBackend.CUDA``, one launch
   of ``cuda:divergent`` each and no plan for a new ``first``, and D1, D3
   and D4 of each source dtype of K6's general instance twice each (a new
   ``first``, shifted rects, new matrices), each the eager merge bit for bit;
   every dtype on the main paths, twice each with new values, one launch
   and no plan on the second, equal to the eager version bit for bit: the
   flagship on a 12-bit uint16 frame into float16 planes, frame (a) into
   float16, W6 into float16, D1 into an int16 batch, and 40 updates of a
   uint16 ``CircularTensor`` with uint8 frames, one launch each and no
   temporary; int32 at full width the same way: the flagship on a 4K int32
   frame (a 32-bit label or depth map) into float32 planes, frame (a) on a
   1080p int32 image, W6 into int32 planes, D1 into an int32 batch, a 1080p
   int32 image through a crop and a border (the crop unchanged, bit for
   bit), and 40 updates of an int32 ``CircularTensor`` of int32 frames;
   64-bit values the same way: the flagship on a 4K float64 frame, frame (a)
   on a 1080p int64 image, W6 on a float64 frame, D1 on a float64 ring, a
   float64 1080p image through a crop and a border (the source rounded to
   float32, bit for bit), each a tensor on the card read at load; and an
   int64 and a float64 1080p frame on the card and a float64 host frame, one
   launch of the pointwise kernel each, equal to its plain version bit for
   bit, while ``convert_to(np.int64)`` raises as the reference's call does;
   C1-C8 twice each (new crop origins, a new matrix, a new border value),
   ``cuda:composed`` in one launch per call and no plan on the second, bit
   for bit the eager version on the card; B1-B7 the same way, the second
   call with new camera frames, origins, angles, border value and
   ``used_planes``, and B1 against an independent float64 resize of each
   camera (``oracle_frame``); M1-M5 the same way (new frames of the same
   sizes, origins, angles, border value and ``used_planes``: no plan), M1
   against a float64 resize of each camera; N1-N6 the same way (new maps, crop origin,
   border value, ``used_planes`` and N6's camera frames); NM1-NM4 the same
   way (new frames of the same sizes, maps, origins, angles, border value
   and ``used_planes``: no plan); DV1-DV4 twice each through
   ``launch_divergent_batch`` (new camera and sensor frames of the same
   sizes, origins, angles, border value and ``used_planes``),
   ``cuda:composed:divergent`` also under ``ParBackend.CUDA``, one launch
   of the composed kernel per call and none of the divergent kernel, no plan
   on the second, bit for bit the eager merge on the card; DVN1-DVN4 the same
   way (new camera, NV12 and sensor frames); DK1-DK4 the same way (new
   cameras, NV12 and sensor frames, a new ring and stack, new ``first``,
   rects, matrices, origins and border value), ``cuda:divergent:split``, one
   launch of the split kernel per call and none of the other two;
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
   in D1-D4, D1S and D1, D3 and D4 on each source dtype of its general
   instance (the instance named from the profiler's trace) beside the eager
   merge, the host-inclusive ``launch_divergent_batch`` call of D4 and
   one ``CircularTensor.update``, before (a temporary, a cast and a
   ``copy_``, as updates ran until the wrappers took ``out=``) and after;
   the pointwise kernel in P1-P5 (P1's bound is its operations at the
   unfused rate, half the published one: the build forbids FMAs); the call of
   an int64 frame through the pointwise kernel beside the uint8 frame's; the
   dtype, int32 and 64-bit paths of phase 4, each beside its bound and floor
   (a 64-bit source's bytes at 8 an element); the composed kernel in C1-C8
   and B1-B7 beside the eager path it replaces (``ParBackend.TORCH``: its device time
   by events and by ``torch.profiler``, its kernels and copies per call)
   and, for C1, C2, C4 and B1, one library call of the resample alone on a
   float32 NCHW copy of what the core reads (``F.interpolate``;
   ``F.affine_grid`` + ``F.grid_sample``), and for B1 K1 on the same
   cameras (``resize_batch``'s padded stack: the kernel alone, and the
   call with the stack's copies); M1-M5 the same way, and for M1 eight
   ``F.interpolate`` calls, one a camera, as a reference; N1-N6 the same way, and for N3 two
   chained ``F.interpolate`` calls on the float32 4K frame as a reference;
   NM1-NM4 the same way, and what a plane's head in shared memory costs
   the nested instances: N2, N3 (a one-plane batch) and N6 by value and
   through the mixed nested instances, each plane given its head, bit-equal;
   DV1-DV4 the same way beside the eager merge (``ParBackend.TORCH``) and,
   as a reference, each group's own composed launch over its planes,
   summed, with the instance each launch ran as the profiler names it;
   DVN1-DVN4 the same way, the profiler's instance the one
   ``divergent_instance`` predicts; DV1 by its one-level launch beside
   DV1 through the nested instances (each way of the lift), in turns;
   DK1-DK4 the same way beside the eager merge and, as a reference, each
   part's own launches over its groups' planes summed (the divergent
   kernel over each of its groups cut to its planes, ``own_k6_sequence``;
   the composed kernel over each of the others), the profiler's instance
   the one ``cuda_divergent_split.instance`` predicts;
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

import copy
import dataclasses
import json
import os
import re
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

    def cast(self, fn):
        """These rows with every image source (the ring, the frame, the
        warped images and the flat planes) mapped through ``fn``, which
        takes a uint8 tensor; the NV12 cameras stay uint8."""
        import torch

        other = copy.copy(self)
        other.ring, other.frame = fn(self.ring), fn(self.frame)
        other.imgs = [fn(im) for im in self.imgs]
        other.flat = fn(self.flat.to(torch.uint8))
        return other

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


#: C1's and C4's region of the 4K frame, and C6's crops of 1080p (one off the
#: frame's right edge, one left of it: dynamic_slice clamps both)
ROI = (960, 540, 1920, 1080)
C6_SIDE = 224
C6_ORIGINS = [(k * (FRAME_W - C6_SIDE) // 15, (k * 53) % (FRAME_H - C6_SIDE)) for k in range(16)]
C6_ORIGINS[3], C6_ORIGINS[9] = (FRAME_W - 100, 40), (-30, 500)


def composed_cases(cvgs, frame, hd, nv12, values=0) -> dict:
    """The composed-read kernel's cases C1-C8 at full width, which phases 3
    to 5 drive; ``values`` 1 moves every runtime value (crop origins, the
    warp's angle, the letterbox's border value) and keeps the structure.
    C1 a 1920x1080 region of interest of the 4K frame resized to 640x360
    and normalized; C2 "ComputeWhatYouSee", a fused BGR -> RGB and x1/255
    under the resize of 1080p; C3 a 640x640 letterbox of 1080p (resize, then
    a CONSTANT border of 114); C4 C1's region rotated 10 degrees about its
    centre into 1920x1080; C5 an 8-pixel REFLECT_101 border of 1080p
    resized; C6 16 crops of 224x224 of 1080p; C7 a 1280x720 crop of 1080p
    fused with RGB -> gray; C8 the 6K NV12 buffer converted into uint8 RGB
    per tap and resized to 1080p."""
    normalize = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                 cvgs.divide(STD))
    x, y, w, h = ROI
    roi = cvgs.Rect(x + 4 * values, y - 4 * values, w, h)
    dst = cvgs.Size(*FRAME_DST)
    origins = [(ox + values, oy) for ox, oy in C6_ORIGINS]
    return {
        "c1_roi_crop_resize": (cvgs.resize(cvgs.crop(cvgs.image(frame), roi), dst), *normalize,
                               cvgs.split_tensor()),
        "c2_compute_what_you_see": (
            cvgs.resize(cvgs.fuse(cvgs.image(hd), cvgs.vector_reorder(2, 1, 0),
                                  cvgs.convert_to(np.float32, alpha=1 / 255.0)), dst),
            cvgs.split_tensor()),
        "c3_letterbox_640x640": (
            cvgs.make_border(cvgs.resize(cvgs.image(hd), dst), 140, 140, 0, 0,
                             cvgs.BorderMode.CONSTANT, 114 - 14 * values),
            cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.split_tensor()),
        "c4_warp_of_a_crop": (
            cvgs.warp(cvgs.crop(cvgs.image(frame), roi), rotation((w / 2, h / 2), 10.0 + 5 * values,
                                                                  1.0), cvgs.Size(w, h)),
            *normalize, cvgs.split_tensor()),
        "c5_border_then_resize": (
            cvgs.resize(cvgs.make_border(cvgs.image(hd), BORDER, BORDER, BORDER, BORDER,
                                         cvgs.BorderMode.REFLECT_101), dst),
            *normalize, cvgs.split_tensor()),
        "c6_crop_batch_16x224": (
            cvgs.crop_batch(hd, [cvgs.Rect(ox, oy, C6_SIDE, C6_SIDE) for ox, oy in origins]),
            *normalize, cvgs.split_tensor()),
        "c7_crop_of_fused_gray": (
            cvgs.crop(cvgs.fuse(cvgs.image(hd),
                                cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_RGB2GRAY)),
                      cvgs.Rect(320 + values, 180, 1280, 720)),
            cvgs.convert_to(np.float32), cvgs.write()),
        "c8_nv12_6k_to_u8_resize": (
            cvgs.resize(cvgs.fuse(cvgs.read_yuv(nv12),
                                  cvgs.convert_yuv_to_rgb(out_dtype=np.uint8)),
                        cvgs.Size(FRAME_W, FRAME_H)),
            cvgs.split_tensor()),
    }


#: B1-B7's cameras (1080p), B3's regions of interest and B5's crops of them,
#: B6's crops of the 4K frame
CAMERAS = 8
B3_ROI, B3_DST = (800, 600), 224
B5_CROP = (960, 540)
B6_PLANES, B6_USED, B6_SIDE = 50, 37, 224


def batch_cases(cvgs, cams, frame, values=0) -> dict:
    """The composed kernel's batches B1-B7 at full width (``batch_read`` of
    per-plane read trees of one structure), which phases 3 to 5 drive;
    ``values`` 1 moves every runtime value (origins, angles, the border
    value, ``used_planes``) and keeps the structure. B1 the eight 1080p
    cameras each resized to 640x360 and normalized, planar; B2 B1 with
    ``used_planes`` 5 (6), default 0; B3 an 800x600 region of interest of
    each camera at its own origin resized to 224x224 and normalized; B4 eight
    640x640 letterboxes (640x360 inside a CONSTANT border of 114); B5 a
    960x540 crop of each camera rotated by 5-40 degrees about its centre
    into 640x360 (scale 2/3); B6 50 crops of 224x224 of the 4K frame, 37
    (40) used, default 0; B7 the bare cameras stacked as float32."""
    normalize = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                 cvgs.divide(STD))
    dst = cvgs.Size(*FRAME_DST)
    n = len(cams)
    rw, rh = B3_ROI
    rois = [((k * 157 + 13 * values) % (FRAME_W - rw), (k * 61 + 7 * values) % (FRAME_H - rh))
            for k in range(n)]
    cw, ch = B5_CROP
    crops = [((k * 113 + 5 * values) % (FRAME_W - cw), (k * 67) % (FRAME_H - ch)) for k in range(n)]
    angles = [5.0 + 35.0 * k / (n - 1) + 2.0 * values for k in range(n)]
    tiles = [((k * 397 + values) % (SRC_W - B6_SIDE), (k * 211) % (SRC_H - B6_SIDE))
             for k in range(B6_PLANES)]
    tiles[3], tiles[9] = (SRC_W - 100, 40), (-30, 500)  # clamped, as dynamic_slice does
    resized = [cvgs.resize(cvgs.image(c), dst) for c in cams]
    return {
        "b1_cameras_resized": (cvgs.batch_read(resized), *normalize, cvgs.split_tensor()),
        "b2_cameras_resized_ragged": (
            cvgs.batch_read(resized, used_planes=5 + values, default=0.0), *normalize,
            cvgs.split_tensor()),
        "b3_rois_resized": (
            cvgs.batch_read([cvgs.resize(cvgs.crop(cvgs.image(c), cvgs.Rect(x, y, rw, rh)),
                                         cvgs.Size(B3_DST, B3_DST))
                             for c, (x, y) in zip(cams, rois)]),
            *normalize, cvgs.split_tensor()),
        "b4_letterboxes_640x640": (
            cvgs.batch_read([cvgs.make_border(cvgs.resize(cvgs.image(c), dst), 140, 140, 0, 0,
                                              cvgs.BorderMode.CONSTANT, 114 - 14 * values)
                             for c in cams]),
            cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.split_tensor()),
        "b5_warps_of_crops": (
            cvgs.batch_read([cvgs.warp(cvgs.crop(cvgs.image(c), cvgs.Rect(x, y, cw, ch)),
                                       rotation((cw / 2, ch / 2), a, 2 / 3, to=(dst.width / 2,
                                                                                dst.height / 2)),
                                       dst)
                             for c, (x, y), a in zip(cams, crops, angles)]),
            *normalize, cvgs.split_tensor()),
        "b6_crops_of_4k_ragged": (
            cvgs.batch_read([cvgs.crop(cvgs.image(frame), cvgs.Rect(x, y, B6_SIDE, B6_SIDE))
                             for x, y in tiles], used_planes=B6_USED + 3 * values, default=0.0),
            *normalize, cvgs.split_tensor()),
        "b7_bare_cameras": (cvgs.batch_read([cvgs.image(c) for c in cams]),
                            cvgs.convert_to(np.float32), cvgs.write_tensor()),
    }


#: M1-M5's cameras (h, w), uint8 RGB: two 4K, three 1080p, three 720p
M_CAMERAS = ((2160, 3840),) * 2 + ((1080, 1920),) * 3 + ((720, 1280),) * 3
M2_USED = 6
#: M3's regions of interest of the 4K frame (w, h), each letterboxed into a
#: square of M3_SIDE
M3_ROIS = ((1200, 800), (800, 1200), (640, 480), (1920, 1080), (500, 500), (300, 900),
           (1600, 600), (960, 960))
M3_SIDE = 640
#: M4's crop (w, h) of each of M_CAMERAS, 640x480 to 1280x960
M4_CROPS = ((1280, 960), (1024, 768), (1280, 960), (1120, 840), (880, 660), (960, 720),
            (800, 600), (640, 480))
#: M5's NV12 buffers' images (h, w)
M5_NV12 = ((1080, 1920),) * 2 + ((720, 1280),) * 2


def letterbox(w: int, h: int, side: int):
    """``(inner (w, h), (top, bottom, left, right))`` of a ``w`` x ``h``
    region resized into a ``side`` x ``side`` square, aspect kept, centred."""
    scale = side / max(w, h)
    iw, ih = max(1, round(w * scale)), max(1, round(h * scale))
    top, left = (side - ih) // 2, (side - iw) // 2
    return (iw, ih), (top, side - ih - top, left, side - iw - left)


def mixed_cases(cvgs, cams, frame, nv12s, values=0) -> dict:
    """The composed kernel's batches whose planes share one shape but not
    one geometry, M1-M5, at full width, which phases 3 to 5 drive; ``cams``
    are the cameras of ``M_CAMERAS``, ``nv12s`` the buffers of ``M5_NV12``;
    ``values`` 1 moves every runtime value (``used_planes``, origins,
    angles, the border value) and keeps every size. M1 the eight cameras
    each resized to 640x360 and normalized, planar; M2 M1 with
    ``used_planes`` 6 (5), default 0; M3 eight regions of interest of the 4K
    frame of eight sizes and aspects (``M3_ROIS``), each letterboxed into
    640x640 (aspect kept, CONSTANT 114), x1/255, planar; M4 a crop of
    640x480 to 1280x960 of each camera (``M4_CROPS``) rotated by 5-40
    degrees about its centre into 640x360, normalized, planar; M5 the NV12
    buffers converted into uint8 RGB per tap (C8's tree) and resized to
    640x360."""
    normalize = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                 cvgs.divide(STD))
    dst = cvgs.Size(*FRAME_DST)
    resized = [cvgs.resize(cvgs.image(c), dst) for c in cams]
    boxes = []
    for k, (rw, rh) in enumerate(M3_ROIS):
        (iw, ih), (t, b, l, r) = letterbox(rw, rh, M3_SIDE)
        x, y = (k * 331 + 9 * values) % (SRC_W - rw), (k * 173 + 5 * values) % (SRC_H - rh)
        boxes.append(cvgs.make_border(
            cvgs.resize(cvgs.crop(cvgs.image(frame), cvgs.Rect(x, y, rw, rh)), cvgs.Size(iw, ih)),
            t, b, l, r, cvgs.BorderMode.CONSTANT, 114 - 14 * values))
    warps = []
    for k, (c, (cw, ch)) in enumerate(zip(cams, M4_CROPS)):
        h, w = c.shape[:2]
        x, y = (k * 97 + 5 * values) % (w - cw + 1), (k * 41) % (h - ch + 1)
        angle = 5.0 + 35.0 * k / (len(cams) - 1) + 2.0 * values
        scale = min(dst.width / cw, dst.height / ch)
        warps.append(cvgs.warp(cvgs.crop(cvgs.image(c), cvgs.Rect(x, y, cw, ch)),
                               rotation((cw / 2, ch / 2), angle, scale,
                                        to=(dst.width / 2, dst.height / 2)), dst))
    return {
        "m1_cameras_of_3_sizes_resized": (cvgs.batch_read(resized), *normalize,
                                          cvgs.split_tensor()),
        "m2_cameras_of_3_sizes_ragged": (
            cvgs.batch_read(resized, used_planes=M2_USED - values, default=0.0), *normalize,
            cvgs.split_tensor()),
        "m3_rois_letterboxed_640x640": (
            cvgs.batch_read(boxes), cvgs.convert_to(np.float32, alpha=1 / 255.0),
            cvgs.split_tensor()),
        "m4_rotated_crops_of_8_sizes": (cvgs.batch_read(warps), *normalize, cvgs.split_tensor()),
        "m5_nv12_cameras_of_2_sizes": (
            cvgs.batch_read([cvgs.resize(cvgs.fuse(cvgs.read_yuv(b), cvgs.convert_yuv_to_rgb(
                out_dtype=np.uint8)), dst) for b in nv12s]),
            cvgs.split_tensor()),
    }


#: N6's planes (the B-cases' cameras) and the planes it uses
N6_PLANES, N6_USED = 8, 6
N4_CROP, N4_DST = (480, 270, 960, 540), 224


def top_view(w: int, h: int, k: int = 0) -> np.ndarray:
    """A homography of a road camera's ``w`` x ``h`` frame to a top view of
    the same size: the trapezoid the road fills widened into a rectangle;
    ``k`` tilts it a little (a camera of its own)."""
    unit = np.array([[1.0, -0.25 - 0.02 * k, 0.125 + 0.01 * k], [0.0, 0.7, 0.1 + 0.005 * k],
                     [0.0, -0.4 + 0.01 * k, 1.0]])
    return np.diag([w, h, 1.0]) @ unit @ np.diag([1.0 / w, 1.0 / h, 1.0])


def nested_cases(cvgs, frame, hd, cams, values=0) -> dict:
    """The composed kernel's nested cases N1-N6 at full width (a second
    resampling node, or a fused read above the core), which phases 3 to 5
    drive; ``values`` 1 moves every runtime value (the maps, the crop's
    origin, the border value, ``used_planes``) and keeps the structure. N1
    the 1080p frame to a top view (a perspective warp into 1920x1080,
    CONSTANT 0) resized to 640x360 and normalized; N2 the 4K frame resized
    to 1280x720 and rotated 10 degrees about its centre; N3 the 4K frame
    resized to 1920x1080, then to 640x360 (a two-level downscale); N4 a
    960x540 crop at (480, 270) of that 1920x1080 resized to 224x224; N5 a
    640x640 letterbox of the 1080p frame resized to 640x360 and fused with
    x1/255, its CONSTANT border 0.447 already normalized, no chain; N6 N1
    of each of the eight cameras (its own homography), ``used_planes`` 6
    (5), default 0. All planar float32."""
    normalize = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                 cvgs.divide(STD))
    full, dst = cvgs.Size(FRAME_W, FRAME_H), cvgs.Size(*FRAME_DST)
    persp = dict(warp_type=cvgs.WarpType.PERSPECTIVE, default=0.0)
    mid = cvgs.Size(1280, 720)
    x, y, w, h = N4_CROP
    pad = (FRAME_DST[0] - FRAME_DST[1]) // 2
    return {
        "n1_top_view_resized": (
            cvgs.resize(cvgs.warp(cvgs.image(hd), top_view(FRAME_W, FRAME_H, values), full,
                                  **persp), dst),
            *normalize, cvgs.split_tensor()),
        "n2_resize_then_rotate": (
            cvgs.warp(cvgs.resize(cvgs.image(frame), mid),
                      rotation((mid.width / 2, mid.height / 2), 10.0 + 5 * values, 1.0), mid),
            *normalize, cvgs.split_tensor()),
        "n3_two_level_downscale": (
            cvgs.resize(cvgs.resize(cvgs.image(frame), full), dst), *normalize,
            cvgs.split_tensor()),
        "n4_crop_of_a_downscale_resized": (
            cvgs.resize(cvgs.crop(cvgs.resize(cvgs.image(frame), full),
                                  cvgs.Rect(x + 4 * values, y - 4 * values, w, h)),
                        cvgs.Size(N4_DST, N4_DST)),
            *normalize, cvgs.split_tensor()),
        "n5_letterbox_of_a_normalized_resize": (
            cvgs.make_border(cvgs.fuse(cvgs.resize(cvgs.image(hd), dst),
                                       cvgs.convert_to(np.float32, alpha=1 / 255.0)),
                             pad, pad, 0, 0, cvgs.BorderMode.CONSTANT, 0.447 - 0.1 * values),
            cvgs.split_tensor()),
        "n6_top_views_of_8_cameras_ragged": (
            cvgs.batch_read([cvgs.resize(cvgs.warp(cvgs.image(c), top_view(FRAME_W, FRAME_H,
                                                                          k + values),
                                                   full, **persp), dst)
                             for k, c in enumerate(cams[:N6_PLANES])],
                            used_planes=N6_USED - values, default=0.0),
            *normalize, cvgs.split_tensor()),
    }


#: NM4's middle image and its crops (w, h) of each camera, 120x90 to 640x480
NM4_MID, NM4_DST = (960, 540), 224
NM4_CROPS = ((120, 90), (160, 120), (224, 168), (320, 240), (400, 300), (480, 360), (560, 420),
             (640, 480))


def nested_mixed_cases(cvgs, cams, frame, values=0) -> dict:
    """The composed kernel's batches of nested planes that share one shape
    but not one geometry, NM1-NM4, at full width, which phases 3 to 5
    drive; ``cams`` are the cameras of ``M_CAMERAS``; ``values`` 1 moves
    every runtime value (the maps, origins, angles, the border value,
    ``used_planes``) and keeps every size. NM1 N6's tree over the cameras:
    each warped to its own top view at its own size (perspective, CONSTANT
    0), then resized to 640x360, ``used_planes`` 6 (5), default 0; NM2 N5's
    tree at M3's geometry: each of ``M3_ROIS`` of the 4K frame resized into
    its letterbox's inner size, fused with x1/255 and bordered (CONSTANT
    0.447) into 640x640, no chain; NM3 each camera resized to half its size,
    then rotated by 5-40 degrees about its centre into 640x360 at the scale
    that fits; NM4 each camera resized to 960x540, then a crop of one of
    ``NM4_CROPS`` resized to 224x224 (the crops under 224 upscaled: their
    tiles share taps). Planar float32, normalized but NM2; every region
    inside its frame."""
    normalize = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                 cvgs.divide(STD))
    dst = cvgs.Size(*FRAME_DST)
    persp = dict(warp_type=cvgs.WarpType.PERSPECTIVE, default=0.0)
    top_views, rotated, rois, boxes = [], [], [], []
    for k, c in enumerate(cams):
        h, w = c.shape[:2]
        top_views.append(cvgs.resize(cvgs.warp(cvgs.image(c), top_view(w, h, k + values),
                                               cvgs.Size(w, h), **persp), dst))
        half = cvgs.Size(w // 2, h // 2)
        scale = min(dst.width / half.width, dst.height / half.height)
        angle = 5.0 + 35.0 * k / (len(cams) - 1) + 2.0 * values
        rotated.append(cvgs.warp(cvgs.resize(cvgs.image(c), half),
                                 rotation((half.width / 2, half.height / 2), angle, scale,
                                          to=(dst.width / 2, dst.height / 2)), dst))
        (mw, mh), (cw, ch) = NM4_MID, NM4_CROPS[k]
        x, y = (k * 53 + 7 * values) % (mw - cw), (k * 29 + 3 * values) % (mh - ch)
        rois.append(cvgs.resize(cvgs.crop(cvgs.resize(cvgs.image(c), cvgs.Size(mw, mh)),
                                          cvgs.Rect(x, y, cw, ch)),
                                cvgs.Size(NM4_DST, NM4_DST)))
    for k, (rw, rh) in enumerate(M3_ROIS):
        (iw, ih), (t, b, l, r) = letterbox(rw, rh, M3_SIDE)
        x, y = (k * 331 + 9 * values) % (SRC_W - rw), (k * 173 + 5 * values) % (SRC_H - rh)
        boxes.append(cvgs.make_border(
            cvgs.fuse(cvgs.resize(cvgs.crop(cvgs.image(frame), cvgs.Rect(x, y, rw, rh)),
                                  cvgs.Size(iw, ih)),
                      cvgs.convert_to(np.float32, alpha=1 / 255.0)),
            t, b, l, r, cvgs.BorderMode.CONSTANT, 0.447 - 0.1 * values))
    return {
        "nm1_top_views_of_cameras_of_3_sizes_ragged": (
            cvgs.batch_read(top_views, used_planes=N6_USED - values, default=0.0), *normalize,
            cvgs.split_tensor()),
        "nm2_normalized_letterboxes_of_8_rois": (cvgs.batch_read(boxes), cvgs.split_tensor()),
        "nm3_half_size_resize_then_rotate": (cvgs.batch_read(rotated), *normalize,
                                             cvgs.split_tensor()),
        "nm4_roi_crops_of_a_downscale_to_224": (cvgs.batch_read(rois), *normalize,
                                                cvgs.split_tensor()),
    }


def overhang_cases(cvgs, frame, hd, other) -> dict:
    """A resize of a crop that overhangs its frame at full width: a 1280x720
    crop of the 4K frame past its right edge, past its bottom edge and from
    x = -200 (from the far edge, then clamped, as ``dynamic_slice``),
    resized to 640x360, one level; the same crops of the 1080p frame
    resized to the 4K frame's size first (nested); the right edge's as a
    plane of a ``batch_read`` beside a crop of another size; and K1's rects
    past the 4K frame's edges (``resize_batch``). Planar float32."""
    dst = cvgs.Size(*FRAME_DST)
    rects = {"right": (3000, 100, 1280, 720), "bottom": (500, 1900, 1280, 720),
             "negative": (-200, 300, 1280, 720)}
    cases = {}
    for edge, r in rects.items():
        rect = cvgs.Rect(*r)
        cases[f"overhang_{edge}_one_level"] = (cvgs.resize(cvgs.crop(cvgs.image(frame), rect),
                                                           dst), cvgs.split_tensor())
        cases[f"overhang_{edge}_nested"] = (
            cvgs.resize(cvgs.crop(cvgs.resize(cvgs.image(hd), cvgs.Size(SRC_W, SRC_H)), rect),
                        dst), cvgs.split_tensor())
    cases["overhang_right_mixed_plane"] = (
        cvgs.batch_read([cvgs.resize(cvgs.crop(cvgs.image(frame), cvgs.Rect(*rects["right"])),
                                     dst),
                         cvgs.resize(cvgs.crop(cvgs.image(other), cvgs.Rect(10, 20, 900, 500)),
                                     dst)]),
        cvgs.split_tensor())
    cases["overhang_k1_rects"] = (
        cvgs.resize_batch(frame, rects=np.array(list(rects.values()), np.int32), dsize=dst),
        cvgs.split_tensor())
    return cases


def budget_nested_cases(cvgs, frame) -> dict:
    """Two nested cases at full width beside N1-N6, one for each end of the
    nested instances' staging (``csrc/composed_nested.cuh``): the 4K frame
    resized to 1920x1080 and warped at a quarter of its scale, rotated 10
    degrees into 480x270 (a 16x16 block's taps span about 74 columns and
    rows of the middle image, past the budget: its blocks evaluate the core
    per tap), and the 4K frame resized to 640x360, then up to 1920x1080 (a
    block's 16x16 outputs share 8 or 9 columns and rows). Planar float32."""
    normalize = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                 cvgs.divide(STD))
    full = cvgs.Size(FRAME_W, FRAME_H)
    m = rotation((FRAME_W / 2, FRAME_H / 2), 10.0, 0.25, to=(240, 135))
    return {
        "n7_quarter_scale_warp_of_a_resize": (
            cvgs.warp(cvgs.resize(cvgs.image(frame), full), m, cvgs.Size(480, 270)),
            *normalize, cvgs.split_tensor()),
        "n8_upscale_of_a_downscale": (
            cvgs.resize(cvgs.resize(cvgs.image(frame), cvgs.Size(*FRAME_DST)), full),
            *normalize, cvgs.split_tensor()),
    }


#: DV's 4:3 cameras (h, w), the 12-bit sensor frame (h, w) and the sides of
#: DV1-DV4's output planes
DV_CAMERA, DV_SENSOR = (960, 1280), (2048, 2448)
DV_SIDES = {"dv1": 640, "dv2": 224, "dv3": 320, "dv4": 256}


def dv_rois(h: int, w: int, values: int):
    """Sixteen regions ``(x, y, w, h)`` of an ``h`` x ``w`` frame, sides of
    200 to 900 pixels (scaled to the frame's height against 2160), each its
    own size and aspect (3:4 and 4:3 in turn); ``values`` 1 moves their
    origins."""
    out = []
    for k in range(16):
        s = round((200 + 700 * k / 15) * h / 2160)
        rw, rh = (s, s * 3 // 4) if k % 2 else (s * 3 // 4, s)
        out.append(((k * 331 + 9 * values) % (w - rw + 1), (k * 173 + 5 * values) % (h - rh + 1),
                    rw, rh))
    return out


def divergent_composed_cases(cvgs, cams, cams43, frame, sensor, values=0) -> dict:
    """The divergent batches that the composed kernel takes in one launch,
    DV1-DV4, at full width: ``name -> (plane ids, (op list of each
    sequence))``; ``cams`` the eight 1080p cameras, ``cams43`` eight 4:3
    cameras of ``DV_CAMERA``, ``frame`` the 4K frame, ``sensor`` a 3-channel
    12-bit uint16 frame of ``DV_SENSOR``. ``values`` 1 moves every runtime
    value (origins, angles, the border value, ``used_planes``) and keeps
    every size. DV1 a surround-view detector input: letterboxes of the 1080p
    cameras (resized to 640x360, CONSTANT 114 140 rows above and below)
    beside affine warps of the 4:3 cameras to 640x640 (rotations of 5-15
    degrees at a scale of 0.6, the camera's centre on the output's), ids
    [1, 1, 2, 2] * 2, normalized, planar; DV2 classifier crops from two
    sensors: regions of interest of 200-900 pixels of the 4K frame resized
    to 224x224, x1/255, beside regions of the sensor frame, x1/4095, ids
    [1, 2] * 8, planar; DV3 per-group store casts and a ragged group: the
    letterboxes into 320x320 under convert_to(uint8, 0.5, 3.0) beside warps
    of 960x720 crops of the 4:3 cameras to 320x320, x0.9, +3.25 in float32,
    ragged at used_planes 3 with a default of 300.7, into a packed uint8
    batch, ids [1, 2] * 4; DV4 one-pixel groups: crop_batch of 256x256
    regions of the 4K frame beside make_border(crop) of 224x224 regions, 16
    pixels each way in REFLECT_101, x1/255, planar, ids [1, 2] * 4."""
    normalize = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                 cvgs.divide(STD))

    def boxes(side):
        (iw, ih), (t, b, l, r) = letterbox(FRAME_W, FRAME_H, side)
        return cvgs.batch_read([cvgs.make_border(
            cvgs.resize(cvgs.image(c), cvgs.Size(iw, ih)), t, b, l, r,
            cvgs.BorderMode.CONSTANT, 114 - 14 * values) for c in cams])

    def warps(side, crop=None):
        h, w = DV_CAMERA
        out = []
        for k, c in enumerate(cams43):
            src, cw, ch = cvgs.image(c), w, h
            if crop:
                cw, ch = crop
                src = cvgs.crop(src, cvgs.Rect((37 * k + 5 * values) % (w - cw + 1),
                                               (23 * k) % (h - ch + 1), cw, ch))
            angle = 5.0 + 10.0 * k / 7 + 2.0 * values
            out.append(cvgs.warp(src, rotation((cw / 2, ch / 2), angle, 0.6 * side / cw * 2,
                                               to=(side / 2, side / 2)), cvgs.Size(side, side)))
        return out

    def rois(src, side):
        h, w = src.shape[:2]
        return cvgs.batch_read([cvgs.resize(cvgs.crop(cvgs.image(src), cvgs.Rect(x, y, rw, rh)),
                                            cvgs.Size(side, side))
                                for x, y, rw, rh in dv_rois(h, w, values)])

    s1, s2, s3, s4 = (DV_SIDES[k] for k in ("dv1", "dv2", "dv3", "dv4"))
    inner = s4 - 32
    tiles = [((k * 461 + 7 * values) % (SRC_W - s4), (k * 263 + 3 * values) % (SRC_H - s4))
             for k in range(8)]
    bordered = [((k * 379 + 5 * values) % (SRC_W - inner), (k * 211 + values) % (SRC_H - inner))
                for k in range(8)]
    return {
        "dv1_surround_view_letterboxes_and_warps": ([1, 1, 2, 2] * 2, (
            (boxes(s1), *normalize, cvgs.split_tensor()),
            (cvgs.batch_read(warps(s1)), *normalize, cvgs.split_tensor()))),
        "dv2_classifier_crops_from_two_sensors": ([1, 2] * 8, (
            (rois(frame, s2), cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.split_tensor()),
            (rois(sensor, s2), cvgs.convert_to(np.float32, alpha=1 / 4095.0),
             cvgs.split_tensor()))),
        "dv3_store_casts_and_a_ragged_group": ([1, 2] * 4, (
            (boxes(s3), cvgs.convert_to(np.uint8, alpha=0.5, beta=3.0), cvgs.write_tensor()),
            (cvgs.batch_read(warps(s3, (960, 720)), used_planes=3 - values, default=300.7),
             cvgs.multiply(0.9), cvgs.add(3.25), cvgs.write_tensor()))),
        "dv4_one_pixel_groups": ([1, 2] * 4, (
            (cvgs.crop_batch(cvgs.image(frame), [cvgs.Rect(x, y, s4, s4) for x, y in tiles]),
             cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.split_tensor()),
            (cvgs.batch_read([cvgs.make_border(cvgs.crop(cvgs.image(frame),
                                                         cvgs.Rect(x, y, inner, inner)),
                                               16, 16, 16, 16, cvgs.BorderMode.REFLECT_101)
                              for x, y in bordered]),
             cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.split_tensor()))),
    }


#: DVN3's sensor frame resized (w, h) before its regions are cut
DVN3_SENSOR_HALF = (1224, 1024)


def divergent_nested_cases(cvgs, cams, nv12s, sensor, values=0, chain=True) -> dict:
    """The divergent batches with a nested group that the composed kernel's
    nested instances take in one launch, DVN1-DVN4, at full width: ``name
    -> (plane ids, (op list of each sequence))``; ``cams`` the eight 1080p
    cameras, ``nv12s`` eight 1080p NV12 buffers, ``sensor`` the 3-channel
    12-bit uint16 frame of ``DV_SENSOR``. ``values`` 1 moves every runtime
    value (the maps, angles, origins, the border values, ``used_planes``)
    and keeps every size; ``chain`` False drops the pipeline chains (the
    values as the reads give them). DVN1 the surround-view detector input:
    letterboxes of the cameras into 640x640 (DV1's: resized to 640x360,
    CONSTANT 114 140 rows above and below) beside top views of the others
    (a perspective warp into 1920x1080, CONSTANT 0, resized to 640x640),
    ids [1, 1, 2, 2] * 2, normalized, planar; DVN2 N6's top views resized to
    640x360 (per tap), ``used_planes`` 6 (5), default 0, beside each camera
    resized to 960x540, then rotated 5-15 degrees about its centre at scale
    2/3 into 640x360 (staged), ids [1, 2] * 4, normalized, planar; DVN3
    N5's letterboxes (a resize to 640x360 fused with x1/255, CONSTANT 0.447
    140 rows above and below, no chain: a FusedRead2 alone) beside eight of
    ``dv_rois`` (95 to 402 pixels) of the sensor frame resized to
    ``DVN3_SENSOR_HALF``, each resized to 640x640, x1/4095, ids [1, 2] * 4,
    planar: two source dtypes, the general nested instances; DVN4 DVN1's
    trees over the NV12 buffers converted into uint8 RGB per tap, ids
    [1, 2] * 4, one conversion. Every region inside its frame."""
    normalize = ((cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                  cvgs.divide(STD)) if chain else ())
    scale = (cvgs.convert_to(np.float32, alpha=1 / 4095.0),) if chain else ()
    full, dst = cvgs.Size(FRAME_W, FRAME_H), cvgs.Size(*FRAME_DST)
    side = DV_SIDES["dv1"]
    square = cvgs.Size(side, side)
    persp = dict(warp_type=cvgs.WarpType.PERSPECTIVE, default=0.0)
    (iw, ih), (t, b, l, r) = letterbox(FRAME_W, FRAME_H, side)

    def rgb(buf):
        return cvgs.fuse(cvgs.read_yuv(buf), cvgs.convert_yuv_to_rgb(out_dtype=np.uint8))

    def boxes(reads):
        return cvgs.batch_read([cvgs.make_border(cvgs.resize(src, cvgs.Size(iw, ih)), t, b, l, r,
                                                 cvgs.BorderMode.CONSTANT, 114 - 14 * values)
                                for src in reads])

    def top_views(reads, size, **ragged):
        return cvgs.batch_read([cvgs.resize(cvgs.warp(src, top_view(FRAME_W, FRAME_H, k + values),
                                                      full, **persp), size)
                                for k, src in enumerate(reads)], **ragged)

    mid = cvgs.Size(960, 540)
    rotated = [cvgs.warp(cvgs.resize(cvgs.image(c), mid),
                         rotation((mid.width / 2, mid.height / 2), 5.0 + 10.0 * k / 7 + 2 * values,
                                  2 / 3, to=(dst.width / 2, dst.height / 2)), dst)
               for k, c in enumerate(cams)]
    fused = [cvgs.make_border(cvgs.fuse(cvgs.resize(cvgs.image(c), cvgs.Size(iw, ih)),
                                        cvgs.convert_to(np.float32, alpha=1 / 255.0)),
                              t, b, l, r, cvgs.BorderMode.CONSTANT, 0.447 - 0.1 * values)
             for c in cams]
    hw, hh = DVN3_SENSOR_HALF
    rois = [cvgs.resize(cvgs.crop(cvgs.resize(cvgs.image(sensor), cvgs.Size(hw, hh)),
                                  cvgs.Rect(x, y, rw, rh)), square)
            for x, y, rw, rh in dv_rois(hh, hw, values)[::2]]
    images, buffers = [cvgs.image(c) for c in cams], [rgb(buf) for buf in nv12s]
    return {
        "dvn1_top_views_beside_letterboxes": ([1, 1, 2, 2] * 2, (
            (boxes(images), *normalize, cvgs.split_tensor()),
            (top_views(images, square), *normalize, cvgs.split_tensor()))),
        "dvn2_top_views_beside_rotated_downscales": ([1, 2] * 4, (
            (top_views(images, dst, used_planes=N6_USED - values, default=0.0), *normalize,
             cvgs.split_tensor()),
            (cvgs.batch_read(rotated), *normalize, cvgs.split_tensor()))),
        "dvn3_normalized_letterboxes_beside_a_12bit_sensor": ([1, 2] * 4, (
            (cvgs.batch_read(fused), cvgs.split_tensor()),
            (cvgs.batch_read(rois), *scale, cvgs.split_tensor()))),
        "dvn4_nv12_top_views_beside_nv12_letterboxes": ([1, 2] * 4, (
            (boxes(buffers), *normalize, cvgs.split_tensor()),
            (top_views(buffers, square), *normalize, cvgs.split_tensor()))),
    }


#: DK1's ring (planes, side) and DK3's stack (images, height, width)
SPLIT_RING, SPLIT_STACK = (8, 640), (16, 720, 1280)


def split_cases(cvgs, cams, ring, frame, stack, sensor, nv12s, values=0) -> dict:
    """The divergent batches that neither the divergent kernel nor the
    composed kernel's divergent plan takes alone and the split kernel runs
    in one launch, DK1-DK4, at full width: ``name -> (plane ids, (op list
    of each sequence))``; ``cams`` the eight 1080p cameras, ``ring`` a ring
    of ``SPLIT_RING`` uint8 planes, ``frame`` the 4K frame, ``stack``
    ``SPLIT_STACK`` uint8 images, ``sensor`` the 12-bit uint16 frame of
    ``DV_SENSOR``, ``nv12s`` eight 1080p NV12 buffers. ``values`` 1 moves
    every runtime value (``first``, rects, matrices, origins, the border
    value) and keeps every size. DK1 a tracker's ring beside fresh
    letterboxes: the ring read from ``first`` 3 (-5), normalized, beside
    DV1's letterboxes of the cameras into 640x640, normalized, planar, ids
    [1, 2] * 4; DK2 plain detector crops beside aligned faces:
    ``resize_batch`` of 64 rects of 80 to 400 pixels of the 4K frame to
    112x112 beside similarity warps of crops of the same regions to
    112x112 (rotations of -15 to 15 degrees), each group reading its 32
    planes, x1/255, -0.5, /0.5, planar, ids [1, 2] * 32; DK3 an image stack
    resized beside a 12-bit sensor's ROIs: ``resize_batch`` of the stack's
    16 720p images to 640x360, x1/255 (the group reading 8), beside DV2's
    regions of interest of the sensor frame resized to 640x360, x1/4095,
    planar, ids [1, 2] * 8; DK4 NV12 decoder cameras beside RGB top views:
    the NV12 buffers converted into float32 RGB and resized to 640x360 (the
    divergent kernel's NV12 kind), x1/255, -mean, /std, beside DVN1's top
    views of the cameras (a perspective warp into 1920x1080, CONSTANT 0)
    resized to 640x360 (a nested group), normalized, planar, ids [1, 2] *
    4."""
    normalize = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(MEAN),
                 cvgs.divide(STD))
    unit = (cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.subtract(0.5), cvgs.divide(0.5))
    side = DV_SIDES["dv1"]
    (iw, ih), (t, b, l, r) = letterbox(FRAME_W, FRAME_H, side)
    boxes = cvgs.batch_read([cvgs.make_border(
        cvgs.resize(cvgs.image(c), cvgs.Size(iw, ih)), t, b, l, r, cvgs.BorderMode.CONSTANT,
        114 - 14 * values) for c in cams])
    regions = []
    for k in range(64):
        s = 80 + (k * 37) % 321
        regions.append(((k * 523 + 11 * values) % (SRC_W - s), (k * 331 + 7 * values) % (SRC_H - s),
                        s, s))
    rects = np.asarray(regions, np.int32)
    faces = cvgs.batch_read([cvgs.warp(
        cvgs.crop(cvgs.image(frame), cvgs.Rect(x, y, s, s)),
        rotation((s / 2, s / 2), -15.0 + 30.0 * k / 63 + 2.0 * values, 112 / s, to=(56, 56)),
        cvgs.Size(112, 112)) for k, (x, y, s, _) in enumerate(regions)])
    dst = cvgs.Size(*FRAME_DST)
    h, w = sensor.shape[:2]
    rois = cvgs.batch_read([cvgs.resize(cvgs.crop(cvgs.image(sensor), cvgs.Rect(x, y, rw, rh)), dst)
                            for x, y, rw, rh in dv_rois(h, w, values)])
    nv12_rgb = cvgs.batch_read([cvgs.resize(cvgs.fuse(cvgs.read_yuv(buf), cvgs.convert_yuv_to_rgb(
        out_dtype=np.float32)), dst) for buf in nv12s])
    full = cvgs.Size(FRAME_W, FRAME_H)
    tops = cvgs.batch_read([cvgs.resize(cvgs.warp(cvgs.image(c), top_view(FRAME_W, FRAME_H,
                                                                         k + values),
                                                  full, warp_type=cvgs.WarpType.PERSPECTIVE,
                                                  default=0.0), dst)
                            for k, c in enumerate(cams)])
    return {
        "dk1_tracker_ring_beside_letterboxes": ([1, 2] * 4, (
            (cvgs.circular_batch_read(ring, first=3 - 8 * values), *normalize,
             cvgs.split_tensor()),
            (boxes, *normalize, cvgs.split_tensor()))),
        "dk2_detector_crops_beside_aligned_faces": ([1, 2] * 32, (
            (cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(112, 112)), *unit,
             cvgs.split_tensor()),
            (faces, *unit, cvgs.split_tensor()))),
        "dk3_stack_resized_beside_sensor_rois": ([1, 2] * 8, (
            (cvgs.resize_batch(list(stack), dsize=dst),
             cvgs.convert_to(np.float32, alpha=1 / 255.0), cvgs.split_tensor()),
            (rois, cvgs.convert_to(np.float32, alpha=1 / 4095.0), cvgs.split_tensor()))),
        "dk4_nv12_cameras_beside_rgb_top_views": ([1, 2] * 4, (
            (nv12_rgb, cvgs.multiply(1 / 255.0), cvgs.subtract(MEAN), cvgs.divide(STD),
             cvgs.split_tensor()),
            (tops, *normalize, cvgs.split_tensor()))),
    }


def split_form_cases(cvgs, torch, cams, ring, frame, values=0) -> dict:
    """The split kernel's other composed forms and output element types,
    which phase 3 holds against the plain version: ``ring``'s planes, no
    chain, beside ``crop_batch`` of 640x640 regions of the 4K frame under
    convert_to(float32, 0.5, 3.25) (one-pixel reads: a float32 part stored
    into the uint8 batch, packed); a 12-bit uint16 ring of 640x360 planes
    beside the cameras resized to 960x540 and rotated into 640x360 (a
    second resample staged), x16 (stored into the uint16 batch); a float16
    ring beside N5's letterboxes into 640x640 (a resize fused with x1/255,
    CONSTANT 0.447 above and below: a FusedRead2 alone; stored into the
    float16 batch); ids [1, 2] * 4."""
    side = SPLIT_RING[1]
    tiles = [cvgs.Rect((k * 461 + 7 * values) % (SRC_W - side), (k * 263 + values) % (SRC_H - side),
                       side, side) for k in range(8)]
    mid, dst = cvgs.Size(960, 540), cvgs.Size(*FRAME_DST)
    rotated = [cvgs.warp(cvgs.resize(cvgs.image(c), mid),
                         rotation((mid.width / 2, mid.height / 2), 5.0 + 10.0 * k / 7 + 2 * values,
                                  2 / 3, to=(dst.width / 2, dst.height / 2)), dst)
               for k, c in enumerate(cams)]
    (iw, ih), (t, b, l, r) = letterbox(FRAME_W, FRAME_H, side)
    fused = [cvgs.make_border(cvgs.fuse(cvgs.resize(cvgs.image(c), cvgs.Size(iw, ih)),
                                        cvgs.convert_to(np.float32, alpha=1 / 255.0)),
                              t, b, l, r, cvgs.BorderMode.CONSTANT, 0.447 - 0.1 * values)
             for c in cams]
    ring16 = (ring[:, :FRAME_DST[1]].to(torch.int32) * 16).to(torch.uint16)
    ring_f16 = ring.to(torch.float16) / 4
    return {
        "dk_one_pixel_into_a_u8_batch": ([1, 2] * 4, (
            (cvgs.circular_batch_read(ring, first=1 + values), cvgs.write_tensor()),
            (cvgs.crop_batch(cvgs.image(frame), tiles),
             cvgs.convert_to(np.float32, alpha=0.5, beta=3.25), cvgs.write_tensor()))),
        "dk_staged_into_a_u16_batch": ([1, 2] * 4, (
            (cvgs.circular_batch_read(ring16, first=3 + values), cvgs.split_tensor()),
            (cvgs.batch_read(rotated), cvgs.multiply(16.0), cvgs.split_tensor()))),
        "dk_fused2_into_a_f16_batch": ([1, 2] * 4, (
            (cvgs.circular_batch_read(ring_f16, first=-3 - values), cvgs.split_tensor()),
            (cvgs.batch_read(fused), cvgs.split_tensor()))),
    }


def own_k6_sequence(cvgs, seq, planes):
    """A divergent kernel group's sequence cut to its planes, as the
    divergent kernel's own launch over them reads them: a ring's planes as
    a ``BatchRead`` of the ring's planes they read, ``resize_batch``'s
    rects (a stack's images too) of those planes, a ``BatchRead``'s reads
    of them; with ids ``[1] * len(planes)``: what the split kernel's K6
    part computes, alone."""
    from cvgpuspeedup_tpu_torch.ops.memory import CircularBatchRead
    from cvgpuspeedup_tpu_torch.ops.resize import BatchResizeRead

    read, idx = seq.read, list(planes)
    if isinstance(read, CircularBatchRead):
        n, first = read.data.shape[0], int(read.first)
        read = cvgs.batch_read([cvgs.image(read.data[(first + z if read.ascendent else first - z)
                                                     % n]) for z in idx])
    elif isinstance(read, BatchResizeRead):
        read = dataclasses.replace(read, rects=read.rects[idx],
                                   stack=None if read.stack is None else read.stack[idx])
    else:
        read = dataclasses.replace(read, ops=tuple(read.ops[z] for z in idx))
    return dataclasses.replace(seq, read=read)


# the dtypes a chain may hold beside uint8 and float32, and a scale that
# brings a source of each to a few hundred
NEW_DTYPES = {"i8": np.int8, "u16": np.uint16, "i16": np.int16, "f16": np.float16}
DTYPE_ALPHA = {"u8": 0.5, "i8": 1.5, "u16": 1 / 128.0, "i16": 1 / 96.0, "f16": 0.25, "f32": 0.5}


def as_dtype(torch, u8, name):
    """A uint8 tensor's values spread over the range of another dtype, on
    its device: int8 -128..127, uint16 0..65535, int16 -32768..32512,
    float16 -250..387.5 (exact)."""
    v = u8.to(torch.int32)
    if name == "i8":
        return (v - 128).to(torch.int8)
    if name == "u16":
        return (v * 257).to(torch.uint16)
    if name == "i16":
        return ((v - 128) * 256).to(torch.int16)
    return ((v.to(torch.float32) - 100) * 2.5).to(torch.float16)


def dtype_chain(cvgs, src, dst, to_f32=False):
    """``convert_to`` the dtype ``dst``, a multiply, a subtract and a divide
    in it (an integer saturates after each op, float16 rounds), and with
    ``to_f32`` a cast back to float32."""
    dtype = np.float32 if dst == "f32" else (np.uint8 if dst == "u8" else NEW_DTYPES[dst])
    ops = (cvgs.convert_to(dtype, alpha=DTYPE_ALPHA[src]), cvgs.multiply(0.3),
           cvgs.subtract(0.51), cvgs.divide(0.23))
    return ops + ((cvgs.convert_to(np.float32),) if to_f32 else ())


def dtype_cases(cvgs, torch, frame, rects, hd, ring) -> list:
    """Phase 3's cases of every dtype: ``(name, kernel, ops)``. Each kernel
    at its main path's shapes reads every source dtype it takes (K1, K2 and
    the warp kernel int8, uint16, int16 and float16 beside uint8 and float32;
    the pointwise kernel those too; the divergent kernel's sources of every
    dtype are ``k6_source_cases``), runs chains through int8, uint16, int16
    and float16 back to float32, and stores into each of them, float16
    planes among them."""
    dsize = cvgs.Size(64, 128)
    cases = []
    mid = (WARP_DST[0] / 2, WARP_DST[1] / 2)
    seq = cvgs.build_operation_sequence
    for s in NEW_DTYPES:
        fs, hs = as_dtype(torch, frame, s), as_dtype(torch, hd, s)
        cases += [
            (f"dt_src_{s}_flagship", "batch_resize",
             (cvgs.resize_batch(fs, rects=rects, dsize=dsize),
              cvgs.convert_to(np.float32, alpha=DTYPE_ALPHA[s]), cvgs.subtract(SUB),
              cvgs.divide(DIV), cvgs.split_tensor())),
            (f"dt_src_{s}_frame_a", "frame_resize",
             (cvgs.resize(cvgs.image(hs), cvgs.Size(*FRAME_DST)),
              cvgs.convert_to(np.float32, alpha=DTYPE_ALPHA[s] / 255.0), cvgs.subtract(MEAN),
              cvgs.divide(STD), cvgs.split_tensor())),
            (f"dt_src_{s}_w2_rotation", "warp",
             (cvgs.warp(cvgs.image(hs), rotation((960, 540), 10.0, 1 / 3.0, to=mid),
                        cvgs.Size(*WARP_DST), default=(1.0, 2.0, 3.0)),
              cvgs.convert_to(np.float32, alpha=DTYPE_ALPHA[s]), cvgs.split_tensor())),
            (f"dt_src_{s}_p3_border_constant", "pointwise",
             (cvgs.make_border(cvgs.image(hs), BORDER, BORDER, BORDER, BORDER,
                               cvgs.BorderMode.CONSTANT, value=(10.0, 20.0, 30.0)),
              cvgs.convert_to(np.float32, alpha=DTYPE_ALPHA[s]), cvgs.split_tensor())),
        ]
        for to_f32 in (True, False):  # a chain through the dtype, or one stored in it
            tag = f"dt_chain_{s}" + ("_to_f32" if to_f32 else "_stored")
            chain = dtype_chain(cvgs, "u8", s, to_f32)
            cases += [
                (f"{tag}_flagship", "batch_resize",
                 (cvgs.resize_batch(frame, rects=rects, dsize=dsize), *chain, cvgs.split_tensor())),
                (f"{tag}_frame_a", "frame_resize",
                 (cvgs.resize(cvgs.image(hd), cvgs.Size(*FRAME_DST)), *chain,
                  cvgs.split_tensor())),
                (f"{tag}_w6", "warp", warp_batch_ops(cvgs, cvgs.image(hd), -10.0, 7)[:1]
                 + (*chain, cvgs.split_tensor())),
                (f"{tag}_p2_ring", "pointwise",
                 (cvgs.circular_batch_read(ring, first=3), *chain, cvgs.split_tensor())),
                (f"{tag}_d1", "divergent", ([1, 2] * 8, (
                    seq(cvgs.circular_batch_read(ring, first=3), *chain, cvgs.write_tensor()),
                    seq(cvgs.circular_batch_read(ring, first=-5),
                        cvgs.convert_to(np.float32, alpha=0.5), cvgs.write_tensor())))),
            ]
    cases += [
        ("dt_src_i8_w5_perspective", "warp",
         (cvgs.warp(cvgs.image(as_dtype(torch, hd, "i8")), PERSPECTIVE_W5, cvgs.Size(640, 384),
                    warp_type=cvgs.WarpType.PERSPECTIVE), cvgs.convert_to(np.float32),
          cvgs.split_tensor())),
        ("dt_src_u16_w6_batch_to_f16", "warp",
         warp_batch_ops(cvgs, cvgs.image(as_dtype(torch, hd, "u16")), -10.0, 7)[:1]
         + (cvgs.convert_to(np.float32, alpha=1 / 257.0), cvgs.convert_to(np.float16),
            cvgs.split_tensor())),
        ("dt_src_f16_p1_image_gray", "pointwise",
         (cvgs.image(as_dtype(torch, hd, "f16")),
          cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_RGB2GRAY), cvgs.multiply(0.5),
          cvgs.write())),
        # a uint16 chain into a uint8 batch (it wraps), a float16 crop group
        # and a uint8 image group into a float16 batch
        ("dt_d1_u16_group_into_u8_batch", "divergent", ([1, 2] * 8, (
            seq(cvgs.circular_batch_read(ring, first=1), cvgs.convert_to(np.uint8, alpha=0.5),
                cvgs.write_tensor()),
            seq(cvgs.image(ring), cvgs.convert_to(np.uint16, alpha=300.0),
                cvgs.write_tensor())))),
        ("dt_d3_f16_crops_u8_images", "divergent", ([1, 1, 2, 1, 2, 1, 1, 2], (
            seq(cvgs.resize_batch(frame, rects=rects[:8], dsize=dsize),
                cvgs.convert_to(np.float16, alpha=0.25), cvgs.subtract(0.51), cvgs.write_tensor()),
            seq(cvgs.image(ring[:8, :128, :64].contiguous()), cvgs.convert_to(np.uint8),
                cvgs.write_tensor())))),
    ]
    return cases


def dtype_store_cases(cvgs, frame, rects, hd) -> list:
    """Phase 3's stores of one chain dtype into an ``out=`` view of another:
    ``(name, kernel, ops, view dtype)`` for a uint16 chain into uint8 (a
    narrowing wrap), a uint8 chain into int16 (widening) and a float16
    chain into uint8 (clamped, then truncated), in each kernel with
    ``out=``."""
    reads = {
        "batch_resize": lambda: cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
        "frame_resize": lambda: cvgs.resize(cvgs.image(hd), cvgs.Size(*FRAME_DST)),
        "warp": lambda: cvgs.warp(cvgs.image(hd), rotation((960, 540), 10.0, 1 / 3.0,
                                                           to=(WARP_DST[0] / 2, WARP_DST[1] / 2)),
                                  cvgs.Size(*WARP_DST)),
        "pointwise": lambda: cvgs.crop(cvgs.image(hd), cvgs.Rect(-300, -200, 256, 256)),
    }
    chains = {"u16_into_u8": (np.uint16, 300.0, np.uint8), "u8_into_i16": (np.uint8, 1.7, np.int16),
              "f16_into_u8": (np.float16, 1.7, np.uint8)}
    return [(f"dt_out_{name}_{kernel}", kernel,
             (read(), cvgs.convert_to(dtype, alpha=alpha), cvgs.subtract(70.25), cvgs.split_tensor()),
             view)
            for kernel, read in reads.items() for name, (dtype, alpha, view) in chains.items()]


def as_int32(torch, u8):
    """A uint8 tensor's values spread over int32 on its device, so that a
    rounding through float32 and a saturation both show: 0..63 within 64 of
    int32's minimum, 192..255 within 64 of its maximum, the rest
    (v - 128) * 2^24 + 3v, past 2^24 (float32 does not hold them)."""
    v = u8.to(torch.int64)
    return torch.where(v < 64, -2 ** 31 + v, torch.where(
        v >= 192, 2 ** 31 - 1 - (255 - v), (v - 128) * 2 ** 24 + 3 * v)).to(torch.int32)


#: float values past every integer range, the infinities and NaN
EDGES = (float("inf"), float("-inf"), float("nan"), 3e9, -3e9, 2.0 ** 31, -2.0 ** 31, 70000.5,
         -0.5, 254.5, 300.0, -9.0, 65535.5, -32768.5, 1e38, -1e38)


def as_edges(torch, u8):
    """A uint8 tensor as float32 values on its device, a sixteenth each of
    ``EDGES``."""
    table = torch.tensor(EDGES, dtype=torch.float32, device=u8.device)
    return table[(u8.to(torch.int64) % len(EDGES))]


def int32_cases(cvgs, torch, frame, rects, hd, ring) -> list:
    """Phase 3's int32 cases: ``(name, kernel, ops)``. An int32 source in K1,
    K2, the warp kernel (read into float32) and the pointwise kernel (as its
    bits: copies exact at every value); chains through int32 (an op on it is
    a float32 op saturated back) in all five kernels, its wraps, saturates,
    gray and alpha; a float32 source of ``EDGES`` cast into uint8, int16 and
    int32 in every kernel (truncated or rounded, saturated, NaN to 0)."""
    dsize, seq = cvgs.Size(64, 128), cvgs.build_operation_sequence
    mid = (WARP_DST[0] / 2, WARP_DST[1] / 2)
    fi, hi, ri = as_int32(torch, frame), as_int32(torch, hd), as_int32(torch, ring)
    to_f32 = (cvgs.convert_to(np.float32, alpha=2.0 ** -24), cvgs.subtract(SUB), cvgs.divide(DIV))
    w2 = rotation((960, 540), 10.0, 1 / 3.0, to=mid)
    cases = [
        ("i32_src_flagship", "batch_resize",
         (cvgs.resize_batch(fi, rects=rects, dsize=dsize), *to_f32, cvgs.split_tensor())),
        ("i32_src_frame_a", "frame_resize",
         (cvgs.resize(cvgs.image(hi), cvgs.Size(*FRAME_DST)), *to_f32, cvgs.split_tensor())),
        ("i32_src_w2_rotation", "warp",
         (cvgs.warp(cvgs.image(hi), w2, cvgs.Size(*WARP_DST), default=(1.0, 2.0, 3.0)),
          *to_f32, cvgs.split_tensor())),
        ("i32_src_w6_into_i32", "warp", warp_batch_ops(cvgs, cvgs.image(hi), -10.0, 7)[:1]
         + (cvgs.convert_to(np.int32), cvgs.split_tensor())),
        ("i32_p2_ring_unchanged", "pointwise",
         (cvgs.circular_batch_read(ri, first=3), cvgs.split_tensor())),
        ("i32_p3_border_constant_unchanged", "pointwise",
         (cvgs.make_border(cvgs.image(hi), BORDER, BORDER, BORDER, BORDER,
                           cvgs.BorderMode.CONSTANT, value=(3e9, -9.0, float("nan"))),
          cvgs.write())),
        ("i32_p4_crop_unchanged", "pointwise",
         (cvgs.crop(cvgs.image(hi), cvgs.Rect(-300, -200, 640, 360)), cvgs.split_tensor())),
        ("i32_gray", "pointwise",
         (cvgs.image(hi), cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_RGB2GRAY), cvgs.write())),
        ("i32_bgra", "pointwise",
         (cvgs.image(hi), cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_BGR2BGRA),
          cvgs.split_tensor())),
        ("i32_wrap_u8", "pointwise", (cvgs.image(hi), cvgs.Cast(dst=torch.uint8), cvgs.write())),
        ("i32_saturate_i16", "pointwise", (cvgs.image(hi), cvgs.convert_to(np.int16),
                                           cvgs.write())),
        ("i32_to_f16", "pointwise", (cvgs.image(hi), cvgs.convert_to(np.float16), cvgs.write())),
        ("i32_ops_mul_add", "pointwise", (cvgs.image(hi), cvgs.multiply(3.0), cvgs.add(-7.0),
                                          cvgs.split_tensor())),
    ]
    for to_float in (False, True):  # a uint8 head's chain through int32, stored or back to f32
        chain = (cvgs.convert_to(np.int32, alpha=1e7), cvgs.multiply(3.0), cvgs.add(-2e9))
        chain += (cvgs.convert_to(np.float32),) if to_float else ()
        tag = "i32_chain" + ("_to_f32" if to_float else "_stored")
        cases += [
            (f"{tag}_flagship", "batch_resize",
             (cvgs.resize_batch(frame, rects=rects, dsize=dsize), *chain, cvgs.split_tensor())),
            (f"{tag}_frame_a", "frame_resize",
             (cvgs.resize(cvgs.image(hd), cvgs.Size(*FRAME_DST)), *chain, cvgs.split_tensor())),
            (f"{tag}_w6", "warp", warp_batch_ops(cvgs, cvgs.image(hd), -10.0, 7)[:1]
             + (*chain, cvgs.split_tensor())),
            (f"{tag}_p2_ring", "pointwise",
             (cvgs.circular_batch_read(ring, first=3), *chain, cvgs.split_tensor())),
            (f"{tag}_d1", "divergent", ([1, 2] * 8, (
                seq(cvgs.circular_batch_read(ring, first=3), *chain, cvgs.write_tensor()),
                seq(cvgs.circular_batch_read(ring, first=-5),
                    cvgs.convert_to(np.float32, alpha=3e7), cvgs.write_tensor())))),
        ]
    cases += [
        ("i32_gray_flagship", "batch_resize",
         (cvgs.resize_batch(frame, rects=rects, dsize=dsize),
          cvgs.convert_to(np.int32, alpha=1e7),
          cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_RGB2GRAY), cvgs.split_tensor())),
        # crops into an int32 batch beside a uint8 image group (stored exact)
        ("i32_d3_crops_u8_images", "divergent", ([1, 1, 2, 1, 2, 1, 1, 2], (
            seq(cvgs.resize_batch(frame, rects=rects[:8], dsize=dsize),
                cvgs.convert_to(np.int32, alpha=1e7), cvgs.add(-1e9), cvgs.write_tensor()),
            seq(cvgs.image(ring[:8, :128, :64].contiguous()), cvgs.convert_to(np.uint8),
                cvgs.write_tensor())))),
    ]
    # out-of-range values and NaN cast into uint8, int16 and int32
    fe, he, re = as_edges(torch, frame), as_edges(torch, hd), as_edges(torch, ring)
    heads = {
        "batch_resize": lambda: cvgs.resize_batch(fe, rects=rects, dsize=dsize),
        "frame_resize": lambda: cvgs.resize(cvgs.image(he), cvgs.Size(*FRAME_DST)),
        "warp": lambda: cvgs.warp(cvgs.image(he), w2, cvgs.Size(*WARP_DST)),
        "pointwise": lambda: cvgs.image(he),
    }
    casts = {"cast_u8": cvgs.Cast(dst=torch.uint8), "cast_i16": cvgs.Cast(dst=torch.int16),
             "cast_i32": cvgs.Cast(dst=torch.int32),
             "saturate_i32": cvgs.SaturateCast(dst=torch.int32)}
    for kernel, head in heads.items():
        for name, cast in casts.items():
            cases.append((f"edges_{name}_{kernel}", kernel,
                          (head(), cvgs.multiply(1.5), cast, cvgs.split_tensor())))
    for name, cast in casts.items():
        cases.append((f"edges_{name}_divergent", "divergent", ([1, 2] * 8, (
            seq(cvgs.circular_batch_read(re, first=3), cvgs.multiply(1.5), cast,
                cvgs.write_tensor()),
            seq(cvgs.circular_batch_read(re, first=-5), cast, cvgs.write_tensor())))))
    return cases


def int32_store_cases(cvgs, torch, frame, rects, hd) -> list:
    """Phase 3's int32 stores into an ``out=`` view of another dtype:
    ``(name, kernel, ops, view dtype)`` for an int32 chain into uint8 (its
    low bits) and float32 (converted), and a float32 chain of ``EDGES`` into
    int32 (truncated, saturated, NaN to 0), in each kernel with ``out=``."""
    fe, he = as_edges(torch, frame), as_edges(torch, hd)
    w2 = rotation((960, 540), 10.0, 1 / 3.0, to=(WARP_DST[0] / 2, WARP_DST[1] / 2))
    reads = {
        "batch_resize": lambda f: cvgs.resize_batch(f, rects=rects, dsize=cvgs.Size(64, 128)),
        "frame_resize": lambda f: cvgs.resize(cvgs.image(f), cvgs.Size(*FRAME_DST)),
        "warp": lambda f: cvgs.warp(cvgs.image(f), w2, cvgs.Size(*WARP_DST)),
        "pointwise": lambda f: cvgs.crop(cvgs.image(f), cvgs.Rect(-300, -200, 256, 256)),
    }
    cases = []
    for kernel, read in reads.items():
        src = frame if kernel == "batch_resize" else hd
        for view in (np.uint8, np.float32):
            cases.append((f"i32_out_into_{np.dtype(view).name}_{kernel}", kernel,
                          (read(src), cvgs.convert_to(np.int32, alpha=1e7), cvgs.add(-1e9),
                           cvgs.split_tensor()), view))
        cases.append((f"edges_out_into_int32_{kernel}", kernel,
                      (read(fe if kernel == "batch_resize" else he), cvgs.multiply(1.5),
                       cvgs.split_tensor()), np.int32))
    return cases


def as_int64(torch, u8):
    """A uint8 tensor's values as int64 on its device: ``as_int32``'s values
    in the low 32 bits, and high bits that vary with the value, which the
    reference's conversion to int32 drops."""
    return as_int32(torch, u8).to(torch.int64) + (u8.to(torch.int64) % 7 - 3) * 2 ** 32


#: float64 values float32 holds only as an infinity, a subnormal or 0
EDGES64 = (1e39, -1e39, 1e-40, -1e-42, 1e-46, 3.4028235677973366e38)


def as_float64(torch, u8, edges=False):
    """A uint8 tensor's values as float64 on its device, -250..388 with parts
    that float32 rounds; with ``edges`` a sixteenth each of ``EDGES64``."""
    v = u8.to(torch.float64)
    x = (v - 100.0) * 2.5 + v / 3.0e4 + 1.0 / 3.0
    if edges:
        k = u8.to(torch.int64) % 16
        table = torch.tensor(EDGES64, dtype=torch.float64, device=u8.device)
        x = torch.where(k < len(EDGES64), table[k.clamp(max=len(EDGES64) - 1)], x)
    return x


def x64_cases(cvgs, torch, frame, rects, hd, ring) -> list:
    """Phase 3's 64-bit sources: ``(name, kernel, ops)``, max |diff| 0. An
    int64 and a float64 tensor on the card in K1, K2 and the warp kernel
    (read at load into float32: int64 by its low 32 bits, float64 rounded),
    in the pointwise kernel (copies of a ring, a crop, a CONSTANT border and
    a one-channel image, an op; int64 as its low 32 bits in int32's
    register), float64 values past float32's range and below its normals
    copied, and float64 groups of K6."""
    dsize, seq = cvgs.Size(64, 128), cvgs.build_operation_sequence
    w2 = rotation((960, 540), 10.0, 1 / 3.0, to=(WARP_DST[0] / 2, WARP_DST[1] / 2))
    f64, h64, r64 = (as_float64(torch, t) for t in (frame, hd, ring))
    cases = []
    for tag, f, h, r, chain in (
            ("i64", as_int64(torch, frame), as_int64(torch, hd), as_int64(torch, ring),
             (cvgs.convert_to(np.float32, alpha=2.0 ** -24), cvgs.subtract(SUB),
              cvgs.divide(DIV))),
            ("f64", f64, h64, r64,
             (cvgs.multiply(1 / 255.0), cvgs.subtract(MEAN), cvgs.divide(STD)))):
        cases += [
            (f"x64_src_{tag}_flagship", "batch_resize",
             (cvgs.resize_batch(f, rects=rects, dsize=dsize), *chain, cvgs.split_tensor())),
            (f"x64_src_{tag}_frame_a", "frame_resize",
             (cvgs.resize(cvgs.image(h), cvgs.Size(*FRAME_DST)), *chain, cvgs.split_tensor())),
            (f"x64_src_{tag}_w2_rotation", "warp",
             (cvgs.warp(cvgs.image(h), w2, cvgs.Size(*WARP_DST), default=(1.0, 2.0, 3.0)),
              *chain, cvgs.split_tensor())),
            (f"x64_src_{tag}_w6", "warp", warp_batch_ops(cvgs, cvgs.image(h), -10.0, 7)[:1]
             + (*chain, cvgs.split_tensor())),
            (f"x64_{tag}_p2_ring_unchanged", "pointwise",
             (cvgs.circular_batch_read(r, first=3), cvgs.split_tensor())),
            (f"x64_{tag}_p3_border_constant_unchanged", "pointwise",
             (cvgs.make_border(cvgs.image(h), BORDER, BORDER, BORDER, BORDER,
                               cvgs.BorderMode.CONSTANT, value=(3e9, -9.0, 0.5)), cvgs.write())),
            (f"x64_{tag}_p4_crop_unchanged", "pointwise",
             (cvgs.crop(cvgs.image(h), cvgs.Rect(-300, -200, 640, 360)), cvgs.split_tensor())),
            # one channel of 1080p: the one-lane instance, 16 pixels a thread
            (f"x64_{tag}_one_channel_mad", "pointwise",
             (cvgs.image(h[..., 1:2].contiguous()), cvgs.multiply(1.0009), cvgs.add(0.0001),
              cvgs.write())),
            (f"x64_{tag}_ops_mul_add", "pointwise",
             (cvgs.image(h), cvgs.multiply(3.0), cvgs.add(-7.0), cvgs.split_tensor())),
        ]
    he, re = as_float64(torch, hd, edges=True), as_float64(torch, ring, edges=True)
    flat = as_float64(torch, ring[:8, :128, :64])
    mats = [rotation((960, 540), 4.0 * z - 14.0, 1 / 3.0, to=(32, 64)) for z in range(8)]
    cases += [
        ("x64_f64_edges_p4_crop_unchanged", "pointwise",
         (cvgs.crop(cvgs.image(he), cvgs.Rect(7, 9, 640, 360)), cvgs.split_tensor())),
        ("x64_f64_edges_p2_ring_unchanged", "pointwise",
         (cvgs.circular_batch_read(re, first=-5), cvgs.write_tensor())),
        ("x64_f64_edges_one_channel_unchanged", "pointwise",
         (cvgs.image(he[..., :1].contiguous()), cvgs.write())),
        ("x64_f64_d1", "divergent", ([1, 2] * 8, (
            seq(cvgs.circular_batch_read(r64, first=3), cvgs.multiply(1 / 255.0),
                cvgs.subtract(MEAN), cvgs.write_tensor()),
            seq(cvgs.circular_batch_read(r64, first=-5), cvgs.convert_to(np.uint8),
                cvgs.convert_to(np.float32, alpha=0.5), cvgs.write_tensor())))),
        ("x64_f64_d4_warp_crop_pass", "divergent", ([1, 2, 3, 1, 2, 3, 1, 2], (
            seq(cvgs.warp_batch([cvgs.image(h64)] * 8, mats, dsize), cvgs.multiply(0.5),
                cvgs.write_tensor()),
            seq(cvgs.resize_batch(f64, rects=rects[:8], dsize=dsize), cvgs.subtract(0.51),
                cvgs.write_tensor()),
            seq(cvgs.image(flat), cvgs.multiply(2.0), cvgs.write_tensor())))),
        ("x64_f64_d5_stack_resize", "divergent", ([1, 2] * 4, (
            seq(cvgs.resize_batch([flat[z] for z in range(8)], dsize=dsize, used_planes=7,
                                  background=5.0), cvgs.write_tensor()),
            seq(cvgs.image(flat), cvgs.write_tensor())))),
    ]
    return cases


#: float32 subnormals, and values whose products with a chain's scalars
#: underflow
EDGES32 = (1e-40, -2e-39, -5e-40, 1e-38, 2.0 ** -149, -1e-38, 1e-30, -3e-31)


def as_edges32(torch, u8):
    """A uint8 tensor as float32 values on its device: a sixteenth from
    ``EDGES32``, the others (v - 127.5) / 64, normal and never 0."""
    k = u8.to(torch.int64)
    table = torch.tensor(EDGES32, dtype=torch.float32, device=u8.device)
    return torch.where(k % 16 == 0, table[(k // 16) % len(EDGES32)], (k.float() - 127.5) / 64.0)


def subnormal_cases(cvgs, torch, frame, rects, hd, ring) -> list:
    """The subnormal phase: ``(name, kernel, ops)``, each kernel's output
    equal to its plain version as int32 bits. Float32 sources of
    ``as_edges32`` through K1's flagship, K2's frame (a), W6, D1, P1 at
    512x512 and P3, each chain ending with a subnormal scalar (which reads
    as 0) and a divide by 1e38, which flushes every result below 1.17 in
    magnitude, more than half of them."""
    dsize, seq = cvgs.Size(64, 128), cvgs.build_operation_sequence
    fe, he, re = as_edges32(torch, frame), as_edges32(torch, hd), as_edges32(torch, ring)
    chain = (cvgs.multiply(1.0), cvgs.subtract((1e-40, 0.0, -2e-39)), cvgs.divide(1e38))
    return [
        ("sub_k1_flagship", "batch_resize",
         (cvgs.resize_batch(fe, rects=rects, dsize=dsize), *chain, cvgs.split_tensor())),
        ("sub_k2_frame_a", "frame_resize",
         (cvgs.resize(cvgs.image(he), cvgs.Size(*FRAME_DST)), *chain, cvgs.split_tensor())),
        ("sub_w6", "warp", warp_batch_ops(cvgs, cvgs.image(he), -10.0, 7)[:1]
         + (*chain, cvgs.split_tensor())),
        ("sub_d1", "divergent", ([1, 2] * 8, (
            seq(cvgs.circular_batch_read(re, first=3), cvgs.convert_to(np.float32, alpha=1.0),
                *chain[1:], cvgs.write_tensor()),
            seq(cvgs.circular_batch_read(re, first=-5), cvgs.convert_to(np.float32, alpha=0.5),
                cvgs.multiply((2.0, 1.0, 1e-40)), cvgs.divide(1e38), cvgs.write_tensor())))),
        ("sub_p1_mad_512x512", "pointwise",
         (cvgs.image(he[:512, :512, :1].contiguous()), mad_chain(cvgs), cvgs.subtract(1e-40),
          cvgs.divide(1e38), cvgs.write())),
        ("sub_p3_border8_replicate_1080p", "pointwise",
         (cvgs.make_border(cvgs.image(he), BORDER, BORDER, BORDER, BORDER,
                           cvgs.BorderMode.REPLICATE), *chain, cvgs.split_tensor())),
    ]


#: the source dtypes of K6's general instance (csrc/divergent_any.cu), each
#: made from a uint8 tensor: ``as_dtype``'s four, int32 near its bounds
#: (``as_int32``) and int64 tensors read at load (``as_int64``)
K6_DTYPES = ("i8", "u16", "i16", "f16", "i32", "i64")
#: D1S: D1's pair of sequences over the last 8 frames of a 16-bit RGB
#: 1080p camera, a ring of 99.5 MB normalized into 199 MB of float32
D1S_RING = (8, 1080, 1920, 3)


def as_k6_source(torch, u8, name):
    """A uint8 tensor as a source of ``K6_DTYPES``' ``name``, on its device."""
    if name == "i32":
        return as_int32(torch, u8)
    if name == "i64":
        return as_int64(torch, u8)
    return as_dtype(torch, u8, name)


def d1s_ring(torch, dev, seed=24):
    """D1S's ring: 16-bit values over the whole range, made from a seed."""
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 1 << 16, D1S_RING).astype(np.uint16)).to(dev)


def k6_source_cases(cvgs, torch, rows) -> dict:
    """Phase 3's cases of K6's general instance: ``name -> (plane ids,
    sequences)``. D1, D3 and D4 of ``DivergentRows`` with every source
    (ring, frame, images, flat planes) in each of ``K6_DTYPES``
    (``DivergentRows.cast``), and batches of groups of different source
    dtypes: a uint16 ring into uint8 beside uint8 crops (a uint8 batch), a
    float16 stack beside warps of float32 images (a float16 batch), and
    groups of five dtypes in a batch of 16 x 128 x 256 planes, 4 pixels a
    thread (a uint16 ring, uint8 crops, an int32 ring wrapped into uint16,
    float16 images and warps of int64 images)."""
    seq = cvgs.build_operation_sequence
    cases = {}
    for s in K6_DTYPES:
        r = rows.cast(lambda u8, s=s: as_k6_source(torch, u8, s))
        cases[f"dt_src_{s}_d1"] = r.d1(3)
        cases[f"dt_src_{s}_d3"] = r.d3(r.d3_rects())
        cases[f"dt_src_{s}_d4"] = r.d4()
    ring8 = rows.ring[:8, :, :64].contiguous()
    cases["dt_mixed_u16_ring_u8_crops_into_u8"] = ([1, 2, 2, 1, 2, 1, 1, 2], (
        seq(cvgs.circular_batch_read(as_dtype(torch, ring8, "u16"), first=-2),
            cvgs.convert_to(np.uint8, alpha=1 / 257.0), cvgs.write_tensor()),
        seq(cvgs.resize_batch(rows.frame, rects=rows.d3_rects(), dsize=rows.dsize),
            cvgs.convert_to(np.float32, alpha=0.5), cvgs.write_tensor())))
    cases["dt_mixed_f16_stack_f32_warps_into_f16"] = ([1, 2, 2, 1, 2, 1, 1, 2], (
        seq(cvgs.image(as_dtype(torch, ring8, "f16")), cvgs.write_tensor()),
        seq(cvgs.warp_batch([cvgs.image(im.float()) for im in rows.imgs],
                            rows.d4_mats(-14.0), rows.dsize), cvgs.multiply(0.75),
            cvgs.write_tensor())))
    dsize = cvgs.Size(256, 128)
    to_u16 = cvgs.convert_to(np.uint16, alpha=100.0)
    cases["dt_mixed_five_sources_16x128x256"] = ([1 + z % 5 for z in range(16)], (
        seq(cvgs.circular_batch_read(as_dtype(torch, rows.ring, "u16"), first=3),
            cvgs.write_tensor()),
        seq(cvgs.resize_batch(rows.frame, rects=DivergentRows.d3_rects(n=16), dsize=dsize),
            to_u16, cvgs.write_tensor()),
        seq(cvgs.circular_batch_read(as_int32(torch, rows.ring), first=-3, ascendent=False),
            cvgs.convert_to(np.uint16), cvgs.write_tensor()),
        seq(cvgs.image(as_dtype(torch, rows.ring, "f16")), to_u16, cvgs.write_tensor()),
        seq(cvgs.warp_batch([cvgs.image(as_int64(torch, im)) for im in rows.imgs * 2],
                            rows.d4_mats(-14.0, 16), dsize),
            cvgs.convert_to(np.float32, alpha=2.0 ** -20), to_u16, cvgs.write_tensor())))
    return cases


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
    from cvgpuspeedup_tpu_torch.exec import cuda_composed as kc
    from cvgpuspeedup_tpu_torch.exec import cuda_divergent as kd
    from cvgpuspeedup_tpu_torch.exec import cuda_divergent_split as ks
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
    entry, nested, k6, split = "", {}, {}, {}
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"phase2 ptxas: {line.strip()}")
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        if "composed_kernel_nested" in entry and ("registers" in line or "spill" in line):
            nested.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
        if "divergent_kernel" in entry and ("registers" in line or "spill" in line):
            k6.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
        if "divergent_split" in entry and ("registers" in line or "spill" in line):
            split.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    # K6's instances, registers and spills: divergent.cu's eight (groups of
    # uint8, float32 and float64 sources) and the general instance's eight
    # (divergent_any.cu: a group of any of nine source dtypes), each an
    # output type x 1 or 4 pixels a thread
    k6_registers = {}
    for general in (False, True):
        mine = {e: lines for e, lines in k6.items() if ("divergent_kernel_any" in e) == general}
        what = "general instance (divergent_any.cu)" if general else "instances of divergent.cu"
        k6_registers["general" if general else "first"] = {
            e: " ".join(lines) for e, lines in sorted(mine.items())}
        log(f"phase2 K6 {what}, {len(mine)}: "
            + "; ".join(f"{e}: {' '.join(lines)}" for e, lines in sorted(mine.items()))
            + f"; card {card}")
        assert len(mine) == 8, sorted(mine)
    # the composed kernel's nested instances alone: registers and spills;
    # the staged ones (by value and mixed, whose block also holds its plane
    # head in shared memory) bounded to 64 registers, 4 blocks an SM
    for k, (entry, lines) in enumerate(sorted(nested.items())):
        log(f"phase2 nested instance {k} ({entry}): {'; '.join(lines)}")
        if "_staged" in entry:
            used = [int(w) for line in lines for w in re.findall(r"Used (\d+) registers", line)]
            assert used and max(used) <= 64, (entry, lines)
    # a divergent batch's general nested instances (composed_nested_divergent.cu,
    # AnyImage): the three of a mixed nested batch, registers and spills
    general = {e: lines for e, lines in nested.items() if "AnyImage" in e}
    log(f"phase2 the general nested instances (AnyImage), {len(general)}: "
        + "; ".join(f"{'staged' if '_staged' in e else 'per tap' if 'Lb1E' in e else 'FusedRead2'}"
                    f" {' '.join(lines)}" for e, lines in sorted(general.items()))
        + f"; card {card}")
    assert len(general) == 3, sorted(general)
    # the split kernel's instances (divergent_split*.cu): K6's body beside the
    # composed part's body, an output element type x the composed form (one
    # pixel, a resample, a FusedRead2 alone, per tap, staged); registers,
    # spills and static shared memory (under the 48 KB of a static
    # allocation), the staged ones held at 64 registers, 4 blocks an SM
    split_registers = {e: " ".join(lines) for e, lines in sorted(split.items())}
    log(f"phase2 split instances, {len(split)}, from "
        f"{', '.join(src.name for src in _build.SOURCES if 'divergent_split' in src.name)}: "
        + "; ".join(f"{e}: {v}" for e, v in split_registers.items()) + f"; card {card}")
    assert len(split) == 20, sorted(split)
    for e, lines in split.items():
        smem = [int(w) for line in lines for w in re.findall(r"(\d+) bytes smem", line)]
        assert smem and max(smem) < 48 * 1024, (e, lines)
        if "_staged" in e:
            used = [int(w) for line in lines for w in re.findall(r"Used (\d+) registers", line)]
            assert used and max(used) <= 64, (e, lines)
    # the float32 rule in the SASS: every float32 add, multiply, compare and
    # min/max flushes subnormals (.FTZ), and the float64 load converts
    # without .FTZ, so that a copy keeps a float32 subnormal. The one
    # exception, by name: a warp map's terms (warp.cuh's fmul_keep and
    # fadd_keep, PTX mul.rn.f32 and add.rn.f32), an FMUL or FADD without
    # .FTZ in the warp, divergent, composed and split kernels alone
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import kernel_sass

    t0 = time.perf_counter()
    for kernel, c in kernel_sass.ftz_census(_build.library_path()).items():
        log(f"phase2 sass {kernel}: {c['instances']} instances, {c['f32_ops']} float32 "
            f"FADD/FMUL/FSETP/FMNMX, {c['f32_no_ftz']} without .FTZ, of them {c['keep_terms']} "
            f"FMUL/FADD of a warp map's terms ({dict(c['no_ftz_opcodes'])}); {c['f2f_f64']} "
            f"F2F.F32.F64, {c['f2f_f64_ftz']} with .FTZ")
        if not c["rule_holds"]:
            raise AssertionError(f"{kernel}: the float32 rule does not hold in its SASS: {c}")
    log(f"phase2 sass census in {time.perf_counter() - t0:.1f} s")

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
        "composed": (kc, kc.composed, kc.composed_reference),
        "divergent_split": (ks, ks.divergent_split, ks.split_reference),
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
                if g.dtype == torch.uint16:  # its bits: CUDA compares no uint16
                    g, w = g.view(torch.int16), w.view(torch.int16)
                if not torch.equal(g, w):
                    bad = int((g.to(torch.int32) != w.to(torch.int32)).sum())
                    raise AssertionError(f"{name}: {bad} {g.dtype} values differ")
                d = 0.0
            elif tol == 0.0 and not bool(torch.isfinite(w).all()):
                # an infinity the plain version gives too (int32 past float16's
                # range): every bit must agree
                bits = torch.int16 if g.element_size() == 2 else torch.int32
                if not torch.equal(g.view(bits), w.view(bits)):
                    bad = int((g.view(bits) != w.view(bits)).sum())
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

    # every dtype a TPU kernel takes: each kernel against its plain version
    # at its main path's shapes for every source dtype it reads, chains
    # through int8, uint16, int16 and float16 and stores into each (bit for
    # bit, float32 within 1e-6); then a chain of one dtype stored into an
    # out= view of another, one store each: a narrowing wrap, a widening, a
    # float16 chain clamped into uint8
    for name, kernel, ops in dtype_cases(cvgs, torch, frame, rects_a, hd, ring):
        if kernel == "divergent":
            ids, seqs = ops
            a = kd.prepare(seqs, kd.build_plan(seqs, ids), dev)
            compare(name, kernel, kd.divergent(a), kd.divergent_reference(a))
        else:
            check(name, *ops, kernel=kernel)
    # int32 in every kernel, max |diff| 0: sources, chains, stores, and
    # float values past every integer range and NaN cast as the reference
    for name, kernel, ops in int32_cases(cvgs, torch, frame, rects_a, hd, ring):
        if kernel == "divergent":
            ids, seqs = ops
            a = kd.prepare(seqs, kd.build_plan(seqs, ids), dev)
            compare(name, kernel, kd.divergent(a), kd.divergent_reference(a), 0.0)
        else:
            check(name, *ops, kernel=kernel, tol=0.0)
    # 64-bit sources, read at load as int32 and float32, max |diff| 0: the
    # kernel on the tensor equals its plain version (which converts first)
    for name, kernel, ops in x64_cases(cvgs, torch, frame, rects_a, hd, ring):
        if kernel == "divergent":
            ids, seqs = ops
            plan = kd.build_plan(seqs, ids)
            assert torch.float64 in {g.src_dtype for g in plan.groups}, name
            a = kd.prepare(seqs, plan, dev)
            compare(name, kernel, kd.divergent(a), kd.divergent_reference(a), 0.0)
        else:
            plan = check(name, *ops, kernel=kernel, tol=0.0)
            assert plan.src_dtype in (torch.int64, torch.float64), name
    # every source dtype through K6's general instance (divergent_any.cu),
    # bit for bit its plain version (float32 as int32 bits): D1, D3 and D4 with
    # their sources in int8, uint16, int16, float16, int32 (values near its
    # bounds and past 2^24) and int64 (tensors read at load), and groups of
    # different source dtypes in one batch
    k6_cases = k6_source_cases(cvgs, torch, rows)
    for name, (ids, seqs) in k6_cases.items():
        plan = kd.build_plan(seqs, ids)
        assert plan.general, name
        a = kd.prepare(seqs, plan, dev)
        got, want = kd.divergent(a), kd.divergent_reference(a)
        compare(name, "divergent", got, want, 0.0)
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[got.element_size()]
        assert torch.equal(got.view(bits), want.view(bits)), f"{name}: not bit for bit"
        log(f"phase3 divergent {name}: sources {[str(g.src_dtype)[6:] for g in plan.groups]}, "
            f"groups {[g.kind for g in plan.groups]}, the general instance; bit for bit")
    # subnormal float32 values, flushed as operands and results of every op
    # and kept by copies: each kernel equal to its plain version as int32
    # bits (-0 and +0 differ), one launch, zeros and no subnormal left
    for name, kernel, ops in subnormal_cases(cvgs, torch, frame, rects_a, hd, ring):
        module, launch, plain = kernels[kernel]
        if kernel == "divergent":
            ids, seqs = ops
            a = kd.prepare(seqs, kd.build_plan(seqs, ids), dev)
        else:
            pipeline = cvgs.build_pipeline(*ops)
            a = module.prepare(pipeline, module.build_plan(pipeline), dev)
        before = module.LAUNCHES
        got = launch(a)
        want = plain(a)
        torch.cuda.synchronize()
        got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
        if module.LAUNCHES != before + 1:
            raise AssertionError(f"{name}: {module.LAUNCHES - before} launches")
        bad = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                  for g, w in zip(got, want, strict=True))
        flat = torch.cat([g.reshape(-1) for g in got])
        zeros = int((flat == 0).sum())
        sub = int(((flat != 0) & (flat.abs() < 2.0 ** -126)).sum())
        log(f"phase3 {kernel} {name}: {flat.numel()} float32 outputs, {bad} differ from the "
            f"plain version as int32 bits, {zeros} flushed to 0, {sub} subnormal")
        if bad or sub or not zeros:
            raise AssertionError(f"{name}: {bad} bits differ, {zeros} zeros, {sub} subnormals")
    # a float64 source copied: float32's subnormals kept (cvt.rn.f32.f64)
    he64 = as_float64(torch, hd, edges=True)
    pipeline = cvgs.build_pipeline(cvgs.crop(cvgs.image(he64), cvgs.Rect(7, 9, 640, 360)),
                                   cvgs.write())
    got = kp.pointwise(kp.prepare(pipeline, kp.build_plan(pipeline), dev))
    want = he64[9:369, 7:647].float()
    torch.cuda.synchronize()
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    sub = int(((got != 0) & (got.abs() < 2.0 ** -126)).sum())
    kept = [float(v) for v in (1e-40, -1e-42) if bool((got == torch.tensor(
        v, dtype=torch.float64).float()).any())]
    log(f"phase3 pointwise sub_f64_edges_copy: {bad} differ from float64 .float() as int32 bits, "
        f"{sub} subnormal kept, among them {kept}")
    if bad or len(kept) != 2:
        raise AssertionError(f"sub_f64_edges_copy: {bad} bits differ, kept {kept}")
    # warp maps whose inverse has a subnormal coefficient (-1e-39 at c01,
    # then at c10): the host's numpy term -1e-39 * Y is a normal float from
    # Y = 12 on, where a flushed product is 0, so the first column (row)
    # floors to -1 and reads the border with weight 0; an infinite border
    # channel makes that 0 * inf a NaN. The warp kernel and the composed
    # kernel's warp core, each bit for bit its plain version as int32
    sub_src = torch.from_numpy(np.random.default_rng(3).uniform(
        -3, 3, (1080, 64, 3)).astype(np.float32)).to(dev)
    for tag, m in (("c01", ((1, 1e-39, 0), (0, 1, 0))), ("c10", ((1, 0, 0), (1e-39, 1, 0)))):
        for kernel, read in (("warp", cvgs.image(sub_src)),
                             ("composed", cvgs.crop(cvgs.image(sub_src), cvgs.Rect(0, 0, 64, 1080)))):
            module, launch, plain = kernels[kernel]
            pipeline = cvgs.build_pipeline(cvgs.warp(read, np.array(m), cvgs.Size(64, 1080),
                                                     default=(np.inf, -2.0, 5.0)), cvgs.write())
            a = module.prepare(pipeline, module.build_plan(pipeline), dev)
            got, want = launch(a), plain(a)
            torch.cuda.synchronize()
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            nan = int(torch.isnan(want).sum())
            log(f"phase3 {kernel} sub_coefficient_{tag}: {got.numel()} float32 outputs, {bad} "
                f"differ from the plain version as int32 bits, {nan} NaN in both")
            if bad or not nan:
                raise AssertionError(f"{kernel} sub_coefficient_{tag}: {bad} bits differ, {nan} NaN")
            case_err[f"sub_coefficient_{tag}_{kernel}"] = 0.0
    for name, kernel, ops, view_dtype in (dtype_store_cases(cvgs, frame, rects_a, hd)
                                          + int32_store_cases(cvgs, torch, frame, rects_a, hd)):
        module, launch, plain = kernels[kernel]
        pipeline = cvgs.build_pipeline(*ops)
        a = module.prepare(pipeline, module.build_plan(pipeline), dev)
        want = dt.astype(plain(a), dt.to_torch_dtype(view_dtype))
        host = torch.zeros(tuple(want.shape[:-1]) + (want.shape[-1] + 2,), dtype=want.dtype,
                           device=dev)
        view = host[..., 1:-1]  # rows off the contiguous pitch
        compare(name, kernel, launch(a, out=view), want, 0.0)

    # the composed-read kernel: C1-C8 at full width, each equal to its plain
    # version (max |diff| 0); C1 on uint16, float16 and float64 sources and on
    # a float32 frame of EDGES32 with a chain that flushes, as int32 bits, in
    # one launch each, the subnormal one with outputs flushed to 0 and none
    # left subnormal; each also equal, as int32 bits, to the eager path on
    # the card (ParBackend.TORCH), which shares no plan with the kernel
    for name, ops in composed_cases(cvgs, frame, hd, nv12).items():
        plan = check(name, *ops, kernel="composed", tol=0.0)
        log(f"phase3 composed {name}: core {plan.core}, {plan.n_planes} plane(s), source "
            f"{plan.src_dtype}, taps {plan.tap_dtype} of {plan.word('tap_ch')} channel(s), "
            f"{plan.word('in_n_ops')} + {plan.word('out_n_ops')} rows")
    # the batches B1-B7 at full width: one launch each, every plane from its
    # own address (the cameras read in place), equal to the plain version
    cams_np = [rng.integers(0, 256, (FRAME_H, FRAME_W, 3), dtype=np.uint8)
               for _ in range(CAMERAS)]
    cams = [torch.from_numpy(c).to(dev) for c in cams_np]
    for name, ops in batch_cases(cvgs, cams, frame).items():
        plan = check(name, *ops, kernel="composed", tol=0.0)
        log(f"phase3 composed {name}: core {plan.core}, {plan.n_planes} planes of "
            f"{plan.dsize[0]}x{plan.dsize[1]}, source {plan.src_dtype}, "
            f"{plan.word('plane_stride')} block words a plane, used_planes "
            f"{'yes' if plan.word('used_off') >= 0 else 'no'}")
    # the mixed-geometry batches M1-M5 at full width: cameras of three
    # resolutions, regions of eight sizes letterboxed, crops of eight sizes
    # rotated, NV12 buffers of two sizes; one launch each of the instances
    # whose block reads its plane's head, equal to the plain version
    m_cams_np = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in M_CAMERAS]
    m_cams = [torch.from_numpy(c).to(dev) for c in m_cams_np]
    m_nv12 = [torch.from_numpy(rng.integers(0, 256, (h * 3 // 2, w), dtype=np.uint8)).to(dev)
              for h, w in M5_NV12]
    for name, ops in mixed_cases(cvgs, m_cams, frame, m_nv12).items():
        plan = check(name, *ops, kernel="composed", tol=0.0)
        sizes = sorted({q.head[1:3] for q in plan.planes})
        log(f"phase3 composed {name}: core {plan.core}, {plan.n_planes} planes of "
            f"{plan.dsize[0]}x{plan.dsize[1]}, batch word {plan.word('batch')}, bases (h, w) "
            f"{sizes}, cores' sources (h, w) "
            f"{[(q.word('in_h'), q.word('in_w')) for q in plan.planes]}, "
            f"{plan.tables.size} consts words")
        assert plan.word("batch") == kc.MIXED and len(plan.planes) == plan.n_planes, name

    # the nested cases N1-N6 at full width: a second resampling node, or a
    # fused read above the core, in one launch, equal to the plain version
    # and the two at the ends of its staging; with a second resample, the
    # form each block takes (the host's mirror of the kernel's rule,
    # kc.nested_tiles): staged (its footprint's values evaluated once) or
    # per tap (past the budget), or held (a plane past used_planes)
    per_tap_blocks = {}
    for name, ops in {**nested_cases(cvgs, frame, hd, cams),
                      **budget_nested_cases(cvgs, frame)}.items():
        pipeline = cvgs.build_pipeline(*ops)
        na = kc.prepare(pipeline, kc.build_plan(pipeline), dev)
        compare(name, "composed", kc.composed(na), kc.composed_reference(na), 0.0)
        plan = na.plan
        forms = ""
        if plan.core2 != "none":
            tiles = kc.nested_tiles(na)
            count = {f: int((tiles[..., 0] == k).sum()) for k, f in enumerate(kc.TILE_FORMS)}
            staged = tiles[..., 0] == kc.TILE_FORMS.index("staged")
            pixels = staged.sum() * kc.TILE2[0] * kc.TILE2[1]
            per_pixel = float((tiles[..., 1] * tiles[..., 2])[staged].sum() / max(pixels, 1))
            if plan.word("stage2"):
                per_tap_blocks[name] = count["per_tap"]
                forms = (f"; the staging instance, blocks of {kc.TILE2[0]}x{kc.TILE2[1]}: "
                         f"{count['staged']} staged ({per_pixel:.3f} core values a pixel of "
                         f"theirs), {count['per_tap']} per tap past the budget, "
                         f"{count['held']} held")
            else:
                forms = (f"; the per-tap instance (stage2 0: its tiles share no taps), "
                         f"{count['per_tap']} blocks, {count['held']} held")
        log(f"phase3 composed {name}: core {plan.core} under core2 {plan.core2}, "
            f"{plan.n_planes} plane(s) of {plan.dsize[0]}x{plan.dsize[1]}, middle image "
            f"{plan.word('mid_w')}x{plan.word('mid_h')}, source {plan.src_dtype}, "
            f"{plan.word('in_n_ops')} + {plan.word('mid_n_ops')} + {plan.word('out_n_ops')} "
            f"rows{forms}")
    if not per_tap_blocks["n7_quarter_scale_warp_of_a_resize"] or \
            per_tap_blocks["n8_upscale_of_a_downscale"]:
        raise AssertionError(f"per-tap blocks {per_tap_blocks}: the quarter-scale warp must take "
                             "the per-tap form, the upscale none")
    log(f"phase3 composed: the per-tap form beyond the staging budget in "
        f"{per_tap_blocks['n7_quarter_scale_warp_of_a_resize']} blocks of "
        f"n7_quarter_scale_warp_of_a_resize, checked above at max|diff| 0")
    # the batches of nested planes of their own geometry NM1-NM4 at full
    # width: one launch each of the mixed nested instances (each plane's
    # head, tap tables and stage2 its own), equal to the plain version; each
    # plane's blocks' forms from the host's mirror of the kernel's rule
    for name, ops in nested_mixed_cases(cvgs, m_cams, frame).items():
        pipeline = cvgs.build_pipeline(*ops)
        nma = kc.prepare(pipeline, kc.build_plan(pipeline), dev)
        before = kc.LAUNCHES
        got = kc.composed(nma)
        launched = kc.LAUNCHES - before
        compare(name, "composed", got, kc.composed_reference(nma), 0.0)
        plan = nma.plan
        assert plan.core2 and plan.word("batch") == kc.MIXED and launched == 1, (name, launched)
        forms = ""
        if plan.core2 != "none":
            tiles = kc.nested_tiles(nma)[..., 0]
            forms = "; each plane's blocks " + str([
                {f: int((tiles[z] == k).sum()) for k, f in enumerate(kc.TILE_FORMS)
                 if (tiles[z] == k).any()} for z in range(plan.n_planes)])
        log(f"phase3 composed {name}: core {plan.core} under core2 {plan.core2}, "
            f"{plan.n_planes} planes of {plan.dsize[0]}x{plan.dsize[1]}, batch word "
            f"{plan.word('batch')}, bases (h, w) {[q.head[1:3] for q in plan.planes]}, middle "
            f"images (h, w) {[(q.word('mid_h'), q.word('mid_w')) for q in plan.planes]}, stage2 "
            f"{[q.word('stage2') for q in plan.planes]}, {plan.tables.size} consts words{forms}")
    # the divergent batches DV1-DV4 at full width, which the divergent kernel
    # refuses: one launch each of the composed kernel, each plane from its
    # group's head, equal to the plain version (max |diff| 0)
    cams43_np = [rng.integers(0, 256, (*DV_CAMERA, 3), dtype=np.uint8) for _ in range(CAMERAS)]
    cams43 = [torch.from_numpy(c).to(dev) for c in cams43_np]
    sensor = torch.from_numpy(rng.integers(0, 4096, (*DV_SENSOR, 3)).astype(np.uint16)).to(dev)
    for name, (ids, ops) in divergent_composed_cases(cvgs, cams, cams43, frame, sensor).items():
        seqs = tuple(cvgs.build_operation_sequence(*o) for o in ops)
        try:
            kd.build_plan(seqs, ids)
        except kd.Unsupported as e:
            refused = str(e)
        else:
            raise AssertionError(f"{name}: the divergent kernel takes it")
        dva = kc.prepare(seqs, kc.build_divergent_plan(seqs, ids), dev)
        before = kc.LAUNCHES
        got = kc.composed(dva)
        launched = kc.LAUNCHES - before
        compare(name, "composed", got, kc.composed_reference(dva), 0.0)
        plan = dva.plan
        assert launched == 1 and plan.word("batch") == kc.DIVERGENT, (name, launched)
        groups = [(g.sid, g.plan.core, str(g.plan.src_dtype)[6:]) for g in plan.groups]
        log(f"phase3 composed {name}: {plan.n_planes} planes of {plan.dsize[0]}x{plan.dsize[1]} "
            f"{plan.out_dtype}, ids {ids}, groups {groups}, store rows "
            f"{sorted(set(plan.stores))}, "
            f"{plan.tables.size} consts words, {plan.n_block} block words; the divergent kernel "
            f"refuses it: {refused}")
    # the divergent batches with a nested group DVN1-DVN4 at full width: one
    # launch each of the nested instances (each plane's head its group's,
    # nested, or lifted to an identity resize), the instance the routing
    # predicts, equal to the plain version (max |diff| 0); each plane's
    # blocks' forms from the host's mirror of the kernel's rule
    nv12_cams = [torch.from_numpy(rng.integers(0, 256, (FRAME_H * 3 // 2, FRAME_W),
                                               dtype=np.uint8)).to(dev) for _ in range(CAMERAS)]
    for name, (ids, ops) in divergent_nested_cases(cvgs, cams, nv12_cams, sensor).items():
        seqs = tuple(cvgs.build_operation_sequence(*o) for o in ops)
        try:
            kd.build_plan(seqs, ids)
        except kd.Unsupported:
            pass
        else:
            raise AssertionError(f"{name}: the divergent kernel takes it")
        dvna = kc.prepare(seqs, kc.build_divergent_plan(seqs, ids), dev)
        before = kc.LAUNCHES
        got = kc.composed(dvna)
        launched = kc.LAUNCHES - before
        compare(name, "composed", got, kc.composed_reference(dvna), 0.0)
        plan = dvna.plan
        assert launched == 1 and len(plan.head) == kc.NESTED_INTS, (name, launched)
        tiles = kc.nested_tiles(dvna)[..., 0]
        forms = [{f: int((tiles[z] == k).sum()) for k, f in enumerate(kc.TILE_FORMS)
                  if (tiles[z] == k).any()} for z in range(plan.n_planes)]
        groups = [(g.sid, g.plan.core, g.plan.core2 or "-", str(g.plan.src_dtype)[6:])
                  for g in plan.groups]
        log(f"phase3 composed {name}: {plan.n_planes} planes of {plan.dsize[0]}x{plan.dsize[1]} "
            f"{plan.out_dtype}, ids {ids}, groups (sid, core, core2, source) {groups}, second "
            f"levels {[kc.CORES[q.word('core2')] for q in plan.planes]}, stage2 "
            f"{[q.word('stage2') for q in plan.planes]}, instance {kc.divergent_instance(plan)}, "
            f"{plan.tables.size} consts words, {plan.n_block} block words; each plane's blocks "
            f"{forms}")
    # the lift: DV1 (one level) with every plane carried through the nested
    # instances (an identity resize; an empty FusedRead2) equal to its plain
    # version and to DV1's own one-level launch bit for bit; DVN1's trees over
    # float32 cameras a sixteenth of EDGES32 (subnormals, which the
    # letterboxes' exact 3:1 resize copies through the identity), no chain,
    # bit for bit as int32 (NaN and the infinities: the gpu tests)
    ids, ops = divergent_composed_cases(cvgs, cams, cams43, frame, sensor)[
        "dv1_surround_view_letterboxes_and_warps"]
    seqs = tuple(cvgs.build_operation_sequence(*o) for o in ops)
    one_level = kc.composed(kc.prepare(seqs, kc.build_divergent_plan(seqs, ids), dev))
    for lift in kc.LIFTS:
        la = kc.prepare(seqs, kc.build_divergent_plan(seqs, ids, lift), dev)
        got = kc.composed(la)
        compare(f"dv1_lifted_{lift}", "composed", got, kc.composed_reference(la), 0.0)
        same = torch.equal(got.view(torch.int32), one_level.view(torch.int32))
        log(f"phase3 composed dv1_lifted_{lift}: {kc.divergent_instance(la.plan)}, bit-equal to "
            f"DV1's one-level launch {same}")
        assert same, lift
    edge_cams = [as_edges32(torch, c) for c in cams]
    ids, ops = divergent_nested_cases(cvgs, edge_cams, nv12_cams, sensor, chain=False)[
        "dvn1_top_views_beside_letterboxes"]
    seqs = tuple(cvgs.build_operation_sequence(*o) for o in ops)
    ea = kc.prepare(seqs, kc.build_divergent_plan(seqs, ids), dev)
    got, want = kc.composed(ea), kc.composed_reference(ea)
    torch.cuda.synchronize()
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    sub = int(((got != 0) & (got.abs() < 2.0 ** -126)).sum())
    log(f"phase3 composed dvn1_edges_f32: {got.numel()} float32 outputs, {sub} subnormal, {bad} "
        "differ from the plain version as int32 bits")
    assert bad == 0 and sub > 0, (bad, sub)
    case_err["dvn1_edges_f32"] = 0.0
    del edge_cams
    # the split batches DK1-DK4 at full width and the split kernel's other
    # composed forms and output types: neither the divergent kernel nor the
    # composed kernel's divergent plan takes one alone; one launch each of
    # the split kernel, each plane's part from K6's table, equal to the plain
    # version (the eager merge on the card, max |diff| 0)
    split_ring = torch.from_numpy(rng.integers(0, 256, (SPLIT_RING[0], SPLIT_RING[1], SPLIT_RING[1],
                                                        3), dtype=np.uint8)).to(dev)
    split_stack = torch.from_numpy(rng.integers(0, 256, (*SPLIT_STACK, 3), dtype=np.uint8)).to(dev)
    for name, (ids, ops) in {
            **split_cases(cvgs, cams, split_ring, frame, split_stack, sensor, nv12_cams),
            **split_form_cases(cvgs, torch, cams, split_ring, frame)}.items():
        seqs = tuple(cvgs.build_operation_sequence(*o) for o in ops)
        refused = []
        for module, build in ((kd, kd.build_plan), (kc, kc.build_divergent_plan)):
            try:
                build(seqs, ids)
            except module.Unsupported as e:
                refused.append(str(e))
            else:
                raise AssertionError(f"{name}: {module.__name__} takes it")
        sa = ks.prepare(seqs, ks.build_split_plan(seqs, ids), dev)
        before = ks.LAUNCHES
        got = ks.divergent_split(sa)
        launched = ks.LAUNCHES - before
        compare(name, "divergent_split", got, ks.split_reference(sa), 0.0)
        plan = sa.plan
        assert launched == 1, (name, launched)
        k6_groups = [(g.sid, g.kind, str(g.src_dtype)[6:]) for g in plan.k6.groups]
        cm_groups = [(g.sid, g.plan.core, g.plan.core2 or "-", str(g.plan.src_dtype)[6:])
                     for g in plan.composed.groups]
        log(f"phase3 divergent_split {name}: {plan.n_planes} planes of {plan.dsize[0]}x"
            f"{plan.dsize[1]} {plan.out_dtype}, parts {plan.parts.tolist()}, K6's groups (sid, "
            f"kind, source) {k6_groups}, the composed part's (sid, core, core2, source) "
            f"{cm_groups}, form {plan.form}, instance {ks.instance(plan)}, {plan.consts.size} "
            f"consts words, {sa.block.numel()} block words; refused alone: {refused[0]}; "
            f"{refused[1]}")
    # a resize of a crop that overhangs its frame, as the reference's
    # op-by-op lowering reads it (tests/test_torch_overhanging_crops.py):
    # each kernel against its plain version at full width
    for name, ops in overhang_cases(cvgs, frame, hd, cams[0]).items():
        plan = check(name, *ops, kernel="batch_resize" if "k1" in name else "composed", tol=0.0)
        if "mixed" in name:
            assert plan.word("batch") == kc.MIXED, name
    flush = (cvgs.multiply(1.0), cvgs.subtract((1e-40, 0.0, -2e-39)), cvgs.divide(1e38))
    for tag, src in (("u16", as_dtype(torch, frame, "u16")), ("f16", as_dtype(torch, frame, "f16")),
                     ("f64", as_float64(torch, frame)), ("sub_f32", as_edges32(torch, frame))):
        ops = composed_cases(cvgs, src, hd, nv12)["c1_roi_crop_resize"]
        if tag == "sub_f32":
            ops = (ops[0], *flush, ops[-1])
        pipeline = cvgs.build_pipeline(*ops)
        a = kc.prepare(pipeline, kc.build_plan(pipeline), dev)
        before = kc.LAUNCHES
        got, want = kc.composed(a), kc.composed_reference(a)
        launched = kc.LAUNCHES - before
        eager = cvgs.execute_operations(*ops, backend=cvgs.ParBackend.TORCH)
        torch.cuda.synchronize()
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        bad_eager = int((got.view(torch.int32) != eager.view(torch.int32)).sum())
        zeros = int((got == 0).sum())
        sub = int(((got != 0) & (got.abs() < 2.0 ** -126)).sum())
        log(f"phase3 composed c1_src_{tag}: {a.srcs[0].dtype} source, {got.numel()} float32 "
            f"outputs, {bad} differ from the plain version and {bad_eager} from the eager path "
            f"as int32 bits, {zeros} are 0, {sub} subnormal; launches {launched}")
        if bad or bad_eager or sub or launched != 1 or (tag == "sub_f32" and not zeros):
            raise AssertionError(f"c1_src_{tag}: {bad} bits differ from the plain version, "
                                 f"{bad_eager} from the eager path, {zeros} zeros, {sub} "
                                 "subnormals")
        case_err[f"c1_src_{tag}"] = 0.0

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

    # D1S: D1's pair of sequences over the last 8 frames of a 16-bit 1080p RGB
    # camera (99.5 MB read, 199 MB of float32 written) through K6's general
    # instance: twice under AUTO and twice under ParBackend.CUDA, one launch
    # of cuda:divergent a call, a new first building no plan, the last call
    # bit for bit the eager merge
    ring16 = d1s_ring(torch, dev)
    kd.LAUNCHES = 0
    d1s_seen = []
    for backend, first in ((cvgs.ParBackend.AUTO, 3), (cvgs.ParBackend.AUTO, -5),
                           (cvgs.ParBackend.CUDA, 1), (cvgs.ParBackend.CUDA, -2)):
        ids_s, seqs_s = rows.d1(first, ring16)
        builds0, launches0 = executor.PLAN_BUILDS, kd.LAUNCHES
        out_s = drive("divergent", lambda: cvgs.launch_divergent_batch(ids_s, *seqs_s,
                                                                       backend=backend))
        d1s_seen.append((cvgs.last_backend(), kd.LAUNCHES - launches0,
                         executor.PLAN_BUILDS - builds0))
        assert tuple(out_s.shape) == D1S_RING and out_s.dtype == torch.float32, out_s.shape
    torch.cuda.synchronize()
    divergent_launches += kd.LAUNCHES
    eager = cvgs.launch_divergent_batch(ids_s, *seqs_s, backend=cvgs.ParBackend.TORCH)
    same = torch.equal(out_s.view(torch.int32), eager.view(torch.int32))
    d1s_err = float((out_s - eager).abs().max())
    log(f"phase4 divergent path (D1S, a 16-bit ring of {D1S_RING}): (backend, launches, plans "
        f"built) per call {d1s_seen}; finite {bool(torch.isfinite(out_s).all())}; equal to the "
        f"eager merge bit for bit {same}")
    assert [b for b, _, _ in d1s_seen] == ["cuda:divergent"] * 4, d1s_seen
    assert [n for _, n, _ in d1s_seen] == [1] * 4, d1s_seen
    assert d1s_seen[1][2] == 0 and d1s_seen[3][2] == 0, d1s_seen
    assert same and bool(torch.isfinite(out_s).all())
    del out_s, eager

    # every source dtype of K6's general instance on the main path: D1, D3
    # and D4 of each twice through launch_divergent_batch (a new first,
    # shifted rects, new matrices), one launch of cuda:divergent a call, no
    # plan on the second, equal to the eager merge bit for bit
    kd.LAUNCHES = 0
    k6_path = {}
    for s in K6_DTYPES:
        r = rows.cast(lambda u8, s=s: as_k6_source(torch, u8, s))
        makes = {"d1": lambda k, r=r: r.d1((3, -5)[k]),
                 "d3": lambda k, r=r: r.d3(r.d3_rects((0, 7)[k])),
                 "d4": lambda k, r=r: r.d4((-14.0, -12.0)[k])}
        for row, make in makes.items():
            seen, outs = [], []
            for k in (0, 1):
                ids_k, seqs_k = make(k)
                builds0, launches0 = executor.PLAN_BUILDS, kd.LAUNCHES
                outs.append(drive("divergent",
                                  lambda: cvgs.launch_divergent_batch(ids_k, *seqs_k)))
                seen.append((cvgs.last_backend(), kd.LAUNCHES - launches0,
                             executor.PLAN_BUILDS - builds0))
            eager = cvgs.launch_divergent_batch(ids_k, *seqs_k, backend=cvgs.ParBackend.TORCH)
            torch.cuda.synchronize()
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[eager.element_size()]
            same = torch.equal(outs[1].view(bits), eager.view(bits))
            k6_path[f"{s}_{row}"] = seen
            assert [b for b, _, _ in seen] == ["cuda:divergent"] * 2, (s, row, seen)
            assert [n for _, n, _ in seen] == [1, 1] and seen[1][2] == 0, (s, row, seen)
            assert same and not torch.equal(outs[0].view(bits), outs[1].view(bits)), (s, row)
    divergent_launches += kd.LAUNCHES
    log(f"phase4 divergent paths of every K6 source dtype ({', '.join(K6_DTYPES)}: D1, D3, D4 "
        f"twice each): (backend, launches, plans built) per call {k6_path}; each second call "
        f"equal to the eager merge bit for bit")

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

    # the composed path: C1-C8 twice each through execute_operations, the
    # second call with new crop origins, a new matrix and a new border value;
    # one launch of cuda:composed per call (the count set to 0 just before),
    # no plan on the second, equal to the eager version on the card bit for
    # bit, finite
    composed_launches = 0
    for name in composed_cases(cvgs, frame, hd, nv12):
        kc.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        outs, backends, seen = [], [], []
        for values in (0, 1):
            ops = composed_cases(cvgs, frame, hd, nv12, values)[name]
            outs.append(drive("composed", lambda: cvgs.execute_operations(*ops)))
            backends.append(cvgs.last_backend())
            seen.append((kc.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        composed_launches += kc.LAUNCHES
        ops1 = composed_cases(cvgs, frame, hd, nv12, 1)[name]
        forced = cvgs.describe_backend(*ops1, backend=cvgs.ParBackend.CUDA)
        eager = cvgs.execute_operations(*ops1, backend=cvgs.ParBackend.TORCH)
        same = torch.equal(outs[1].view(torch.int32), eager.view(torch.int32))
        moved = not torch.equal(outs[0], outs[1])
        log(f"phase4 composed path ({name}): backends {backends}, under ParBackend.CUDA {forced}; "
            f"launches {seen[0][0]} {seen[1][0]}; plan builds {builds0} -> {seen[0][1]} -> "
            f"{seen[1][1]}; {tuple(outs[1].shape)} {outs[1].dtype}; equal to eager torch {same}; "
            f"new values moved the output {moved}")
        assert backends == ["cuda:composed"] * 2 and forced == "cuda:composed", (backends, forced)
        assert (seen[0][0], seen[1][0]) == (1, 2), seen
        assert seen[0][1] <= builds0 + 1 and seen[1][1] == seen[0][1], (builds0, seen)
        assert same and bool(torch.isfinite(outs[1]).all())
        assert moved == (name[:2] in ("c1", "c3", "c4", "c6", "c7")), (name, moved)

    # the batches B1-B7 twice each through execute_operations, the second
    # call with new camera frames and new origins, angles, border value and
    # used_planes: one launch of cuda:composed per call (the count set to 0
    # just before), no plan on the second, bit for bit the eager version on
    # the card, finite; B1 against an independent float64 resize of each
    # camera, as the flagship is held
    cams_next = [torch.from_numpy(rng.integers(0, 256, (FRAME_H, FRAME_W, 3), dtype=np.uint8))
                 .to(dev) for _ in range(CAMERAS)]
    for name in batch_cases(cvgs, cams, frame):
        kc.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        outs, backends, seen = [], [], []
        for values, frames in ((0, cams), (1, cams_next)):
            ops = batch_cases(cvgs, frames, frame, values)[name]
            outs.append(drive("composed", lambda: cvgs.execute_operations(*ops)))
            backends.append(cvgs.last_backend())
            seen.append((kc.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        composed_launches += kc.LAUNCHES
        ops1 = batch_cases(cvgs, cams_next, frame, 1)[name]
        forced = cvgs.describe_backend(*ops1, backend=cvgs.ParBackend.CUDA)
        eager = cvgs.execute_operations(*ops1, backend=cvgs.ParBackend.TORCH)
        same = torch.equal(outs[1].view(torch.int32), eager.view(torch.int32))
        log(f"phase4 composed path ({name}): backends {backends}, under ParBackend.CUDA {forced}; "
            f"launches {seen[0][0]} {seen[1][0]}; plan builds {builds0} -> {seen[0][1]} -> "
            f"{seen[1][1]}; {tuple(outs[1].shape)} {outs[1].dtype}; equal to eager torch {same}")
        assert backends == ["cuda:composed"] * 2 and forced == "cuda:composed", (backends, forced)
        assert (seen[0][0], seen[1][0]) == (1, 2), seen
        assert seen[0][1] <= builds0 + 1 and seen[1][1] == seen[0][1], (builds0, seen)
        assert same and bool(torch.isfinite(outs[1]).all()) and not torch.equal(outs[0], outs[1])
        if name == "b1_cameras_resized":
            got = outs[0].double().cpu().numpy()
            b1_err = max(float(np.abs(got[k] - oracle_frame(cams_np[k], *FRAME_DST)).max())
                         for k in range(CAMERAS))
            log(f"phase4 composed path ({name}): max|diff| vs a float64 resize of each camera "
                f"{b1_err!r}")
            assert b1_err <= ORACLE_TOL, b1_err

    # the mixed-geometry batches M1-M5 twice each through
    # execute_operations, the second call with new frames of the same sizes
    # and new used_planes, origins, angles and border value: one launch of
    # cuda:composed per call (the count set to 0 just before), no plan on
    # the second, bit for bit the eager version on the card, finite; M1
    # against an independent float64 resize of each camera
    m_cams_next = [torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
                   for h, w in M_CAMERAS]
    m_nv12_next = [torch.from_numpy(rng.integers(0, 256, (h * 3 // 2, w), dtype=np.uint8))
                   .to(dev) for h, w in M5_NV12]
    for name in mixed_cases(cvgs, m_cams, frame, m_nv12):
        kc.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        outs, backends, seen = [], [], []
        for values, frames, bufs in ((0, m_cams, m_nv12), (1, m_cams_next, m_nv12_next)):
            ops = mixed_cases(cvgs, frames, frame, bufs, values)[name]
            outs.append(drive("composed", lambda: cvgs.execute_operations(*ops)))
            backends.append(cvgs.last_backend())
            seen.append((kc.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        composed_launches += kc.LAUNCHES
        ops1 = mixed_cases(cvgs, m_cams_next, frame, m_nv12_next, 1)[name]
        forced = cvgs.describe_backend(*ops1, backend=cvgs.ParBackend.CUDA)
        eager = cvgs.execute_operations(*ops1, backend=cvgs.ParBackend.TORCH)
        same = torch.equal(outs[1].view(torch.int32), eager.view(torch.int32)) \
            if outs[1].dtype == torch.float32 else torch.equal(outs[1], eager)
        log(f"phase4 composed path ({name}): backends {backends}, under ParBackend.CUDA {forced}; "
            f"launches {seen[0][0]} {seen[1][0]}; plan builds {builds0} -> {seen[0][1]} -> "
            f"{seen[1][1]}; {tuple(outs[1].shape)} {outs[1].dtype}; equal to eager torch {same}")
        assert backends == ["cuda:composed"] * 2 and forced == "cuda:composed", (backends, forced)
        assert (seen[0][0], seen[1][0]) == (1, 2), seen
        assert seen[0][1] <= builds0 + 1 and seen[1][1] == seen[0][1], (builds0, seen)
        assert same and not torch.equal(outs[0], outs[1])
        assert outs[1].dtype != torch.float32 or bool(torch.isfinite(outs[1]).all())
        if name == "m1_cameras_of_3_sizes_resized":
            got = outs[0].double().cpu().numpy()
            m1_err = max(float(np.abs(got[k] - oracle_frame(m_cams_np[k], *FRAME_DST)).max())
                         for k in range(len(M_CAMERAS)))
            log(f"phase4 composed path ({name}): max|diff| vs a float64 resize of each camera "
                f"{m1_err!r}")
            assert m1_err <= ORACLE_TOL, m1_err

    # the nested cases N1-N6 twice each through execute_operations, the
    # second call with new maps, a new crop origin, border value and
    # used_planes (N6 also new camera frames): one launch of cuda:composed
    # per call (the count set to 0 just before), no plan on the second, bit
    # for bit the eager version on the card, finite
    for name in nested_cases(cvgs, frame, hd, cams):
        kc.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        outs, backends, seen = [], [], []
        for values, frames in ((0, cams), (1, cams_next)):
            ops = nested_cases(cvgs, frame, hd, frames, values)[name]
            outs.append(drive("composed", lambda: cvgs.execute_operations(*ops)))
            backends.append(cvgs.last_backend())
            seen.append((kc.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        composed_launches += kc.LAUNCHES
        ops1 = nested_cases(cvgs, frame, hd, cams_next, 1)[name]
        forced = cvgs.describe_backend(*ops1, backend=cvgs.ParBackend.CUDA)
        eager = cvgs.execute_operations(*ops1, backend=cvgs.ParBackend.TORCH)
        same = torch.equal(outs[1].view(torch.int32), eager.view(torch.int32))
        moved = not torch.equal(outs[0], outs[1])
        log(f"phase4 composed path ({name}): backends {backends}, under ParBackend.CUDA {forced}; "
            f"launches {seen[0][0]} {seen[1][0]}; plan builds {builds0} -> {seen[0][1]} -> "
            f"{seen[1][1]}; {tuple(outs[1].shape)} {outs[1].dtype}; equal to eager torch {same}; "
            f"new values moved the output {moved}")
        assert backends == ["cuda:composed"] * 2 and forced == "cuda:composed", (backends, forced)
        assert (seen[0][0], seen[1][0]) == (1, 2), seen
        assert seen[0][1] <= builds0 + 1 and seen[1][1] == seen[0][1], (builds0, seen)
        assert same and bool(torch.isfinite(outs[1]).all())
        assert moved == (name[:2] != "n3"), (name, moved)

    # the batches of nested planes of their own geometry NM1-NM4 twice each
    # through execute_operations, the second call with new frames of the
    # same sizes and new maps, origins, angles, border value and
    # used_planes: one launch of cuda:composed per call (the count set to 0
    # just before), no plan on the second, bit for bit the eager version on
    # the card, finite
    for name in nested_mixed_cases(cvgs, m_cams, frame):
        kc.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        outs, backends, seen = [], [], []
        for values, frames in ((0, m_cams), (1, m_cams_next)):
            ops = nested_mixed_cases(cvgs, frames, frame, values)[name]
            outs.append(drive("composed", lambda: cvgs.execute_operations(*ops)))
            backends.append(cvgs.last_backend())
            seen.append((kc.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        composed_launches += kc.LAUNCHES
        ops1 = nested_mixed_cases(cvgs, m_cams_next, frame, 1)[name]
        forced = cvgs.describe_backend(*ops1, backend=cvgs.ParBackend.CUDA)
        eager = cvgs.execute_operations(*ops1, backend=cvgs.ParBackend.TORCH)
        same = torch.equal(outs[1].view(torch.int32), eager.view(torch.int32))
        log(f"phase4 composed path ({name}): backends {backends}, under ParBackend.CUDA {forced}; "
            f"launches {seen[0][0]} {seen[1][0]}; plan builds {builds0} -> {seen[0][1]} -> "
            f"{seen[1][1]}; {tuple(outs[1].shape)} {outs[1].dtype}; equal to eager torch {same}")
        assert backends == ["cuda:composed"] * 2 and forced == "cuda:composed", (backends, forced)
        assert (seen[0][0], seen[1][0]) == (1, 2), seen
        assert seen[0][1] <= builds0 + 1 and seen[1][1] == seen[0][1], (builds0, seen)
        assert same and bool(torch.isfinite(outs[1]).all()) and not torch.equal(outs[0], outs[1])

    # the divergent batches DV1-DV4 twice each through launch_divergent_batch,
    # the second call with new camera frames and a new sensor frame of the
    # same sizes, new origins, angles, border value and used_planes: one
    # launch of the composed kernel per call (the counts set to 0 just
    # before), none of the divergent kernel, cuda:composed:divergent, no
    # plan on the second, bit for bit the eager merge on the card, finite
    cams43_next = [torch.from_numpy(rng.integers(0, 256, (*DV_CAMERA, 3), dtype=np.uint8))
                   .to(dev) for _ in range(CAMERAS)]
    sensor_next = torch.from_numpy(rng.integers(0, 4096, (*DV_SENSOR, 3)).astype(np.uint16)
                                   ).to(dev)
    for name in divergent_composed_cases(cvgs, cams, cams43, frame, sensor):
        kc.LAUNCHES, kd.LAUNCHES = 0, 0
        builds0 = executor.PLAN_BUILDS
        outs, backends, seen = [], [], []
        for values, frames, frames43, sens in ((0, cams, cams43, sensor),
                                               (1, cams_next, cams43_next, sensor_next)):
            ids, ops = divergent_composed_cases(cvgs, frames, frames43, frame, sens, values)[name]
            seqs = tuple(cvgs.build_operation_sequence(*o) for o in ops)
            outs.append(drive("composed", lambda: cvgs.launch_divergent_batch(ids, *seqs)))
            backends.append(cvgs.last_backend())
            seen.append((kc.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        composed_launches += kc.LAUNCHES
        forced = cvgs.launch_divergent_batch(ids, *seqs, backend=cvgs.ParBackend.CUDA)
        forced_backend = cvgs.last_backend()
        eager = cvgs.launch_divergent_batch(ids, *seqs, backend=cvgs.ParBackend.TORCH)
        got = outs[1] if isinstance(outs[1], tuple) else (outs[1],)
        want = eager if isinstance(eager, tuple) else (eager,)
        same = all(g.dtype == w.dtype and torch.equal(
            g.view(torch.int32) if g.dtype == torch.float32 else g,
            w.view(torch.int32) if w.dtype == torch.float32 else w) for g, w in zip(got, want))
        log(f"phase4 composed divergent path ({name}): backends {backends}, under "
            f"ParBackend.CUDA {forced_backend}; composed launches {seen[0][0]} {seen[1][0]}, "
            f"divergent kernel launches {kd.LAUNCHES}; plan builds {builds0} -> {seen[0][1]} -> "
            f"{seen[1][1]}; {tuple(got[0].shape)} {got[0].dtype}; equal to the eager merge {same}")
        assert backends == ["cuda:composed:divergent"] * 2, backends
        assert forced_backend == "cuda:composed:divergent" and torch.equal(
            forced if not isinstance(forced, tuple) else forced[0], got[0])
        assert (seen[0][0], seen[1][0]) == (1, 2) and kd.LAUNCHES == 0, (seen, kd.LAUNCHES)
        assert seen[0][1] <= builds0 + 1 and seen[1][1] == seen[0][1], (builds0, seen)
        assert same and not torch.equal(got[0], outs[0] if not isinstance(outs[0], tuple)
                                        else outs[0][0])
        assert got[0].dtype != torch.float32 or all(bool(torch.isfinite(g).all()) for g in got)

    # the divergent batches with a nested group DVN1-DVN4 the same way: twice
    # each through launch_divergent_batch, the second call with new camera,
    # NV12 and sensor frames of the same sizes and new maps, angles, origins,
    # border values and used_planes: cuda:composed:divergent, one launch of
    # the composed kernel per call (the counts set to 0 just before), none of
    # the divergent kernel, no plan on the second, bit for bit the eager merge
    nv12_next = [torch.from_numpy(rng.integers(0, 256, (FRAME_H * 3 // 2, FRAME_W),
                                               dtype=np.uint8)).to(dev) for _ in range(CAMERAS)]
    for name in divergent_nested_cases(cvgs, cams, nv12_cams, sensor):
        kc.LAUNCHES, kd.LAUNCHES = 0, 0
        builds0 = executor.PLAN_BUILDS
        outs, backends, seen = [], [], []
        for values, frames, bufs, sens in ((0, cams, nv12_cams, sensor),
                                           (1, cams_next, nv12_next, sensor_next)):
            ids, ops = divergent_nested_cases(cvgs, frames, bufs, sens, values)[name]
            seqs = tuple(cvgs.build_operation_sequence(*o) for o in ops)
            outs.append(drive("composed", lambda: cvgs.launch_divergent_batch(ids, *seqs)))
            backends.append(cvgs.last_backend())
            seen.append((kc.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        composed_launches += kc.LAUNCHES
        eager = cvgs.launch_divergent_batch(ids, *seqs, backend=cvgs.ParBackend.TORCH)
        same = torch.equal(outs[1].view(torch.int32), eager.view(torch.int32))
        log(f"phase4 composed divergent path ({name}): backends {backends}; composed launches "
            f"{seen[0][0]} {seen[1][0]}, divergent kernel launches {kd.LAUNCHES}; plan builds "
            f"{builds0} -> {seen[0][1]} -> {seen[1][1]}; {tuple(outs[1].shape)} {outs[1].dtype}; "
            f"equal to the eager merge {same}")
        assert backends == ["cuda:composed:divergent"] * 2, backends
        assert (seen[0][0], seen[1][0]) == (1, 2) and kd.LAUNCHES == 0, (seen, kd.LAUNCHES)
        assert seen[0][1] <= builds0 + 1 and seen[1][1] == seen[0][1], (builds0, seen)
        assert same and not torch.equal(outs[0], outs[1]) and bool(torch.isfinite(outs[1]).all())

    # the split batches DK1-DK4 twice each through launch_divergent_batch, the
    # second call with new camera, NV12 and sensor frames, a new ring and
    # stack of the same sizes, and a new first, rects, matrices, origins and
    # border value: cuda:divergent:split, one launch of the split kernel per
    # call (the counts set to 0 just before), none of the divergent or the
    # composed kernel, no plan on the second, bit for bit the eager merge on
    # the card, finite
    split_launches = 0
    ring_next = torch.from_numpy(rng.integers(0, 256, tuple(split_ring.shape), dtype=np.uint8)
                                 ).to(dev)
    stack_next = torch.from_numpy(rng.integers(0, 256, tuple(split_stack.shape), dtype=np.uint8)
                                  ).to(dev)
    for name in split_cases(cvgs, cams, split_ring, frame, split_stack, sensor, nv12_cams):
        ks.LAUNCHES, kd.LAUNCHES, kc.LAUNCHES = 0, 0, 0
        builds0 = executor.PLAN_BUILDS
        outs, backends, seen = [], [], []
        for values, frames, rg, st, sens, bufs in (
                (0, cams, split_ring, split_stack, sensor, nv12_cams),
                (1, cams_next, ring_next, stack_next, sensor_next, nv12_next)):
            ids, ops = split_cases(cvgs, frames, rg, frame, st, sens, bufs, values)[name]
            seqs = tuple(cvgs.build_operation_sequence(*o) for o in ops)
            outs.append(drive("divergent_split", lambda: cvgs.launch_divergent_batch(ids, *seqs)))
            backends.append(cvgs.last_backend())
            seen.append((ks.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        split_launches += ks.LAUNCHES
        others = kd.LAUNCHES + kc.LAUNCHES
        eager = cvgs.launch_divergent_batch(ids, *seqs, backend=cvgs.ParBackend.TORCH)
        same = torch.equal(outs[1].view(torch.int32), eager.view(torch.int32))
        log(f"phase4 split divergent path ({name}): backends {backends}; split launches "
            f"{seen[0][0]} {seen[1][0]}, divergent and composed kernel launches {others}; plan "
            f"builds {builds0} -> {seen[0][1]} -> {seen[1][1]}; {tuple(outs[1].shape)} "
            f"{outs[1].dtype}; equal to the eager merge {same}")
        assert backends == ["cuda:divergent:split"] * 2, backends
        assert (seen[0][0], seen[1][0]) == (1, 2) and others == 0, (seen, others)
        assert seen[0][1] <= builds0 + 1 and seen[1][1] == seen[0][1], (builds0, seen)
        assert same and not torch.equal(outs[0], outs[1]) and bool(torch.isfinite(outs[1]).all())
    del ring_next, stack_next

    # 64-bit values are int32 and float32 where they enter, as in the
    # reference (64-bit values off): an int64 or a float64 frame on the card
    # is one launch of the pointwise kernel, which reads it at load; a float64
    # host frame is converted before its copy; each equals the plain version
    # bit for bit. A saturating cast to int64 raises, as the reference's call.
    for what, src in (("int64 source", as_int64(torch, hd)),
                      ("float64 source", as_float64(torch, hd)),
                      ("float64 host frame", as_float64(torch, hd).cpu().numpy())):
        ops = (cvgs.image(src), cvgs.multiply(2.0), cvgs.write())
        cvgs.execute_operations(*ops)  # its plan
        kp.LAUNCHES, builds0 = 0, executor.PLAN_BUILDS
        got = drive("pointwise", lambda: cvgs.execute_operations(*ops))
        backend, launched = cvgs.last_backend(), kp.LAUNCHES
        pointwise_launches += launched
        pipe = cvgs.build_pipeline(*ops)
        a = kp.prepare(pipe, kp.build_plan(pipe), dev)
        want = kp.pointwise_reference(a)
        torch.cuda.synchronize()
        same = got.dtype == want.dtype and torch.equal(got.view(torch.int32),
                                                        want.view(torch.int32))
        log(f"phase4 64-bit path ({what}): backend {backend}, launches {launched}, plan builds "
            f"{executor.PLAN_BUILDS - builds0}, source read as {a.plan.src_dtype}, "
            f"{tuple(got.shape)} {got.dtype}; equal to the plain version bit for bit {same}")
        assert backend == "cuda:pointwise" and launched == 1, (what, backend, launched)
        assert executor.PLAN_BUILDS == builds0 and same, what
        assert got.dtype == (torch.int32 if what.startswith("int64") else torch.float32), what
    try:
        cvgs.convert_to(np.int64, alpha=1000.0)
    except OverflowError as e:
        log(f"phase4 convert_to(np.int64) raises OverflowError, as the reference's call: {e}")
    else:
        raise AssertionError("convert_to(np.int64) did not raise")

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

    # every dtype on the main paths, through the public entry points twice
    # each with new values: the flagship on a 12-bit uint16 frame into
    # float16 planes, frame (a) into float16, W6 into float16, D1 into an
    # int16 batch; each call one launch of its kernel, no plan on the
    # second, equal to the eager version bit for bit
    frames_12bit = [(frame.to(torch.int32) * 4095 // 255).to(torch.uint16),
                    (torch.roll(frame, 5, dims=1).to(torch.int32) * 4095 // 255).to(torch.uint16)]
    # int32 at full width: a 32-bit label or depth map of the flagship's 4K
    # frame into float32 planes, frame (a) on a 1080p int32 image, W6 into
    # int32 planes, D1 into an int32 batch, a 1080p int32 image through a
    # crop and a border, unchanged (values past 2^24 and near int32's bounds)
    frames_i32 = [as_int32(torch, frame), as_int32(torch, torch.roll(frame, 5, dims=1))]
    hds_i32 = [as_int32(torch, hd), as_int32(torch, hd2)]
    crop_i32 = cvgs.Rect(-1600, 100, 1600, 900)
    # 64-bit tensors on the card, read at load: the flagship on a 4K float64
    # frame, frame (a) on a 1080p int64 image, W6 on a float64 frame, D1 on a
    # float64 ring, a float64 1080p image through a crop and a border
    frames_f64 = [as_float64(torch, frame), as_float64(torch, torch.roll(frame, 5, dims=1))]
    hds_i64 = [as_int64(torch, hd), as_int64(torch, hd2)]
    hds_f64 = [as_float64(torch, hd), as_float64(torch, hd2)]
    shared_f64 = cvgs.image(hds_f64[0])
    rings_f64 = [as_float64(torch, ring), as_float64(torch, torch.roll(ring, 1, dims=2))]

    def dtype_path_ops(k):
        """The dtype paths' ops with the values of call ``k`` (0 or 1)."""
        f16, seq = np.float16, cvgs.build_operation_sequence
        d1_read = cvgs.circular_batch_read(ring, first=(3, -5)[k])
        return {
            "flagship_u16_12bit_to_f16": ("batch_resize", (
                cvgs.resize_batch(frames_12bit[k], rects=(rects_a, shifted)[k], dsize=dsize),
                cvgs.convert_to(f16, alpha=1 / 4095.0), cvgs.subtract(MEAN), cvgs.divide(STD),
                cvgs.split_tensor())),
            "frame_a_to_f16": ("frame_resize", (
                cvgs.resize(cvgs.image((hd, hd2)[k]), cvgs.Size(*FRAME_DST)),
                cvgs.convert_to(f16, alpha=1 / 255.0), cvgs.subtract(MEAN), cvgs.divide(STD),
                cvgs.split_tensor())),
            "w6_to_f16": ("warp", warp_batch_ops(cvgs, shared, (-10.0, -7.0)[k], (7, 6)[k])[:1]
                          + (cvgs.convert_to(f16, alpha=1 / 255.0), cvgs.split_tensor())),
            "d1_into_int16": ("divergent", ([1, 2] * 8, (
                seq(d1_read, cvgs.convert_to(np.int16, alpha=(100.0, 90.0)[k]),
                    cvgs.subtract(12000.5), cvgs.write_tensor()),
                seq(d1_read, cvgs.convert_to(np.float32, alpha=-50.0), cvgs.write_tensor())))),
            "flagship_i32_to_f32": ("batch_resize", (
                cvgs.resize_batch(frames_i32[k], rects=(rects_a, shifted)[k], dsize=dsize),
                cvgs.convert_to(np.float32, alpha=2.0 ** -31), cvgs.subtract(MEAN),
                cvgs.divide(STD), cvgs.split_tensor())),
            "frame_a_i32_to_f32": ("frame_resize", (
                cvgs.resize(cvgs.image(hds_i32[k]), cvgs.Size(*FRAME_DST)),
                cvgs.convert_to(np.float32, alpha=2.0 ** -31), cvgs.subtract(MEAN),
                cvgs.divide(STD), cvgs.split_tensor())),
            "w6_into_i32": ("warp", warp_batch_ops(cvgs, shared, (-10.0, -7.0)[k], (7, 6)[k])[:1]
                            + (cvgs.convert_to(np.int32, alpha=1e7), cvgs.add(-1e9),
                               cvgs.split_tensor())),
            "d1_into_i32": ("divergent", ([1, 2] * 8, (
                seq(d1_read, cvgs.convert_to(np.int32, alpha=(1e7, 9e6)[k]), cvgs.add(-1e9),
                    cvgs.write_tensor()),
                seq(d1_read, cvgs.convert_to(np.float32, alpha=-3e7), cvgs.write_tensor())))),
            "crop_border_i32_unchanged": ("pointwise", (
                cvgs.make_border(cvgs.crop(cvgs.image(hds_i32[k]), crop_i32), BORDER, BORDER,
                                 BORDER, BORDER, cvgs.BorderMode.CONSTANT, value=(3e9, -9.0, 0.5)),
                cvgs.write())),
            "flagship_f64_to_f32": ("batch_resize", (
                cvgs.resize_batch(frames_f64[k], rects=(rects_a, shifted)[k], dsize=dsize),
                cvgs.multiply(1 / 255.0), cvgs.subtract(MEAN), cvgs.divide(STD),
                cvgs.split_tensor())),
            "frame_a_i64_to_f32": ("frame_resize", (
                cvgs.resize(cvgs.image(hds_i64[k]), cvgs.Size(*FRAME_DST)),
                cvgs.convert_to(np.float32, alpha=2.0 ** -31), cvgs.subtract(MEAN),
                cvgs.divide(STD), cvgs.split_tensor())),
            "w6_f64_to_f32": ("warp", warp_batch_ops(cvgs, shared_f64, (-10.0, -7.0)[k],
                                                     (7, 6)[k])[:1]
                              + (cvgs.multiply(1 / 255.0), cvgs.split_tensor())),
            "d1_f64_ring": ("divergent", ([1, 2] * 8, (
                seq(cvgs.circular_batch_read(rings_f64[k], first=(3, -5)[k]),
                    cvgs.multiply(1 / 255.0), cvgs.subtract(MEAN), cvgs.write_tensor()),
                seq(cvgs.circular_batch_read(rings_f64[k], first=(3, -5)[k]),
                    cvgs.multiply(0.5), cvgs.write_tensor())))),
            "crop_border_f64": ("pointwise", (
                cvgs.make_border(cvgs.crop(cvgs.image(hds_f64[k]), crop_i32), BORDER, BORDER,
                                 BORDER, BORDER, cvgs.BorderMode.CONSTANT, value=(3e9, -9.0, 0.5)),
                cvgs.write())),
        }

    dtype_launches = {}
    for name, (kernel, _) in dtype_path_ops(0).items():
        module = kernels[kernel][0]
        module.LAUNCHES = 0
        builds0 = executor.PLAN_BUILDS
        outs, seen = [], []
        for k in (0, 1):
            ops = dtype_path_ops(k)[name][1]
            if kernel == "divergent":
                outs.append(drive(kernel, lambda: cvgs.launch_divergent_batch(ops[0], *ops[1])))
            else:
                outs.append(drive(kernel, lambda: cvgs.execute_operations(*ops)))
            seen.append((cvgs.last_backend(), module.LAUNCHES, executor.PLAN_BUILDS))
        torch.cuda.synchronize()
        if kernel == "divergent":
            eager = cvgs.launch_divergent_batch(ops[0], *ops[1], backend=cvgs.ParBackend.TORCH)
        else:
            eager = cvgs.execute_operations(*ops, backend=cvgs.ParBackend.TORCH)
        bits = torch.int16 if eager.element_size() == 2 else torch.uint8
        same = outs[1].dtype == eager.dtype and torch.equal(outs[1].view(bits), eager.view(bits))
        finite = not eager.dtype.is_floating_point or bool(torch.isfinite(outs[1]).all())
        dtype_launches[name] = module.LAUNCHES
        log(f"phase4 dtype path ({name}): backends {[b for b, _, _ in seen]}; launches "
            f"{[n for _, n, _ in seen]}; plan builds {builds0} -> {seen[0][2]} -> {seen[1][2]}; "
            f"{tuple(outs[1].shape)} {outs[1].dtype}, finite {finite}; equal to eager torch {same}")
        assert same and finite, name
        assert [b for b, _, _ in seen] == [f"cuda:{kernel}"] * 2, seen
        assert [n for _, n, _ in seen] == [1, 2], seen
        assert seen[0][2] <= builds0 + 1 and seen[1][2] == seen[0][2], (builds0, seen)
        assert not torch.equal(outs[0].view(torch.uint8), outs[1].view(torch.uint8)), name
        if name == "crop_border_i32_unchanged":  # the source's bits, past 2^24 too
            inner = outs[1][BORDER:-BORDER, BORDER:-BORDER]
            src = hds_i32[1][100:1000, 320:1920]
            edge = outs[1][0, 0]
            assert torch.equal(inner, src) and int(src.abs().max()) > 2 ** 24, name
            assert edge.tolist() == [2 ** 31 - 1, -9, 0], edge.tolist()
            log(f"phase4 dtype path ({name}): the crop inside the border equals the int32 source "
                f"bit for bit; the border holds {edge.tolist()} (3e9, -9.0, 0.5 cast to int32)")
        if name == "crop_border_f64":  # the source rounded to float32, nothing else
            inner = outs[1][BORDER:-BORDER, BORDER:-BORDER]
            src = hds_f64[1][100:1000, 320:1920].float()
            edge = outs[1][0, 0]
            assert torch.equal(inner.view(torch.int32), src.view(torch.int32)), name
            assert edge.tolist() == [3e9, -9.0, 0.5], edge.tolist()
            log(f"phase4 dtype path ({name}): the crop inside the border equals the float64 "
                f"source rounded to float32 bit for bit; the border holds {edge.tolist()}")
        if name in ("flagship_f64_to_f32", "frame_a_i64_to_f32", "w6_f64_to_f32", "d1_f64_ring",
                    "crop_border_f64"):
            assert outs[1].dtype == torch.float32, (name, outs[1].dtype)
    main_launches += (dtype_launches["flagship_u16_12bit_to_f16"]
                      + dtype_launches["flagship_i32_to_f32"]
                      + dtype_launches["flagship_f64_to_f32"])
    frame_launches += (dtype_launches["frame_a_to_f16"] + dtype_launches["frame_a_i32_to_f32"]
                       + dtype_launches["frame_a_i64_to_f32"])
    warp_launches += (dtype_launches["w6_to_f16"] + dtype_launches["w6_into_i32"]
                      + dtype_launches["w6_f64_to_f32"])
    divergent_launches += (dtype_launches["d1_into_int16"] + dtype_launches["d1_into_i32"]
                           + dtype_launches["d1_f64_ring"])
    pointwise_launches += (dtype_launches["crop_border_i32_unchanged"]
                           + dtype_launches["crop_border_f64"])

    # a CircularTensor of uint8 frames into a uint16 ring: 40 updates, each
    # one launch of the frame kernel storing into its slot (a widening
    # store), no plan after the first, no temporary
    ct16 = cvgs.CircularTensor(64, 128, 3, 32, dtype=np.uint16, device=dev)
    eager16 = torch.zeros(ct16.shape, dtype=torch.int32, device=dev)

    def ct16_ops(k):
        return (cvgs.resize(cvgs.image(torch.roll(hd, 7 * k, dims=1)), cvgs.Size(64, 128)),
                cvgs.convert_to(np.uint8, alpha=0.9, beta=3.0))

    kfr.LAUNCHES = 0
    ct16_new_plans, ct16_grown = 0, 0
    for k in range(40):
        ops = ct16_ops(k)  # the frame moved by 7k columns: made before the update is watched
        b0 = executor.PLAN_BUILDS
        torch.cuda.synchronize()
        allocated0 = torch.cuda.memory_stats(dev)["allocated_bytes.all.allocated"]
        drive("frame_resize", lambda: ct16.update(*ops))
        torch.cuda.synchronize()
        if k:
            ct16_new_plans += executor.PLAN_BUILDS - b0
            ct16_grown = max(ct16_grown, torch.cuda.memory_stats(dev)[
                "allocated_bytes.all.allocated"] - allocated0)
        assert cvgs.last_backend() == "cuda:frame_resize", cvgs.last_backend()
        x = cvgs.execute_operations(*ct16_ops(k), backend=cvgs.ParBackend.TORCH)
        eager16[k % 32].copy_(x.permute(2, 0, 1).to(torch.int32))
    ct16_launches = kfr.LAUNCHES
    frame_launches += ct16_launches
    perm = torch.tensor([(39 - z) % 32 for z in range(32)], device=dev)
    ct16_equal = torch.equal(ct16.tensor.to(torch.int32), eager16.index_select(0, perm))
    log(f"phase4 CircularTensor {ct16.shape} uint16 of uint8 frames: frame_resize launches "
        f"{ct16_launches} in 40 updates; plans built after the first update {ct16_new_plans}; "
        f"device bytes allocated by one update at most {ct16_grown} (one 128x64x3 uint16 plane "
        f"is {128 * 64 * 3 * 2}); every logical plane equal to the eager ring {ct16_equal}")
    assert ct16_launches == 40 and ct16_new_plans == 0 and ct16_equal, (
        ct16_launches, ct16_new_plans, ct16_equal)
    assert ct16_grown < 128 * 64 * 3, ct16_grown

    # an int32 CircularTensor of int32 1080p frames: 40 updates, each one
    # launch of the frame kernel storing its int32 chain into the slot, no
    # plan after the first, no temporary, equal to an eager ring bit for bit
    ct32 = cvgs.CircularTensor(64, 128, 3, 32, dtype=np.int32, device=dev)
    eager32 = torch.zeros(ct32.shape, dtype=torch.int32, device=dev)

    def ct32_ops(k):
        return (cvgs.resize(cvgs.image(torch.roll(hds_i32[0], 7 * k, dims=1)), cvgs.Size(64, 128)),
                cvgs.convert_to(np.int32), cvgs.add(-5.0))

    kfr.LAUNCHES = 0
    ct32_new_plans, ct32_grown = 0, 0
    for k in range(40):
        ops = ct32_ops(k)
        b0 = executor.PLAN_BUILDS
        torch.cuda.synchronize()
        allocated0 = torch.cuda.memory_stats(dev)["allocated_bytes.all.allocated"]
        drive("frame_resize", lambda: ct32.update(*ops))
        torch.cuda.synchronize()
        if k:
            ct32_new_plans += executor.PLAN_BUILDS - b0
            ct32_grown = max(ct32_grown, torch.cuda.memory_stats(dev)[
                "allocated_bytes.all.allocated"] - allocated0)
        assert cvgs.last_backend() == "cuda:frame_resize", cvgs.last_backend()
        x = cvgs.execute_operations(*ct32_ops(k), backend=cvgs.ParBackend.TORCH)
        eager32[k % 32].copy_(x.permute(2, 0, 1))
    ct32_launches = kfr.LAUNCHES
    frame_launches += ct32_launches
    ct32_equal = torch.equal(ct32.tensor, eager32.index_select(0, perm))
    log(f"phase4 CircularTensor {ct32.shape} int32 of int32 frames: frame_resize launches "
        f"{ct32_launches} in 40 updates; plans built after the first update {ct32_new_plans}; "
        f"device bytes allocated by one update at most {ct32_grown} (one 128x64x3 int32 plane "
        f"is {128 * 64 * 3 * 4}); every logical plane equal to the eager ring {ct32_equal}")
    assert ct32_launches == 40 and ct32_new_plans == 0 and ct32_equal, (
        ct32_launches, ct32_new_plans, ct32_equal)
    assert ct32_grown < 128 * 64 * 3, ct32_grown

    # ---- phase 5: times at the flagship shape
    def profiler_ms(fn, calls=20, what="a kernel", names=None):
        """``utils.profiling.profiler_ms``, its empty traces logged here."""
        return profiling.profiler_ms(fn, calls, what, log=lambda msg: log(f"phase5 {msg}"),
                                     names=names)

    def kernel_names(names):
        """Device kernels' names as ``torch.profiler`` records them, each
        its name and template arguments without namespaces."""
        short = set()
        for name in names:
            name = re.sub(r"\(anonymous namespace\)::|kc::", "", name)
            found = re.search(r"\w+<[^>]*>", name)
            short.add(found.group(0) if found else name)
        return ", ".join(sorted(short))

    def measure(kernel_fn, plain_fn, iters, what="a kernel", plain_iters=None, names=None):
        """Event medians of the kernel and its plain version, alternating
        plain, kernel, kernel, plain, and the kernel's profiler duration
        (the kernels it recorded collected into ``names``, where given)."""
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            runs[which] += time_cuda(kernel_fn if which == "kernel" else plain_fn,
                                     iters=iters if which == "kernel" else (plain_iters or iters))
        return {"ms": float(np.median(runs["kernel"])), "plain_ms": float(np.median(runs["plain"])),
                "profiler_ms": profiler_ms(kernel_fn, what=what, names=names)}

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


    # D1S, and D1, D3 and D4 on every source dtype of K6's general instance:
    # the kernel by events and by profiler (the instance it ran as the
    # profiler names it) beside the eager merge that ran these batches
    # before this kernel read their dtypes (ParBackend.TORCH, the plain
    # version) and the bound
    k6_times = {}
    timed_k6 = {"d1s_u16_1080p_ring": rows.d1(3, ring16)}
    for s in K6_DTYPES:
        timed_k6.update({f"dt_src_{s}_{row}": k6_cases[f"dt_src_{s}_{row}"]
                         for row in ("d1", "d3", "d4")})
    for name, (ids, seqs) in timed_k6.items():
        kargs = kd.prepare(seqs, kd.build_plan(seqs, ids), dev)
        names = set()
        t = measure(lambda: kd.divergent(kargs), lambda: kd.divergent_reference(kargs), 25,
                    plain_iters=5, names=names)
        t.update(bounds.bound(*kd.work(kargs), bandwidth))
        t["max_abs_err"] = d1s_err if name.startswith("d1s") else case_err[name]
        t["library_ms"] = t["library_profiler_ms"] = None
        t["instance"] = kernel_names(names)
        k6_times[name] = t
        log(f"phase5 divergent {name} ({t['instance']}): {describe(t)}")

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

    # the composed-read kernel in C1-C8: kernel vs plain version, bound,
    # floor; beside it the eager path it replaces (ParBackend.TORCH on the
    # same device leaves): its device time by events and by torch.profiler,
    # and the kernels and copies one eager call launches, from the trace
    def eager_launches(fn, calls=5):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
        return (len(names) - copies) / calls, copies / calls

    c_times = {}
    for name, ops in composed_cases(cvgs, frame, hd, nv12).items():
        pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: as_device_tensor(v, dev))
        cargs = kc.prepare(pipe, kc.build_plan(pipe), dev)
        t = measure(lambda: kc.composed(cargs), lambda: kc.composed_reference(cargs), 50,
                    what=name, plain_iters=5)
        t.update(bounds.bound(*kc.work(cargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        # one library call for the resample alone, on a float32 NCHW copy of
        # what the core reads, where one PyTorch call computes it: C1's
        # region and C2's frame through F.interpolate, as frame (a)'s; C4's
        # crop through F.affine_grid + F.grid_sample, as the warps'. No
        # single call reads the other trees: a border around or inside a
        # resize (C3, C5), a batch of crops (C6), a fused gray (C7), NV12
        # converted per tap (C8)
        t["library_ms"] = t["library_profiler_ms"] = None
        if name in ("c1_roi_crop_resize", "c2_compute_what_you_see"):
            rx, ry, rw, rh = ROI
            region = frame[ry:ry + rh, rx:rx + rw] if name.startswith("c1") else hd
            nchw = region.permute(2, 0, 1)[None].float().contiguous()
            library(t, lambda: F.interpolate(nchw, size=(FRAME_DST[1], FRAME_DST[0]),
                                             mode="bilinear", align_corners=False), 50,
                    "F.interpolate")
        elif name == "c4_warp_of_a_crop":
            rx, ry, rw, rh = ROI
            nchw = frame[ry:ry + rh, rx:rx + rw].permute(2, 0, 1)[None].float().contiguous()
            theta = torch.from_numpy(grid_sample_theta(pipe.read, rw, rh)[None]).float().to(dev)
            grid_size = (1, 3, rh, rw)
            library(t, lambda: F.grid_sample(nchw, F.affine_grid(theta, grid_size,
                                                                 align_corners=False),
                                             mode="bilinear", padding_mode="zeros",
                                             align_corners=False), 25, "F.grid_sample")
        eager = lambda: executor.run_pipeline(pipe, cvgs.ParBackend.TORCH)  # noqa: E731
        t["eager_ms"] = float(np.median(time_cuda(eager, iters=10)))
        t["eager_profiler_ms"] = profiler_ms(eager, calls=5, what=f"{name} eager")
        t["eager_launches"], t["eager_copies"] = eager_launches(eager)
        whole = []
        for _ in range(40):
            t0 = time.perf_counter()
            cvgs.execute_operations(*ops)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        assert cvgs.last_backend() == "cuda:composed"
        c_times[name] = t
        log(f"phase5 composed {name}: {describe(t)}; the eager path (ParBackend.TORCH) "
            f"{t['eager_ms'] * 1e3:.2f} us by events, {t['eager_profiler_ms'] * 1e3:.2f} us by "
            f"torch.profiler, {t['eager_launches']:.0f} kernels and {t['eager_copies']:.0f} "
            f"copies a call; execute_operations host-inclusive {t['call_ms'] * 1e3:.2f} us/call "
            f"(median of 30)")

    # the batches B1-B7 the same way: kernel vs plain version, bound, floor,
    # the eager path it replaces; for B1 one library call of the resize
    # alone (F.interpolate on a float32 NCHW stack of the cameras, made
    # before timing) and K1 on the same cameras as resize_batch's padded
    # stack: the kernel alone and the whole call with the stack's copies
    b_times = {}
    for name, ops in batch_cases(cvgs, cams, frame).items():
        pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: as_device_tensor(v, dev))
        bargs = kc.prepare(pipe, kc.build_plan(pipe), dev)
        t = measure(lambda: kc.composed(bargs), lambda: kc.composed_reference(bargs), 50,
                    what=name, plain_iters=5)
        t.update(bounds.bound(*kc.work(bargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        t["library_ms"] = t["library_profiler_ms"] = None
        if name == "b1_cameras_resized":
            nchw = torch.stack(cams).permute(0, 3, 1, 2).float().contiguous()
            library(t, lambda: F.interpolate(nchw, size=(FRAME_DST[1], FRAME_DST[0]),
                                             mode="bilinear", align_corners=False), 50,
                    "F.interpolate")
            del nchw
            k1_ops = (cvgs.resize_batch(cams, dsize=cvgs.Size(*FRAME_DST)), *ops[1:])
            k1_pipe = cvgs.build_pipeline(*k1_ops)
            k1_args = kbr.prepare(k1_pipe, kbr.build_plan(k1_pipe), dev)
            t["k1_ms"] = float(np.median(time_cuda(lambda: kbr.batch_resize(k1_args), iters=50)))
            t["k1_profiler_ms"] = profiler_ms(lambda: kbr.batch_resize(k1_args), what="b1 K1")
            t["k1_with_stack_ms"] = float(np.median(time_cuda(lambda: cvgs.execute_operations(
                cvgs.resize_batch(cams, dsize=cvgs.Size(*FRAME_DST)), *ops[1:]), iters=20)))
            assert cvgs.last_backend() == "cuda:batch_resize"
        eager = lambda: executor.run_pipeline(pipe, cvgs.ParBackend.TORCH)  # noqa: E731
        t["eager_ms"] = float(np.median(time_cuda(eager, iters=10)))
        t["eager_profiler_ms"] = profiler_ms(eager, calls=5, what=f"{name} eager")
        t["eager_launches"], t["eager_copies"] = eager_launches(eager)
        whole = []
        for _ in range(40):
            t0 = time.perf_counter()
            cvgs.execute_operations(*ops)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        assert cvgs.last_backend() == "cuda:composed"
        b_times[name] = t
        k1_text = ""
        if "k1_ms" in t:
            k1_text = (f"; K1 on the cameras' padded stack {t['k1_ms'] * 1e3:.2f} us by events, "
                  f"{t['k1_profiler_ms'] * 1e3:.2f} us by torch.profiler, the call with its "
                  f"stack {t['k1_with_stack_ms'] * 1e3:.2f} us by events")
        log(f"phase5 composed {name}: {describe(t)}; the eager path (ParBackend.TORCH) "
            f"{t['eager_ms'] * 1e3:.2f} us by events, {t['eager_profiler_ms'] * 1e3:.2f} us by "
            f"torch.profiler, {t['eager_launches']:.0f} kernels and {t['eager_copies']:.0f} "
            f"copies a call; execute_operations host-inclusive {t['call_ms'] * 1e3:.2f} us/call "
            f"(median of 30){k1_text}")

    # the mixed-geometry batches M1-M5 the same way: kernel vs plain
    # version, bound (each plane's own sectors and operations, summed),
    # floor, the eager path it replaces; no one library call reads planes of
    # several sizes, so library_ms is null; for M1 alone, as a reference,
    # eight F.interpolate calls, one a camera, on float32 NCHW copies of the
    # cameras (made before timing)
    m_times = {}
    for name, ops in mixed_cases(cvgs, m_cams, frame, m_nv12).items():
        pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: as_device_tensor(v, dev))
        margs = kc.prepare(pipe, kc.build_plan(pipe), dev)
        t = measure(lambda: kc.composed(margs), lambda: kc.composed_reference(margs), 50,
                    what=name, plain_iters=5)
        t.update(bounds.bound(*kc.work(margs), bandwidth))
        t["max_abs_err"] = case_err[name]
        t["library_ms"] = t["library_profiler_ms"] = None
        if name == "m1_cameras_of_3_sizes_resized":
            nchws = [c.permute(2, 0, 1)[None].float().contiguous() for c in m_cams]

            def per_plane_interpolates():
                return [F.interpolate(x, size=(FRAME_DST[1], FRAME_DST[0]), mode="bilinear",
                                      align_corners=False) for x in nchws]

            t["per_plane_interpolate_ms"] = float(np.median(time_cuda(per_plane_interpolates,
                                                                      iters=50)))
            t["per_plane_interpolate_profiler_ms"] = profiler_ms(
                per_plane_interpolates, what="eight F.interpolate")
            del nchws
            # what a plane's head in shared memory costs: B1 (one geometry)
            # launched as it is and through the mixed-geometry instances,
            # each plane given B1's own head, bit-equal
            b1 = map_leaves(cvgs.build_pipeline(*batch_cases(cvgs, cams, frame)[
                "b1_cameras_resized"]), lambda v: as_device_tensor(v, dev))
            b1_plan = kc.build_plan(b1)
            by_value = kc.prepare(b1, b1_plan, dev)
            through_mixed = kc.prepare(b1, kc._mixed([b1_plan] * b1_plan.n_planes), dev)
            b1_same = torch.equal(kc.composed(by_value), kc.composed(through_mixed))
            assert b1_same, "B1 through the mixed-geometry instances differs"
            for tag, b1_args in (("by_value", by_value), ("mixed", through_mixed),
                                 ("mixed", through_mixed), ("by_value", by_value)):
                t.setdefault(f"b1_{tag}_ms_runs", []).extend(
                    time_cuda(lambda: kc.composed(b1_args), iters=50))
            for tag, b1_args in (("by_value", by_value), ("mixed", through_mixed)):
                t[f"b1_{tag}_ms"] = float(np.median(t.pop(f"b1_{tag}_ms_runs")))
                t[f"b1_{tag}_profiler_ms"] = profiler_ms(lambda: kc.composed(b1_args),
                                                         what=f"b1 {tag}")
        eager = lambda: executor.run_pipeline(pipe, cvgs.ParBackend.TORCH)  # noqa: E731
        t["eager_ms"] = float(np.median(time_cuda(eager, iters=10)))
        t["eager_profiler_ms"] = profiler_ms(eager, calls=5, what=f"{name} eager")
        t["eager_launches"], t["eager_copies"] = eager_launches(eager)
        whole = []
        for _ in range(40):
            t0 = time.perf_counter()
            cvgs.execute_operations(*ops)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        assert cvgs.last_backend() == "cuda:composed"
        m_times[name] = t
        ref_text = ""
        if "per_plane_interpolate_ms" in t:
            ref_text = (f"; eight F.interpolate calls, one a camera (a reference, not one library "
                        f"call) {t['per_plane_interpolate_ms'] * 1e3:.2f} us by events, "
                        f"{t['per_plane_interpolate_profiler_ms'] * 1e3:.2f} us by torch.profiler "
                        "(the eight kernels' sum); B1's batch by value "
                        f"{t['b1_by_value_ms'] * 1e3:.2f} / "
                        f"{t['b1_by_value_profiler_ms'] * 1e3:.2f} "
                        f"us and through the mixed-geometry instances "
                        f"{t['b1_mixed_ms'] * 1e3:.2f} / {t['b1_mixed_profiler_ms'] * 1e3:.2f} us "
                        "(events / profiler), bit-equal")
        log(f"phase5 composed {name}: {describe(t)}; the eager path (ParBackend.TORCH) "
            f"{t['eager_ms'] * 1e3:.2f} us by events, {t['eager_profiler_ms'] * 1e3:.2f} us by "
            f"torch.profiler, {t['eager_launches']:.0f} kernels and {t['eager_copies']:.0f} "
            f"copies a call; execute_operations host-inclusive {t['call_ms'] * 1e3:.2f} us/call "
            f"(median of 30){ref_text}")

    # the nested cases N1-N6 the same way: kernel vs plain version, bound,
    # floor, the eager path it replaces (one launch per op); no one library
    # call reads two levels, so library_ms is null; for N3 alone, as a
    # reference, two chained F.interpolate calls on a float32 NCHW copy of
    # the 4K frame (made before timing)
    n_times = {}
    for name, ops in nested_cases(cvgs, frame, hd, cams).items():
        pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: as_device_tensor(v, dev))
        nargs = kc.prepare(pipe, kc.build_plan(pipe), dev)
        t = measure(lambda: kc.composed(nargs), lambda: kc.composed_reference(nargs), 50,
                    what=name, plain_iters=5)
        t.update(bounds.bound(*kc.work(nargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        t["library_ms"] = t["library_profiler_ms"] = None
        if name == "n3_two_level_downscale":
            nchw = frame.permute(2, 0, 1)[None].float().contiguous()

            def two_interpolates():
                half = F.interpolate(nchw, size=(FRAME_H, FRAME_W), mode="bilinear",
                                     align_corners=False)
                return F.interpolate(half, size=(FRAME_DST[1], FRAME_DST[0]), mode="bilinear",
                                     align_corners=False)

            t["two_interpolates_ms"] = float(np.median(time_cuda(two_interpolates, iters=50)))
            t["two_interpolates_profiler_ms"] = profiler_ms(two_interpolates,
                                                            what="two F.interpolate")
            del nchw
        eager = lambda: executor.run_pipeline(pipe, cvgs.ParBackend.TORCH)  # noqa: E731
        t["eager_ms"] = float(np.median(time_cuda(eager, iters=10)))
        t["eager_profiler_ms"] = profiler_ms(eager, calls=5, what=f"{name} eager")
        t["eager_launches"], t["eager_copies"] = eager_launches(eager)
        whole = []
        for _ in range(40):
            t0 = time.perf_counter()
            cvgs.execute_operations(*ops)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        assert cvgs.last_backend() == "cuda:composed"
        n_times[name] = t
        ref_text = ""
        if "two_interpolates_ms" in t:
            ref_text = (f"; two chained F.interpolate on the float32 frame (a reference, not "
                        f"one library call) {t['two_interpolates_ms'] * 1e3:.2f} us by events, "
                        f"{t['two_interpolates_profiler_ms'] * 1e3:.2f} us by torch.profiler")
        log(f"phase5 composed {name}: {describe(t)}; the eager path (ParBackend.TORCH) "
            f"{t['eager_ms'] * 1e3:.2f} us by events, {t['eager_profiler_ms'] * 1e3:.2f} us by "
            f"torch.profiler, {t['eager_launches']:.0f} kernels and {t['eager_copies']:.0f} "
            f"copies a call; execute_operations host-inclusive {t['call_ms'] * 1e3:.2f} us/call "
            f"(median of 30){ref_text}")

    # the batches of nested planes of their own geometry NM1-NM4 the same
    # way: kernel vs plain version, bound (each plane's own sectors and
    # operations, summed), floor, the eager path it replaces; no one library
    # call reads two levels, so library_ms is null
    nm_times = {}
    for name, ops in nested_mixed_cases(cvgs, m_cams, frame).items():
        pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: as_device_tensor(v, dev))
        nmargs = kc.prepare(pipe, kc.build_plan(pipe), dev)
        t = measure(lambda: kc.composed(nmargs), lambda: kc.composed_reference(nmargs), 50,
                    what=name, plain_iters=5)
        t.update(bounds.bound(*kc.work(nmargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        t["library_ms"] = t["library_profiler_ms"] = None
        eager = lambda: executor.run_pipeline(pipe, cvgs.ParBackend.TORCH)  # noqa: E731
        t["eager_ms"] = float(np.median(time_cuda(eager, iters=10)))
        t["eager_profiler_ms"] = profiler_ms(eager, calls=5, what=f"{name} eager")
        t["eager_launches"], t["eager_copies"] = eager_launches(eager)
        whole = []
        for _ in range(40):
            t0 = time.perf_counter()
            cvgs.execute_operations(*ops)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        assert cvgs.last_backend() == "cuda:composed"
        nm_times[name] = t
        log(f"phase5 composed {name}: {describe(t)}; the eager path (ParBackend.TORCH) "
            f"{t['eager_ms'] * 1e3:.2f} us by events, {t['eager_profiler_ms'] * 1e3:.2f} us by "
            f"torch.profiler, {t['eager_launches']:.0f} kernels and {t['eager_copies']:.0f} "
            f"copies a call; execute_operations host-inclusive {t['call_ms'] * 1e3:.2f} us/call "
            f"(median of 30)")

    # what a plane's head in shared memory costs the nested instances: N2
    # (staged), N3 (per tap, as a one-plane batch) and N6 (per tap, 8 planes)
    # launched by value and through the mixed nested instances, each plane
    # given the batch's own head, bit-equal; by value, mixed, mixed, by value
    head_cost = {}
    for name in ("n2_resize_then_rotate", "n3_two_level_downscale",
                 "n6_top_views_of_8_cameras_ragged"):
        ops = nested_cases(cvgs, frame, hd, cams)[name]
        if not name.startswith("n6"):
            ops = (cvgs.batch_read([ops[0]]), *ops[1:])
        pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: as_device_tensor(v, dev))
        plan = kc.build_plan(pipe)
        by_value = kc.prepare(pipe, plan, dev)
        through_mixed = kc.prepare(pipe, kc._mixed([plan] * plan.n_planes), dev)
        assert torch.equal(kc.composed(by_value), kc.composed(through_mixed)), name
        t, runs = {}, {}
        for tag, args in (("by_value", by_value), ("mixed", through_mixed),
                          ("mixed", through_mixed), ("by_value", by_value)):
            runs.setdefault(tag, []).extend(time_cuda(lambda: kc.composed(args), iters=50))
        for tag, args in (("by_value", by_value), ("mixed", through_mixed)):
            t[f"{tag}_ms"] = float(np.median(runs[tag]))
            t[f"{tag}_profiler_ms"] = profiler_ms(lambda: kc.composed(args), what=f"{name} {tag}")
        head_cost[name] = t
        log(f"phase5 composed {name} as a batch by value {t['by_value_ms'] * 1e3:.2f} / "
            f"{t['by_value_profiler_ms'] * 1e3:.2f} us and through the mixed nested instances "
            f"{t['mixed_ms'] * 1e3:.2f} / {t['mixed_profiler_ms'] * 1e3:.2f} us (events / "
            f"profiler), bit-equal; stage2 {plan.word('stage2')}")

    # the divergent batches DV1-DV4 the same way: kernel vs plain version,
    # bound (each plane's own sectors and operations, summed), floor, the
    # eager merge it replaces; no one library call runs different sequences
    # on the planes of a batch, so library_ms is null; beside it, as a
    # reference (not one call), the sum of each group's own composed launch
    # over its planes alone
    dv_times = {}
    for name, (ids, ops) in divergent_composed_cases(cvgs, cams, cams43, frame, sensor).items():
        seqs = map_leaves(tuple(cvgs.build_operation_sequence(*o) for o in ops),
                          lambda v: as_device_tensor(v, dev))
        dvargs = kc.prepare(seqs, kc.build_divergent_plan(seqs, ids), dev)
        launched = set()
        t = measure(lambda: kc.composed(dvargs), lambda: kc.composed_reference(dvargs), 50,
                    what=name, plain_iters=5, names=launched)
        t.update(bounds.bound(*kc.work(dvargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        t["library_ms"] = t["library_profiler_ms"] = None
        t["instances"] = kernel_names(launched)
        t["groups_ms"] = t["groups_profiler_ms"] = 0.0
        for g in dvargs.plan.groups:
            gpipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
            gargs = kc.prepare(gpipe, kc.build_plan(gpipe), dev)
            t["groups_ms"] += float(np.median(time_cuda(lambda: kc.composed(gargs), iters=50)))
            t["groups_profiler_ms"] += profiler_ms(lambda: kc.composed(gargs),
                                                   what=f"{name} group {g.sid}")
        eager = lambda: cvgs.launch_divergent_batch(ids, *seqs,  # noqa: E731
                                                    backend=cvgs.ParBackend.TORCH)
        t["eager_ms"] = float(np.median(time_cuda(eager, iters=10)))
        t["eager_profiler_ms"] = profiler_ms(eager, calls=5, what=f"{name} eager")
        t["eager_launches"], t["eager_copies"] = eager_launches(eager)
        whole = []
        for _ in range(40):
            t0 = time.perf_counter()
            cvgs.launch_divergent_batch(ids, *seqs)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        assert cvgs.last_backend() == "cuda:composed:divergent"
        dv_times[name] = t
        log(f"phase5 composed {name} ({t['instances']}): {describe(t)}; each group's own launch "
            f"on its planes, summed (a reference, not one call), {t['groups_ms'] * 1e3:.2f} us by "
            f"events, {t['groups_profiler_ms'] * 1e3:.2f} us by torch.profiler; the eager merge "
            f"(ParBackend.TORCH) {t['eager_ms'] * 1e3:.2f} us by events, "
            f"{t['eager_profiler_ms'] * 1e3:.2f} us by torch.profiler, "
            f"{t['eager_launches']:.0f} kernels and {t['eager_copies']:.0f} copies a call; "
            f"launch_divergent_batch host-inclusive {t['call_ms'] * 1e3:.2f} us/call (median of "
            f"30)")

    # the divergent batches with a nested group DVN1-DVN4 the same way: kernel
    # vs plain version, bound (each plane's own sectors and operations, a
    # nested plane's core once per value its second level needs), floor, the
    # eager merge it replaces (its kernels a call), each group's own launch
    # over its planes summed (a reference, not one call), the instance the
    # profiler names; library_ms null (no one library call runs different
    # sequences on the planes of a batch)
    dvn_times = {}
    for name, (ids, ops) in divergent_nested_cases(cvgs, cams, nv12_cams, sensor).items():
        seqs = map_leaves(tuple(cvgs.build_operation_sequence(*o) for o in ops),
                          lambda v: as_device_tensor(v, dev))
        dvnargs = kc.prepare(seqs, kc.build_divergent_plan(seqs, ids), dev)
        launched = set()
        t = measure(lambda: kc.composed(dvnargs), lambda: kc.composed_reference(dvnargs), 50,
                    what=name, plain_iters=3, names=launched)
        t.update(bounds.bound(*kc.work(dvnargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        t["library_ms"] = t["library_profiler_ms"] = None
        t["instances"] = kernel_names(launched)
        t["predicted_instance"] = kc.divergent_instance(dvnargs.plan)
        assert t["instances"] == t["predicted_instance"], (t["instances"], t["predicted_instance"])
        t["groups_ms"] = t["groups_profiler_ms"] = 0.0
        for g in dvnargs.plan.groups:
            gpipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
            gargs = kc.prepare(gpipe, kc.build_plan(gpipe), dev)
            t["groups_ms"] += float(np.median(time_cuda(lambda: kc.composed(gargs), iters=50)))
            t["groups_profiler_ms"] += profiler_ms(lambda: kc.composed(gargs),
                                                   what=f"{name} group {g.sid}")
        eager = lambda: cvgs.launch_divergent_batch(ids, *seqs,  # noqa: E731
                                                    backend=cvgs.ParBackend.TORCH)
        t["eager_ms"] = float(np.median(time_cuda(eager, iters=10)))
        t["eager_profiler_ms"] = profiler_ms(eager, calls=5, what=f"{name} eager")
        t["eager_launches"], t["eager_copies"] = eager_launches(eager)
        whole = []
        for _ in range(40):
            t0 = time.perf_counter()
            cvgs.launch_divergent_batch(ids, *seqs)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        assert cvgs.last_backend() == "cuda:composed:divergent"
        dvn_times[name] = t
        log(f"phase5 composed {name} ({t['instances']}): {describe(t)}; each group's own launch "
            f"on its planes, summed (a reference, not one call), {t['groups_ms'] * 1e3:.2f} us by "
            f"events, {t['groups_profiler_ms'] * 1e3:.2f} us by torch.profiler; the eager merge "
            f"(ParBackend.TORCH) {t['eager_ms'] * 1e3:.2f} us by events, "
            f"{t['eager_profiler_ms'] * 1e3:.2f} us by torch.profiler, "
            f"{t['eager_launches']:.0f} kernels and {t['eager_copies']:.0f} copies a call; "
            f"launch_divergent_batch host-inclusive {t['call_ms'] * 1e3:.2f} us/call (median of "
            f"30)")

    # what the lift costs a one-level plane: DV1 by its one-level launch and
    # with every plane carried through the nested instances (an identity
    # resize, DVN1's letterboxes' form; an empty FusedRead2), bit-equal, in
    # turns one-level, resize, none, none, resize, one-level
    ids, ops = divergent_composed_cases(cvgs, cams, cams43, frame, sensor)[
        "dv1_surround_view_letterboxes_and_warps"]
    seqs = map_leaves(tuple(cvgs.build_operation_sequence(*o) for o in ops),
                      lambda v: as_device_tensor(v, dev))
    lift_args = {lift or "one_level": kc.prepare(seqs, kc.build_divergent_plan(seqs, ids, lift),
                                                 dev) for lift in (None, *kc.LIFTS)}
    runs, lift_cost = {}, {}
    for tag in ("one_level", "resize", "none", "none", "resize", "one_level"):
        runs.setdefault(tag, []).extend(
            time_cuda(lambda: kc.composed(lift_args[tag]), iters=50))
    for tag, la in lift_args.items():
        names = set()
        lift_cost[tag] = {"ms": float(np.median(runs[tag])),
                          "profiler_ms": profiler_ms(lambda: kc.composed(la),
                                                     what=f"dv1 {tag}", names=names),
                          "instance": kernel_names(names)}
    log("phase5 composed dv1 through the nested instances (the lift's cost to a one-level "
        "plane): " + "; ".join(f"{tag} {t['ms'] * 1e3:.2f} / {t['profiler_ms'] * 1e3:.2f} us "
                               f"(events / profiler, {t['instance']})"
                               for tag, t in lift_cost.items()) + f"; card {card}")

    # the split batches DK1-DK4 the same way: kernel vs plain version, bound
    # (each part's sectors or bytes and operations over its own planes,
    # summed), floor, the eager merge it replaces (its kernels a call), and,
    # as a reference (not one call), each part's own launches over its
    # groups' planes summed: the divergent kernel over each of its groups
    # (own_k6_sequence), the composed kernel over each of the others; the
    # instance the profiler names; library_ms null (no one library call runs
    # different sequences on the planes of a batch)
    split_times = {}
    for name, (ids, ops) in split_cases(cvgs, cams, split_ring, frame, split_stack, sensor,
                                        nv12_cams).items():
        seqs = map_leaves(tuple(cvgs.build_operation_sequence(*o) for o in ops),
                          lambda v: as_device_tensor(v, dev))
        sargs = ks.prepare(seqs, ks.build_split_plan(seqs, ids), dev)
        launched = set()
        t = measure(lambda: ks.divergent_split(sargs), lambda: ks.split_reference(sargs), 50,
                    what=name, plain_iters=5, names=launched)
        t.update(bounds.bound(*ks.work(sargs), bandwidth))
        t["max_abs_err"] = case_err[name]
        t["library_ms"] = t["library_profiler_ms"] = None
        t["instances"] = kernel_names(launched)
        t["predicted_instance"] = ks.instance(sargs.plan)
        assert t["instances"] == t["predicted_instance"], (t["instances"], t["predicted_instance"])
        t["parts_ms"] = t["parts_profiler_ms"] = 0.0
        parts = []
        for g in sargs.plan.k6.groups:
            own = (own_k6_sequence(cvgs, seqs[g.sid - 1], g.planes),)
            gargs = kd.prepare(own, kd.build_plan(own, [1] * len(g.planes)), dev)
            parts.append((f"{name} K6 group {g.sid}", lambda a=gargs: kd.divergent(a)))
        for g in sargs.plan.composed.groups:
            gpipe = kc._group_pipeline(seqs[g.sid - 1], g.planes)
            cargs = kc.prepare(gpipe, kc.build_plan(gpipe), dev)
            parts.append((f"{name} composed group {g.sid}", lambda a=cargs: kc.composed(a)))
        for what, fn in parts:
            t["parts_ms"] += float(np.median(time_cuda(fn, iters=50)))
            t["parts_profiler_ms"] += profiler_ms(fn, what=what)
        eager = lambda: cvgs.launch_divergent_batch(ids, *seqs,  # noqa: E731
                                                    backend=cvgs.ParBackend.TORCH)
        t["eager_ms"] = float(np.median(time_cuda(eager, iters=10)))
        t["eager_profiler_ms"] = profiler_ms(eager, calls=5, what=f"{name} eager")
        t["eager_launches"], t["eager_copies"] = eager_launches(eager)
        whole = []
        for _ in range(40):
            t0 = time.perf_counter()
            cvgs.launch_divergent_batch(ids, *seqs)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t0)
        t["call_ms"] = float(np.median(whole[10:])) * 1e3
        assert cvgs.last_backend() == "cuda:divergent:split"
        split_times[name] = t
        log(f"phase5 divergent_split {name} ({t['instances']}): {describe(t)}; each part's own "
            f"launches over its groups' planes, summed (a reference, not one call), "
            f"{t['parts_ms'] * 1e3:.2f} us by events, {t['parts_profiler_ms'] * 1e3:.2f} us by "
            f"torch.profiler; the eager merge (ParBackend.TORCH) {t['eager_ms'] * 1e3:.2f} us by "
            f"events, {t['eager_profiler_ms'] * 1e3:.2f} us by torch.profiler, "
            f"{t['eager_launches']:.0f} kernels and {t['eager_copies']:.0f} copies a call; "
            f"launch_divergent_batch host-inclusive {t['call_ms'] * 1e3:.2f} us/call (median of "
            f"30)")

    # an int64 frame through a 3-op chain, which ran eagerly (one launch per
    # op) until int64 became int32 where it enters: one launch of the
    # pointwise kernel, which reads it at load, beside the same chain on the
    # uint8 frame (events around whole execute_operations calls: host-bound)
    i64_ops = (cvgs.image(hd.to(torch.int64)), cvgs.convert_to(np.float32, alpha=1 / 255.0),
               cvgs.subtract(MEAN), cvgs.divide(STD), cvgs.split_tensor())
    int64_call_ms = float(np.median(time_cuda(lambda: cvgs.execute_operations(*i64_ops),
                                              iters=20)))
    assert cvgs.last_backend() == "cuda:pointwise"
    same_u8 = (cvgs.image(hd), *i64_ops[1:])
    kernel_ms_u8 = float(np.median(time_cuda(lambda: cvgs.execute_operations(*same_u8), iters=20)))
    assert cvgs.last_backend() == "cuda:pointwise"
    log(f"phase5 int64 frame call (1080p int64 -> x1/255, normalize, planar f32): "
        f"{int64_call_ms * 1e3:.2f} us by events through cuda:pointwise, against "
        f"{kernel_ms_u8 * 1e3:.2f} us for the same chain on the uint8 frame (host-bound: events "
        f"around whole execute_operations calls); card {card}")

    # the dtype paths of phase 4: each kernel by events and by profiler beside
    # its plain version, its bound and floor (its bytes at the dtypes it
    # reads and writes: a 64-bit source's 8 bytes an element); the uint16
    # ring's update as its kernel's store into the slot
    dtype_times = {}
    for name, (kernel, ops) in dtype_path_ops(0).items():
        module, launch, plain = kernels[kernel]
        # host leaves onto the card once; a tensor, 64-bit ones among them,
        # stays as it is
        if kernel == "divergent":
            ids, seqs = ops
            seqs = map_leaves(seqs, lambda v: dt.kernel_source(v, dev))
            targs = kd.prepare(seqs, kd.build_plan(seqs, ids), dev)
        else:
            pipe = map_leaves(cvgs.build_pipeline(*ops), lambda v: dt.kernel_source(v, dev))
            targs = module.prepare(pipe, module.build_plan(pipe), dev)
        t = measure(lambda: launch(targs), lambda: plain(targs), 50, plain_iters=10)
        t.update(bounds.bound(*module.work(targs), bandwidth))
        t["library_ms"] = t["library_profiler_ms"] = None
        dtype_times[name] = t
        log(f"phase5 dtype path {name} ({kernel}): {describe(t)}")
    pipe16 = map_leaves(cvgs.build_pipeline(*ct16_ops(40), cvgs.split_tensor()),
                        lambda v: as_device_tensor(v, dev))
    args16 = kfr.prepare(pipe16, kfr.build_plan(pipe16), dev)
    slot16 = torch.empty((2, 3, 128, 64), dtype=torch.uint16, device=dev)[1]
    t = measure(lambda: kfr.frame_resize(args16, out=slot16),
                lambda: kbr.reference_into(kfr.frame_resize_reference(args16), slot16, dev), 50,
                plain_iters=10)
    out_bytes, src_bytes, flops = kfr.work(args16)
    # the slot holds uint16: twice the bytes of the plan's uint8 values
    t.update(bounds.bound(2 * out_bytes, src_bytes, flops, bandwidth))
    t["library_ms"] = t["library_profiler_ms"] = None
    dtype_times["circular_tensor_u8_into_u16_ring"] = t
    log(f"phase5 dtype path circular_tensor_u8_into_u16_ring (frame_resize, out= the slot): "
        f"{describe(t)}")
    pipe32 = map_leaves(cvgs.build_pipeline(*ct32_ops(40), cvgs.split_tensor()),
                        lambda v: as_device_tensor(v, dev))
    args32 = kfr.prepare(pipe32, kfr.build_plan(pipe32), dev)
    slot32 = torch.empty((2, 3, 128, 64), dtype=torch.int32, device=dev)[1]
    t = measure(lambda: kfr.frame_resize(args32, out=slot32),
                lambda: kbr.reference_into(kfr.frame_resize_reference(args32), slot32, dev), 50,
                plain_iters=10)
    t.update(bounds.bound(*kfr.work(args32), bandwidth))
    t["library_ms"] = t["library_profiler_ms"] = None
    dtype_times["circular_tensor_i32_ring"] = t
    log(f"phase5 dtype path circular_tensor_i32_ring (frame_resize, out= the slot): {describe(t)}")

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
                "phase7_launches": bench["launches"].get(name, 0),
                "phase7_rows": bench["rows"].get(name, []),
                **more}

    print(card)
    print(json.dumps({"kernels": [
        entry("batch_resize", "batch_resize.cu", "cvgpuspeedup_tpu/exec/pallas_backend.py:500",
              main_launches, k1, cases={"flagship": k1},
              dtype_path=dtype_times["flagship_u16_12bit_to_f16"],
              int32_path=dtype_times["flagship_i32_to_f32"],
              x64_path=dtype_times["flagship_f64_to_f32"],
              sharded_launches=sharded_launches["batch_resize"], sharding=shard_times),
        # path (a); both paths below
        entry("frame_resize", "frame_resize.cu", "cvgpuspeedup_tpu/exec/pallas_frame.py:663",
              frame_launches, frame_times["a"],
              paths={"a_1080p_rgb_to_640x360": frame_times["a"],
                     "b_nv12_6k_to_1080p": frame_times["b"]},
              dtype_paths={k: dtype_times[k] for k in ("frame_a_to_f16",
                                                       "circular_tensor_u8_into_u16_ring")},
              int32_paths={k: dtype_times[k] for k in ("frame_a_i32_to_f32",
                                                       "circular_tensor_i32_ring")},
              x64_path=dtype_times["frame_a_i64_to_f32"]),
        # W6, the batch of the main path (the batched TPU kernel); the
        # single-image classes and the timed cases below
        entry("warp", "warp.cu", "cvgpuspeedup_tpu/exec/pallas_warp_universal.py:741",
              warp_launches, w6,
              also_replaces=["cvgpuspeedup_tpu/exec/pallas_warp.py:202",
                             "cvgpuspeedup_tpu/exec/pallas_warp_general.py:272",
                             "cvgpuspeedup_tpu/exec/pallas_warp_universal.py:359"],
              cases=warp_times, sharded_launches=sharded_launches["warp"],
              dtype_path=dtype_times["w6_to_f16"], int32_path=dtype_times["w6_into_i32"],
              x64_path=dtype_times["w6_f64_to_f32"]),
        # D4, the reference's warp | crop | pass row; D1-D4 below
        entry("divergent", "divergent.cu", "cvgpuspeedup_tpu/exec/pallas_divergent.py:686",
              divergent_launches, d4t, cases=div_times,
              circular_tensor_update_ms=ct_update_ms, dtype_path=dtype_times["d1_into_int16"],
              int32_path=dtype_times["d1_into_i32"], x64_path=dtype_times["d1_f64_ring"],
              source_dtype_cases=k6_times, registers=k6_registers,
              also_sources=["cvgpuspeedup_tpu_torch/csrc/divergent_any.cu"]
              + [f"cvgpuspeedup_tpu_torch/csrc/{src.name}" for src in _build.SOURCES
                 if src.name.startswith("divergent_split")],
              sharded_launches=sharded_launches["divergent"],
              # the split kernel (K6's body beside the composed kernel's, by
              # plane): DK1-DK4, its launches over phase 4's calls
              split_cases=split_times, split_launches=split_launches,
              split_launches_per_call=split_launches / path_calls["divergent_split"],
              split_max_abs_err=max_err["divergent_split"], split_registers=split_registers),
        # P1, the MAD stress (bound by its unfused operations); P1-P5 below. No
        # Pallas counterpart: it replaces the reference's jitted XLA program
        entry("pointwise", "pointwise.cu", "cvgpuspeedup_tpu/exec/executor.py:243",
              pointwise_launches, pw_times["p1_mad_200_ops_2048x2048"], cases=pw_times,
              circular_tensor_update=ring_update, int64_frame_call_ms=int64_call_ms,
              int32_path=dtype_times["crop_border_i32_unchanged"],
              x64_path=dtype_times["crop_border_f64"],
              sharded_launches=sharded_launches["pointwise"]),
        # C1, the region of interest; C1-C8 below, each beside the eager path
        # it replaces. No Pallas counterpart: it replaces the reference's
        # jitted XLA program for composed reads
        entry("composed", "composed.cu", "cvgpuspeedup_tpu/exec/executor.py:243",
              composed_launches, c_times["c1_roi_crop_resize"], cases=c_times,
              batch_cases=b_times, nested_cases=n_times, mixed_cases=m_times,
              nested_mixed_cases=nm_times, nested_head_cost=head_cost,
              divergent_cases=dv_times, divergent_nested_cases=dvn_times,
              lift_cost=lift_cost,
              also_sources=[f"cvgpuspeedup_tpu_torch/csrc/{src.name}" for src in _build.SOURCES
                            if src.name.startswith("composed")]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
