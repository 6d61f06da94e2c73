"""The least time the card could take for a kernel's work: bytes and operations.

Counterpart of the ``analytic_floor()`` functions of
``cvgpuspeedup_tpu/exec/pallas_*.py``. The bytes a kernel must move are its
output, written once, and the source bytes its taps touch, counted in the
32-byte sectors device memory delivers: each kernel's own coordinate
functions (the plain versions') give the taps, so overlapping crops or warps
share their sectors and planes past ``used_planes`` read nothing. The
operations are the float32 work per output value: the lerps, a colour
conversion's sums, one per chain row. :func:`bound` turns both into times.

Each kernel module prices its own launches with these helpers: its
``work(args)`` gives ``(output bytes, source bytes touched, operations)``
for its prepared arguments. Everything keys on the plan and the launch's
arguments, never on a run: whatever runs the same pipeline (``chip_smoke.py``,
the benchmark scripts) is priced on the same work, at the same rates.

The H100 SXM's published peaks (NVIDIA's data sheet): 3.35 TB/s of device
memory and 67 TFLOP/s of float32 outside the tensor cores. The published
rate counts an FMA as two operations; every kernel is built with
``-fmad=false`` and issues one multiply or one add per lane and cycle, so
its operations run at half of it (:data:`OP_PER_S`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

#: the H100 SXM's published device-memory rate, bytes per second
PEAK_BYTES_PER_S = 3.35e12
#: its published float32 rate outside the tensor cores (an FMA counts twice)
PEAK_F32_FLOP_PER_S = 67e12
#: the float32 rate of separate multiplies and adds (no FMA), every kernel's
OP_PER_S = PEAK_F32_FLOP_PER_S / 2


def sectors(first_byte, elem_bytes: int):
    """The distinct 32-byte sectors under elements of ``elem_bytes`` that
    start at the byte offsets ``first_byte`` (a tensor)."""
    return torch.unique(torch.cat([first_byte // 32, (first_byte + elem_bytes - 1) // 32]))


def crop_touched_bytes(read, planes=None) -> int:
    """Bytes of the batched crop-resize's source that its taps touch, in
    32-byte sectors, from the plain version's own coordinate functions;
    overlapping crops share their sectors, planes past ``used_planes`` (and
    outside ``planes``) read nothing."""
    from ..ops.resize import axis_lerp, letterbox_geometry, source_index

    src = read.source()
    src_h, src_w, nch = read.source_dims()
    elem = nch * src.element_size()
    rects = torch.as_tensor(read.rects).cpu().to(torch.int32)
    used = rects.shape[0] if read.used_planes is None else int(torch.as_tensor(read.used_planes))
    dst_w, dst_h = read.dsize
    found = []
    for z in range(min(used, rects.shape[0])):
        if planes is not None and z not in planes:
            continue
        x, y, w, h = (int(v) for v in rects[z])
        nw, nh, ox, oy = (int(v) for v in letterbox_geometry(w, h, read.dsize, read.aspect_ratio))
        qx = torch.arange(dst_w, dtype=torch.int32) - ox
        qy = torch.arange(dst_h, dtype=torch.int32) - oy
        qx, qy = qx[(qx >= 0) & (qx < nw)], qy[(qy >= 0) & (qy < nh)]
        if not len(qx) or not len(qy):
            continue
        cols = torch.unique(torch.cat([source_index(x + t, src_w) for t in axis_lerp(qx, w, nw)[:2]]))
        rows = torch.unique(torch.cat([source_index(y + t, src_h) for t in axis_lerp(qy, h, nh)[:2]]))
        plane = z * src_h * src_w if read.stack is not None else 0
        first = ((plane + rows[:, None].long() * src_w + cols[None, :].long()) * elem).reshape(-1)
        found.append(sectors(first, elem))
    return int(torch.unique(torch.cat(found)).numel()) * 32 if found else 0


def axis_reads(i0, i1, w, keep: bool) -> np.ndarray:
    """The distinct source positions one axis of a bilinear resize reads,
    from its tap tables (``ops/resize.py::axis_taps``) at the outputs they
    are given for: every output's first tap, and its second where the lerp
    takes it. Under the edge rule (``keep``) a weight of 0 takes the first
    tap alone (``ops/resize.py::sample_frame``), so that second tap is
    left out: at an exact 3:1 every output's."""
    i0, i1, w = np.asarray(i0), np.asarray(i1), np.asarray(w)
    second = i1[w != 0] if keep else i1
    return np.unique(np.concatenate([i0, second]).astype(np.int64))


def grid_sectors(row_at, col_at, elem_bytes: int) -> np.ndarray:
    """The distinct 32-byte sectors under every element whose first byte
    is ``row_at[r] + col_at[c]``, for every row start ``row_at[r]`` and
    column offset ``col_at[c]`` (bytes), each ``elem_bytes`` long: the
    taps of a resample whose rows and columns are read in every pairing."""
    first = (np.asarray(row_at, np.int64)[:, None] + np.asarray(col_at, np.int64)[None, :])
    first = first.reshape(-1)
    return np.unique(np.concatenate([first // 32, (first + elem_bytes - 1) // 32]))


def touched_bytes(plan) -> int:
    """Bytes of the frame kernel's source that its taps touch, in the 32-byte
    sectors device memory delivers: the rows and columns of
    :func:`axis_reads` (a second tap of weight 0 under the edge rule left
    out), each row read at each column; an NV12 buffer's chroma pairs at
    the chroma tables' rows and columns under the luma's weights."""
    w, h = plan.dsize
    t = plan.taps
    keep = bool(plan.keep_edge)
    wx, wy = plan.weights[:w], plan.weights[w:]

    def reads(tab):
        return (axis_reads(tab[:w], tab[w:2 * w], wx, keep),
                axis_reads(tab[2 * w:2 * w + h], tab[2 * w + h:2 * w + 2 * h], wy, keep))

    elem = plan.nch * plan.src_dtype.itemsize
    cols, rows = reads(t)
    found = [grid_sectors(rows * plan.src_w * elem, cols * elem, elem)]
    if plan.yuv:  # chroma pairs: cx pairs of 2 bytes in rows of src_w bytes after the luma
        ccols, crows = reads(t[2 * (w + h):])
        found.append(grid_sectors((plan.src_h + crows) * plan.src_w, ccols * 2, 2))
    return int(np.unique(np.concatenate(found)).size) * 32


def warp_touched_bytes(args) -> int:
    """Bytes of the warp kernel's sources that its taps touch, in 32-byte
    sectors, from the plain version's tap indices (``WarpRead.coordinates``
    and ``tap_axis``); planes past ``used_planes`` read nothing."""
    from ..ops.warp import tap_axis

    plan = args.plan
    warps = args.pipeline.read.ops if plan.batch else (args.pipeline.read,)
    used = int(args.used.item())
    elem = plan.nch * plan.src_dtype.itemsize
    found = []
    for z, (w, k) in enumerate(zip(warps, args.plane_src)):
        if z >= used:
            continue
        sx, sy = w.coordinates(args.srcs[k].device)
        xs = tap_axis(torch.floor(sx), plan.src_w)
        ys = tap_axis(torch.floor(sy), plan.src_h)
        for vx, ix in xs:
            for vy, iy in ys:
                first = (iy * plan.src_w + ix)[vx & vy] * elem
                found += [k * 2**40 + first // 32, k * 2**40 + (first + elem - 1) // 32]
    return int(torch.unique(torch.cat(found)).numel()) * 32


def bound(out_bytes: int, src_bytes: int, flops: int, bandwidth: float) -> Dict:
    """The least time the card could take: ``bound_ms`` is the larger of
    the bytes over the published memory rate and the float32 operations
    over :data:`OP_PER_S`; ``floor_ms`` is the bytes over the copy
    bandwidth this run measured."""
    by_bytes = (out_bytes + src_bytes) / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / OP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else
            "operations", "floor_ms": (out_bytes + src_bytes) / bandwidth * 1e3,
            "out_bytes": out_bytes, "src_bytes_touched": src_bytes, "flops": flops}


def floor_s(b: Dict) -> float:
    """A bound's floor in seconds: its bytes over the measured copy
    bandwidth, or its operations over their rate where that is longer."""
    return max(b["floor_ms"], b["flops"] / OP_PER_S * 1e3) * 1e-3


def output(plan) -> Tuple[int, int]:
    """``(bytes, values)`` of a plan's output."""
    w, h = plan.dsize
    values = getattr(plan, "n_planes", 1) * plan.out_ch * h * w  # a frame plan has one plane
    return values * plan.out_dtype.itemsize, values
