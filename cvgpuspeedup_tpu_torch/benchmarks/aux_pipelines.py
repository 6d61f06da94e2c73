#!/usr/bin/env python
"""The auxiliary pipelines on the card, each fused call against the per-op
launch pattern it replaces.

Counterpart of the reference's ``benchmarks/aux_pipelines.py``: the same 13
rows under the same names, shapes, constants and seeds. Each row's fused call
is one launch of one hand-written kernel (``cuda:frame_resize``,
``cuda:warp``, ``cuda:divergent``, ``cuda:pointwise``); its per-op step is
the reference's own decomposition, each op one port call or one torch op on
the card, with its constants kept there. Where the reference's baseline is
one jitted XLA program of the same pipeline (the universal and batched
warps, the divergent crop-resize and warp mixes), which the port has no
counterpart of, the step is decomposed as the other rows': a warp row is the
warp, the conversion and the split; a divergent row is one call per
sequence over every plane, then the merge.

The reference's rotation row (l.471) maps the frame's centre to (960, 540),
outside its 640x360 output: most output pixels read the border. It is kept
as the reference defines it, and the share of output pixels whose source
lies in the frame is printed beside it. The warp matrices are built in numpy
(:func:`get_rotation_matrix_2d`, :func:`get_perspective_transform`, which
compute what ``cv2.getRotationMatrix2D`` and ``cv2.getPerspectiveTransform``
do); nothing here imports cv2.

    python -m cvgpuspeedup_tpu_torch.benchmarks.aux_pipelines [--quick] [--out DIR]

Needs the card. Writes ``aux_pipelines.csv`` (device time: the per-op step
as the baseline, the fused call, ``floor_s``) and ``aux_pipelines_host.csv``
(host-inclusive) under ``--out`` (``build/benchmarks`` by default).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import cvgpuspeedup_tpu_torch as cvgs

from . import _timing

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
#: the inputs that stay host arrays, as a caller passes them: warp matrices,
#: rects, sizes; every other array is on the card before the first call
HOST_KEYS = ("m", "mats", "rects", "dst")


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the forward 2x3 matrix of a rotation by
    ``angle`` degrees about ``center`` (float32 coordinates), scaled."""
    a = angle * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = (float(np.float32(v)) for v in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def get_perspective_transform(src, dst) -> np.ndarray:
    """``cv2.getPerspectiveTransform``: the 3x3 homography that maps the four
    float32 points ``src`` onto ``dst``, from the same 8x8 system."""
    src, dst = np.asarray(src, np.float32), np.asarray(dst, np.float32)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i].astype(np.float64), dst[i].astype(np.float64)
        a[i] = (x, y, 1, 0, 0, 0, -x * u, -y * u)
        a[i + 4] = (0, 0, 0, x, y, 1, -x * v, -y * v)
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def in_frame_share(m: np.ndarray, src_hw, dsize) -> float:
    """The share of a warp's output pixels whose source (the inverse map of
    the pixel) lies inside a frame of ``src_hw``."""
    full = np.vstack([m, [0.0, 0.0, 1.0]]) if m.shape == (2, 3) else m
    inv = np.linalg.inv(full)
    ys, xs = np.mgrid[0:dsize[1], 0:dsize[0]]
    p = inv @ np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
    sx, sy = p[0] / p[2], p[1] / p[2]
    h, w = src_hw
    return float(((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)).mean())


def _u8(rng, shape) -> np.ndarray:
    return rng.integers(0, 256, shape).astype(np.uint8)


def _edge(n: int, divisor: int) -> int:
    """An edge at 1/divisor of the reference's, kept even (NV12 needs it)."""
    return max(2, n // divisor // 2 * 2)


@dataclasses.dataclass
class Row:
    """One of the reference's rows: ``data`` its seeded inputs (numpy),
    ``ops(f, data)`` its fused pipeline built with the factories of ``f``
    (this package, or another with the same factories), as an op tuple or,
    for a divergent row, ``(plane ids, sequences)``; ``per_op(data)`` the
    reference's per-op decomposition on the data's device; ``ring``: the
    fused call is ``CircularTensor.update`` of ``ops`` into a ring of
    (width, height, channels, batch), read back by a one-element ``probe``
    after each update where set."""

    name: str
    kernel: str
    data: Dict
    ops: Callable
    per_op: Callable
    divergent: bool = False
    ring: Optional[tuple] = None
    probe: bool = False
    note: Callable = lambda data: ""
    iters: int = 50
    per_op_iters: int = 20


def _planar(t: torch.Tensor) -> torch.Tensor:
    """The reference's split program: (H, W, C) to (C, H, W), materialized."""
    return t.permute(2, 0, 1).contiguous()


class _Kept(dict):
    """Tensors a per-op step keeps on the card between its calls, as the
    reference's jitted programs keep their constants: made at first use."""

    def keep(self, what, device, make: Callable[[], torch.Tensor]) -> torch.Tensor:
        key = (what, str(device))
        if key not in self:
            self[key] = make().to(device)
        return self[key]

    def const(self, values, like: torch.Tensor) -> torch.Tensor:
        return self.keep(values, like.device, lambda: torch.tensor(values, dtype=torch.float32))


def _merge_per_op(ids, seqs, kept: _Kept):
    """The divergent rows' decomposition: each sequence (op tuples) as one
    call over every plane, then the merge, one ``torch.where`` per sequence
    after the first, on masks kept on the card."""
    outs = [cvgs.execute_operations(*s) for s in seqs]
    merged = outs[-1]
    for sid in range(len(outs) - 1, 0, -1):
        m = kept.keep(("mask", sid), outs[0].device, lambda: torch.tensor([i == sid for i in ids]))
        merged = torch.where(m.view(-1, *(1,) * (merged.dim() - 1)), outs[sid - 1], merged)
    return merged


def single_1080p(divisor: int = 1) -> Row:
    rng = np.random.default_rng(0)
    data = {"img": _u8(rng, (_edge(1080, divisor), _edge(1920, divisor), 3)),
            "dst": (_edge(640, divisor), _edge(360, divisor))}

    def ops(f, d):
        return (f.resize(f.image(d["img"]), f.Size(*d["dst"])),
                f.convert_to(np.float32, alpha=1 / 255.0), f.subtract(MEAN), f.divide(STD),
                f.split_tensor())

    kept = _Kept()

    def per_op(d):  # resize, convert, subtract, divide, split: 5 launches
        t = cvgs.execute_operations(cvgs.resize(cvgs.image(d["img"]), cvgs.Size(*d["dst"])))
        t = t * (1 / 255.0)
        t = t - kept.const(MEAN, t)
        t = t / kept.const(STD, t)
        return _planar(t)

    return Row("single_1080p_resize_normalize_split", "cuda:frame_resize", data, ops, per_op)


def nv12_6k(divisor: int = 1) -> Row:
    rng = np.random.default_rng(1)
    w, h = _edge(5760, divisor), _edge(3240, divisor)
    data = {"buf": _u8(rng, (h * 3 // 2, w)), "dst": (_edge(1920, divisor), _edge(1080, divisor))}

    def ops(f, d):
        virtual = f.fuse(f.read_yuv(d["buf"]),
                         f.convert_yuv_to_rgb(standard=f.ColorStandard.BT709,
                                              out_dtype=np.float32))
        return (f.resize(virtual, f.Size(*d["dst"])), f.multiply(1 / 255.0), f.split_tensor())

    def per_op(d):  # NV12 -> RGB, resize, normalize, split: 4 launches
        rgb = cvgs.execute_operations(cvgs.read_yuv(d["buf"]), cvgs.convert_yuv_to_rgb(
            standard=cvgs.ColorStandard.BT709, out_dtype=np.float32))
        t = cvgs.execute_operations(cvgs.resize(cvgs.image(rgb), cvgs.Size(*d["dst"])))
        return _planar(t * (1 / 255.0))

    return Row("nv12_6k_to_1080p_rgb_normalize", "cuda:frame_resize", data, ops, per_op,
               iters=30, per_op_iters=10)


def circular_tensor(divisor: int = 1) -> Row:
    rng = np.random.default_rng(2)
    data = {"frame": _u8(rng, (_edge(1080, divisor), _edge(1920, divisor), 3))}

    def ops(f, d):
        return (f.resize(f.image(d["frame"]), f.Size(64, 128)),
                f.convert_to(np.float32, alpha=1 / 255.0))

    kept = _Kept()

    def per_op(d):  # resize, convert, split, shift: 4 launches
        zeros = kept.keep("ring", d["frame"].device, lambda: torch.zeros((32, 3, 128, 64)))
        t = cvgs.execute_operations(cvgs.resize(cvgs.image(d["frame"]), cvgs.Size(64, 128)))
        new = _planar(t * (1 / 255.0))
        return torch.cat([new[None], zeros[:-1]])

    return Row("circular_tensor_32_update", "cuda:frame_resize", data, ops, per_op,
               ring=(64, 128, 3, 32))


def circular_ring_insert(divisor: int = 1) -> Row:
    b, c, h, w = 32, 3, 128, 64
    rng = np.random.default_rng(11)
    data = {"frame": _u8(rng, (h, w, c))}

    def ops(f, d):
        return (f.image(d["frame"]), f.convert_to(np.float32, alpha=1 / 255.0))

    state, kept = {"k": 0}, _Kept()

    def per_op(d):  # the chain, then the shift of the whole ring: 2 launches and the probe
        zeros = kept.keep("ring", d["frame"].device, lambda: torch.zeros((b, c, h, w)))
        probe = kept.keep("probe", d["frame"].device, lambda: torch.zeros(()))
        new = (d["frame"] * (1 / 255.0)).permute(2, 0, 1)
        ring = torch.cat([new[None], zeros[:-1]])
        probe.add_(ring[(state["k"] * 13) % b, 0, 0, 0])
        state["k"] += 1
        return ring

    return Row("circular_ring_insert_device", "cuda:pointwise", data, ops, per_op,
               ring=(w, h, c, b), probe=True, iters=100, per_op_iters=50)


def _warp_per_op(d, warp_type=None):
    """The reference's warp rows' decomposition: the warp, the conversion,
    the split: 3 launches."""
    kind = {} if warp_type is None else {"warp_type": warp_type}
    t = cvgs.execute_operations(cvgs.warp(cvgs.image(d["img"]), d["m"], cvgs.Size(*d["dst"]),
                                          **kind))
    return _planar(t * (1 / 255.0))


def warp_separable(divisor: int = 1) -> Row:
    rng = np.random.default_rng(3)
    data = {"img": _u8(rng, (_edge(1080, divisor), _edge(1920, divisor), 3)),
            "dst": (_edge(640, divisor), _edge(360, divisor)),
            "m": np.array([[0.55, 0.0, 23.0 / divisor], [0.0, 0.62, 11.0 / divisor]], np.float32)}

    def ops(f, d):
        return (f.warp(f.image(d["img"]), d["m"], f.Size(*d["dst"])),
                f.convert_to(np.float32, alpha=1 / 255.0), f.split_tensor())

    return Row("warp_1080p_separable_affine_normalize_split", "cuda:warp", data, ops, _warp_per_op)


def warp_rotation(divisor: int = 1) -> Row:
    rng = np.random.default_rng(4)
    h, w = _edge(1080, divisor), _edge(1920, divisor)
    data = {"img": _u8(rng, (h, w, 3)), "dst": (_edge(640, divisor), _edge(360, divisor)),
            "m": get_rotation_matrix_2d((960 / divisor, 540 / divisor), 10.0, 1 / 3.0)}

    def ops(f, d):
        return (f.warp(d["img"], d["m"], f.Size(*d["dst"])),
                f.convert_to(np.float32, alpha=1 / 255.0), f.split_tensor())

    def note(d):
        share = in_frame_share(d["m"], (h, w), d["dst"])
        return (f"{share:.4f} of the output pixels map inside the frame (the reference's "
                "rotation about (960, 540), uncentred: the rest is the border fill)")

    return Row("warp_1080p_rotation10deg_normalize_split", "cuda:warp", data, ops, _warp_per_op,
               note=note)


def _universal_data(divisor: int) -> Dict:
    rng = np.random.default_rng(5)
    return {"img": _u8(rng, (_edge(1080, divisor), _edge(1920, divisor), 3))}


def _convert_split(f):
    return f.convert_to(np.float32, alpha=1 / 255.0), f.split_tensor()


def warp_hflip(divisor: int = 1) -> Row:
    data = _universal_data(divisor)
    data["m"] = np.array([[-0.5, 0.0, 960.0 / divisor], [0.0, 0.5, 2.0 / divisor]])
    data["dst"] = (_edge(960, divisor), _edge(540, divisor))

    def ops(f, d):
        return (f.warp(f.image(d["img"]), d["m"], f.Size(*d["dst"]),
                       warp_type=f.WarpType.AFFINE), *_convert_split(f))

    return Row("warp_1080p_hflip_downscale_universal", "cuda:warp", data, ops,
               lambda d: _warp_per_op(d, cvgs.WarpType.AFFINE))


def warp_perspective(divisor: int = 1) -> Row:
    data = _universal_data(divisor)
    h, w = data["img"].shape[:2]
    src = np.float32([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]])
    dst = np.float32([[20, 10], [620, 25], [8, 370], [630, 380]]) / divisor
    data["m"] = get_perspective_transform(src, dst)
    data["dst"] = (_edge(640, divisor), _edge(384, divisor))

    def ops(f, d):
        return (f.warp(f.image(d["img"]), d["m"], f.Size(*d["dst"]),
                       warp_type=f.WarpType.PERSPECTIVE), *_convert_split(f))

    return Row("warp_1080p_perspective_universal", "cuda:warp", data, ops,
               lambda d: _warp_per_op(d, cvgs.WarpType.PERSPECTIVE))


def warp_batch8(divisor: int = 1) -> Row:
    rng = np.random.default_rng(8)
    data = {"frame": _u8(rng, (_edge(1080, divisor), _edge(1920, divisor), 3)),
            "dst": (_edge(640, divisor), _edge(360, divisor)),
            "mats": [get_rotation_matrix_2d((960 / divisor, 540 / divisor), 3.0 * i - 10,
                                            1.0 + 0.04 * i) for i in range(8)]}

    def ops(f, d):
        shared = f.image(d["frame"])  # one read shared by all planes
        return (f.warp_batch([shared] * 8, d["mats"], f.Size(*d["dst"]), used_planes=7,
                             default=3.0), *_convert_split(f))

    def per_op(d):  # the batched warp, the conversion, the split: 3 launches
        t = cvgs.execute_operations(cvgs.warp_batch(
            [cvgs.image(d["frame"])] * 8, d["mats"], cvgs.Size(*d["dst"]), used_planes=7,
            default=3.0))
        return (t * (1 / 255.0)).permute(0, 3, 1, 2).contiguous()

    return Row("warp_batch8_1080p_rotations_ragged", "cuda:warp", data, ops, per_op, iters=30)


def divergent_two_sequences(divisor: int = 1) -> Row:
    rng = np.random.default_rng(4)
    n = 16
    data = {"stack": _u8(rng, (n, _edge(128, divisor), _edge(256, divisor), 3))}
    ids = tuple(1 if z % 2 == 0 else 2 for z in range(n))

    def seqs(f, d):
        s1 = (f.circular_batch_read(d["stack"], first=np.int32(3)),
              f.convert_to(np.float32, alpha=0.3), f.subtract((1.0, 2.0, 3.0)), f.write_tensor())
        s2 = (f.circular_batch_read(d["stack"], first=np.int32(3)),
              f.convert_to(np.float32, alpha=0.5), f.multiply((2.0, 1.0, 0.5)), f.write_tensor())
        return s1, s2

    def ops(f, d):
        return ids, tuple(f.build_operation_sequence(*s) for s in seqs(f, d))

    kept = _Kept()

    def per_op(d):  # one program per sequence, over every plane, and the merge: 3 launches
        return _merge_per_op(ids, seqs(cvgs, d), kept)

    return Row("divergent_batch_two_sequences", "cuda:divergent", data, ops, per_op,
               divergent=True)


def divergent_nv12(divisor: int = 1) -> Row:
    rng = np.random.default_rng(6)
    sh, sw, h2, w2 = (_edge(v, divisor) for v in (128, 512, 64, 256))
    n = 8
    data = {"bufs": [_u8(rng, (sh * 3 // 2, sw)) for _ in range(n)],
            "flat": rng.integers(0, 200, (n, h2, w2, 3)).astype(np.float32), "dst": (w2, h2)}
    ids = tuple(1 if z % 2 == 0 else 2 for z in range(n))

    def ops(f, d):
        cams = [f.resize(f.fuse(f.read_yuv(b), f.convert_yuv_to_rgb(
            standard=f.ColorStandard.BT709, out_dtype=np.float32)), f.Size(*d["dst"]))
            for b in d["bufs"]]
        return ids, (f.build_operation_sequence(f.batch_read(cams), f.multiply(0.5),
                                                f.write_tensor()),
                     f.build_operation_sequence(f.image(d["flat"]), f.write_tensor()))

    def per_op(d):  # per camera NV12 -> RGB, resize, scale; the stack: 13 launches
        outs = []
        for z in range(n):
            if ids[z] == 1:
                rgb = cvgs.execute_operations(cvgs.read_yuv(d["bufs"][z]), cvgs.convert_yuv_to_rgb(
                    standard=cvgs.ColorStandard.BT709, out_dtype=np.float32))
                outs.append(cvgs.execute_operations(
                    cvgs.resize(cvgs.image(rgb), cvgs.Size(*d["dst"]))) * 0.5)
            else:
                outs.append(d["flat"][z])
        return torch.stack(outs)

    return Row("divergent_nv12_resize_passthrough_8planes", "cuda:divergent", data, ops, per_op,
               divergent=True)


def _crop_rects(n: int) -> np.ndarray:
    return np.array([[13 * z, 9 * z, 60, 120] for z in range(n)], np.int32)


def divergent_crop_resize(divisor: int = 1) -> Row:
    rng = np.random.default_rng(7)
    n = 8
    data = {"frame": _u8(rng, (_edge(2160, divisor), _edge(3840, divisor), 3)),
            "rects": _crop_rects(n),
            "flat": rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)}
    ids = tuple(1 if z % 3 else 2 for z in range(n))

    def seqs(f, d):
        return ((f.resize_batch(d["frame"], rects=d["rects"], dsize=f.Size(64, 128)),
                 f.convert_to(np.float32, alpha=0.5), f.subtract((1.0, 2.0, 3.0)),
                 f.write_tensor()),
                (f.image(d["flat"]), f.multiply(2.0), f.write_tensor()))

    def ops(f, d):
        return ids, tuple(f.build_operation_sequence(*s) for s in seqs(f, d))

    kept = _Kept()

    def per_op(d):  # the two sequences over every plane, the merge: 3 launches
        return _merge_per_op(ids, seqs(cvgs, d), kept)

    return Row("divergent_crop_resize_passthrough_8planes", "cuda:divergent", data, ops, per_op,
               divergent=True)


def divergent_warp_mix(divisor: int = 1) -> Row:
    rng = np.random.default_rng(9)
    n = 8
    h, w = _edge(512, divisor), _edge(768, divisor)
    data = {"imgs": [_u8(rng, (h, w, 3)) for _ in range(n)],
            "mats": [get_rotation_matrix_2d((384 / divisor, 256 / divisor), 4.0 * z - 14, 1.0)
                     for z in range(n)],
            "frame": _u8(rng, (_edge(2160, divisor), _edge(3840, divisor), 3)),
            "rects": _crop_rects(n),
            "flat": rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)}
    ids = (1, 2, 3, 1, 2, 3, 1, 2)

    def seqs(f, d):
        return ((f.warp_batch([f.image(im) for im in d["imgs"]], d["mats"], f.Size(64, 128)),
                 f.multiply(0.5), f.write_tensor()),
                (f.resize_batch(d["frame"], rects=d["rects"], dsize=f.Size(64, 128)),
                 f.convert_to(np.float32, alpha=0.5), f.write_tensor()),
                (f.image(d["flat"]), f.multiply(2.0), f.write_tensor()))

    def ops(f, d):
        return ids, tuple(f.build_operation_sequence(*s) for s in seqs(f, d))

    kept = _Kept()

    def per_op(d):  # the three sequences over every plane, the merge: 5 launches
        return _merge_per_op(ids, seqs(cvgs, d), kept)

    return Row("divergent_warp_crop_pass_8planes", "cuda:divergent", data, ops, per_op,
               divergent=True)


#: the rows, in the reference's order (its ``main``, l.812-823)
ROWS = (single_1080p, nv12_6k, circular_tensor, circular_ring_insert, warp_separable,
        warp_rotation, warp_hflip, warp_perspective, divergent_two_sequences, divergent_nv12,
        divergent_crop_resize, warp_batch8, divergent_warp_mix)


def to_device(data: Dict, device) -> Dict:
    """A row's data with every image, buffer and stack on ``device``; what
    :data:`HOST_KEYS` names stays on the host."""
    def move(v):
        if isinstance(v, list):
            return [move(x) for x in v]
        return torch.from_numpy(v).to(device)

    return {k: v if k in HOST_KEYS else move(v) for k, v in data.items()}


def fused_call(row: Row, data: Dict, device) -> Callable[[], object]:
    """One fused call of ``row`` through the port's entry points, the
    factories inside: ``execute_operations``, ``launch_divergent_batch`` or
    ``CircularTensor.update`` (returning the raw ring)."""
    if row.divergent:
        def call():
            ids, seqs = row.ops(cvgs, data)
            return cvgs.launch_divergent_batch(ids, *seqs, device=device)
        return call
    if row.ring is None:
        return lambda: cvgs.execute_operations(*row.ops(cvgs, data), device=device)
    ct = cvgs.CircularTensor(*row.ring, device=device)
    state = {"k": 0, "probe": torch.zeros((), device=device)}

    def update():
        ct.update(*row.ops(cvgs, data))
        if row.probe:  # a read of one element after each update, as the reference's
            state["probe"].add_(ct._ring[(state["k"] * 13) % row.ring[3], 0, 0, 0])
            state["k"] += 1
        return ct._ring
    return update


def row_work(row: Row, data: Dict, device):
    """``(bytes out, source bytes touched, operations)`` of the row's fused
    call (a ring update: its pipeline into one planar slot)."""
    if row.divergent:
        ids, seqs = row.ops(cvgs, data)
        return _timing.pipeline_work(seqs, device, ids)[2]
    ops = row.ops(cvgs, data)
    if row.ring is not None:
        ops = (*ops, cvgs.split_tensor())
    return _timing.pipeline_work(cvgs.build_pipeline(*ops), device)[2]


def case(row: Row, device) -> _timing.Case:
    """The row as a benchmark case on ``device``."""
    data = to_device(row.data, device)
    return _timing.Case(name=row.name, kernel=row.kernel, fused=fused_call(row, data, device),
                        per_op=lambda: row.per_op(data), work=row_work(row, data, device),
                        note=row.note(row.data), iters=row.iters, per_op_iters=row.per_op_iters)


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer repetitions at the same shapes")
    ap.add_argument("--out", default=None, help="directory of the CSVs")
    args = ap.parse_args(argv)
    runner = _timing.Runner("aux_pipelines", args.out, args.quick)
    for make in ROWS:
        runner.run(case(make(), runner.device))
    return runner.finish()


if __name__ == "__main__":
    main()
