#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernel from
``cvgpuspeedup_tpu_torch/csrc`` and drives the flagship pipeline through the
public entry points, in phases; any failure ends the run with a non-zero
exit code and no result line:

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build: compile the kernel library (timed);
3. kernel against its plain PyTorch version on the card, at the flagship
   shapes (3840x2160 u8 frame, 50 crops -> 64x128): every aspect-ratio mode,
   ragged ``used_planes``, stack mode, a uint8 chain, every write layout, a
   float32 source with rects off the frame edge. uint8 must match bit for
   bit, float32 within 1e-6;
4. the main path: ``execute_operations`` twice, the second time with the
   rects shifted; it must take the kernel, launch it once per call and build
   no new plan; the output is held against an independent float64 resize;
5. times: device time per 50-crop batch (CUDA events, median) of the kernel
   and of the plain PyTorch version, alternating plain, kernel, kernel,
   plain; the host-inclusive time of one ``execute_operations`` call, and
   the same call split into its host layers; the device's busy time and
   idle share in a ``torch.profiler`` trace of the main path; the event
   floor of a one-element launch and a device copy of the output's bytes.

The last three lines are the card's name and power limit, one JSON object
describing the kernel, and ``{"ok": true, "device": {...}}``. The script
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
F32_TOL = 1e-6      # kernel vs plain version on the card (0 expected)
ORACLE_TOL = 1e-4   # the repo's float contract against an independent resize


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def oracle_plane(frame: np.ndarray, rect, dst_w: int, dst_h: int) -> np.ndarray:
    """One crop of the flagship chain in float64, OpenCV INTER_LINEAR
    coordinates ``s = (q + 0.5) * src/dst - 0.5``; planar (C, H, W)."""
    x, y, w, h = (int(v) for v in rect)
    crop = frame[y:y + h, x:x + w].astype(np.float64)

    def axis(dst, src):
        s = (np.arange(dst) + 0.5) * (src / dst) - 0.5
        i0 = np.floor(s).astype(np.int64)
        f = s - i0
        f = np.where(i0 < 0, 0.0, f)
        i0 = np.maximum(i0, 0)
        f = np.where(i0 >= src - 1, 0.0, f)
        i0 = np.minimum(i0, src - 1)
        return i0, np.minimum(i0 + 1, src - 1), f

    x0, x1, fx = axis(dst_w, w)
    y0, y1, fy = axis(dst_h, h)
    fx = fx[None, :, None]
    fy = fy[:, None, None]
    top = crop[y0][:, x0] * (1 - fx) + crop[y0][:, x1] * fx
    bot = crop[y1][:, x0] * (1 - fx) + crop[y1][:, x1] * fx
    val = top * (1 - fy) + bot * fy
    val = (val * ALPHA - np.asarray(SUB)) / np.asarray(DIV)
    return val.transpose(2, 0, 1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cvgpuspeedup_tpu_torch as cvgs
    from cvgpuspeedup_tpu_torch.exec import _build, executor
    from cvgpuspeedup_tpu_torch.exec import cuda_batch_resize as kbr
    from cvgpuspeedup_tpu_torch.graph import flatten, map_leaves
    from cvgpuspeedup_tpu_torch.ops.arithmetic import Mul, StaticLoop
    from cvgpuspeedup_tpu_torch.ops.color import VectorReorder
    from cvgpuspeedup_tpu_torch.utils.dtypes import as_device_tensor
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
    log(f"phase2 built {_build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"phase2 ptxas: {line.strip()}")

    # ---- phase 3: kernel vs plain version on the card
    rng = np.random.default_rng(42)
    frame_np = rng.integers(0, 256, (SRC_H, SRC_W, 3), dtype=np.uint8)
    frame = torch.from_numpy(frame_np).to(dev)
    dsize = cvgs.Size(64, 128)
    rects_a = np.array([[i, i, 60, 120] for i in range(BATCH)], np.int32)
    rects_b = np.array([[i, i, 30, 120] for i in range(BATCH)], np.int32)
    chain = (cvgs.convert_to(np.float32, alpha=ALPHA), cvgs.subtract(SUB), cvgs.divide(DIV))
    max_err = 0.0

    def check(name, read, *ops):
        nonlocal max_err
        pipeline = cvgs.build_pipeline(read, *ops)
        a = kbr.prepare(pipeline, kbr.build_plan(pipeline), dev)
        got = kbr.batch_resize(a)
        want = kbr.batch_resize_reference(a)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: kernel {g.shape} {g.dtype}, plain {w.shape} {w.dtype}")
            if g.dtype == torch.uint8:
                bad = int((g != w).sum())
                if bad:
                    raise AssertionError(f"{name}: {bad} uint8 values differ")
                d = 0.0
            else:
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{name}: non-finite kernel output")
                d = float((g - w).abs().max())
            err = max(err, d)
        if err > F32_TOL:
            raise AssertionError(f"{name}: max |diff| {err} > {F32_TOL}")
        max_err = max(max_err, err)
        log(f"phase3 {name}: shape {tuple(got[0].shape)} {got[0].dtype} max|diff| {err!r}")

    check("a_ignore_ar", cvgs.resize_batch(frame, rects=rects_a, dsize=dsize),
          *chain, cvgs.split_tensor())
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

    # ---- phase 4: the main path through the public entry points
    def main_path(rects):
        return cvgs.execute_operations(
            cvgs.resize_batch(frame, rects=rects, dsize=dsize), *chain, cvgs.split_tensor(),
            device="cuda",
        )

    shifted = rects_a.copy()
    shifted[:, :2] += 7
    kbr.LAUNCHES = 0
    builds0 = executor.PLAN_BUILDS
    out1 = main_path(rects_a)
    backend1, launches1, builds1 = cvgs.last_backend(), kbr.LAUNCHES, executor.PLAN_BUILDS
    out2 = main_path(shifted)
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
    plain2 = cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=shifted, dsize=dsize), *chain, cvgs.split_tensor(),
        backend=cvgs.ParBackend.TORCH,
    )
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

    # ---- phase 5: times at the flagship shape
    rects_dev = torch.from_numpy(rects_a).to(dev)
    pipeline = cvgs.build_pipeline(cvgs.resize_batch(frame, rects=rects_dev, dsize=dsize),
                                   *chain, cvgs.split_tensor())
    # every leaf on the card, so that neither version copies from the host
    # inside the timed region
    pipeline = map_leaves(pipeline, lambda v: as_device_tensor(v, dev))
    args = kbr.prepare(pipeline, kbr.build_plan(pipeline), dev)
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = (lambda: kbr.batch_resize(args)) if which == "kernel" else (
            lambda: kbr.batch_resize_reference(args))
        samples = time_cuda(fn, iters=100)
        runs[which] += samples
        log(f"phase5 {which}: median {np.median(samples) * 1e3:.2f} us/batch over {len(samples)} runs")
    kernel_ms = float(np.median(runs["kernel"]))
    plain_ms = float(np.median(runs["plain"]))

    # one execute_operations call, whole and taken apart into its host
    # layers in its own order, alternating in one loop
    parts = {"whole": [], "build_pipeline": [], "flatten+plan": [], "prepare": [], "launch": [],
             "sync": []}
    for _ in range(110):
        t0 = time.perf_counter()
        main_path(rects_a)
        torch.cuda.synchronize()
        parts["whole"].append(time.perf_counter() - t0)
        t = [time.perf_counter()]
        p = cvgs.build_pipeline(cvgs.resize_batch(frame, rects=rects_a, dsize=dsize), *chain,
                                cvgs.split_tensor())
        t.append(time.perf_counter())
        key, leaves = flatten(p)
        d = executor._resolve_device(leaves, "cuda")
        plan = executor._plan(p, key, cvgs.ParBackend.AUTO, d)
        t.append(time.perf_counter())
        a = kbr.prepare(p, plan.kernel, d)
        t.append(time.perf_counter())
        kbr.batch_resize(a)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, t0, t1 in zip(list(parts)[1:], t, t[1:]):
            parts[k].append(t1 - t0)
    host_ms = float(np.median(parts["whole"][10:])) * 1e3
    log(f"phase5 kernel {kernel_ms * 1e3:.2f} us/batch, plain torch {plain_ms * 1e3:.2f} us/batch "
        f"(device time, median of {len(runs['kernel'])}); execute_operations host-inclusive "
        f"{host_ms * 1e3:.2f} us/call; card {card}")
    log("phase5 host layers, us/call, median of 100: "
        + ", ".join(f"{k} {np.median(v[10:]) * 1e6:.2f}" for k, v in parts.items()))

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

    for mod in ("jax", "cv2"):
        assert mod not in sys.modules, f"{mod} was imported"
    print(card)
    print(json.dumps({"kernels": [{
        "name": "batch_resize",
        "route": "cuda",
        "source": "cvgpuspeedup_tpu_torch/csrc/batch_resize.cu",
        "replaces": "cvgpuspeedup_tpu/exec/pallas_backend.py:500",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
