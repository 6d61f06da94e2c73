"""The port's benchmark scripts (``cvgpuspeedup_tpu_torch/benchmarks``) on the
CPU, at 1/8 of their edges: what each case computes, not how fast.

- Each of the 13 ``aux_pipelines`` rows, the ``vertical_fusion`` chain and
  the ``host_overhead`` pipeline: the port's fused pipeline (the kernel's
  plain version, on CPU tensors) against the JAX package's same pipeline,
  built with its own factories from the same seeded inputs and lowered op by
  op outside jit (``Pipeline.lower()``, ``ParBackend.XLA``'s ops; the merge
  loop for a divergent batch): uint8 bit for bit, float32 within 1e-4 on
  values of 0..255; and the fused output against the case's own per-op step.
- The numpy warp matrices against ``cv2.getRotationMatrix2D`` and
  ``cv2.getPerspectiveTransform``.
- The protocol's rows: ``BenchmarkRecorder`` columns, the physical-row
  checks refusing a 5 ps row and a one-sample row, the output check.
- ``utils/bounds.py`` against the numbers ``chip_smoke.py`` computed for the
  same plans before the byte counts moved there; ``profiler_ms``'s retries.
- ``scaling --cpu`` over gloo in two processes.
"""

import math
import sys
import time
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.benchmarks import _timing
from cvgpuspeedup_tpu_torch.benchmarks import aux_pipelines as aux
from cvgpuspeedup_tpu_torch.benchmarks import host_overhead, vertical_fusion
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.utils import bounds, profiling

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DIVISOR = 8
F32_TOL = 1e-4
GLOO_TIMEOUT_S = 60


def _host(x):
    x = x[0] if isinstance(x, tuple) else x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_matches(port, ref, what):
    port, ref = _host(port), _host(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (
        f"{what}: {port.shape} {port.dtype} vs {ref.shape} {ref.dtype}")
    if port.dtype == np.uint8:
        assert np.array_equal(port, ref), f"{what}: uint8 values differ"
    else:
        d = float(np.abs(port.astype(np.float64) - ref.astype(np.float64)).max())
        assert d <= F32_TOL, f"{what}: max |diff| {d}"


def reference_merge(ids, *seqs):
    """The reference's merge loop (its ``executor.py:364-381``) outside jit."""
    groups = {}
    for z, sid in enumerate(ids):
        groups.setdefault(sid, []).append(z)
    merged = None
    for sid, planes in groups.items():
        x = seqs[sid - 1].read.lower_planes(tuple(planes))
        for o in seqs[sid - 1].compute:
            x = o.apply(x)
        if merged is None:
            merged = jnp.zeros((len(ids),) + x.shape[1:], dtype=x.dtype)
        merged = merged.at[jnp.asarray(planes)].set(x)
    return seqs[0].write.write(merged)


def _reference(row):
    """The JAX package's lowering of a row's fused pipeline, op by op."""
    if row.divergent:
        ids, seqs = row.ops(J, row.data)
        return reference_merge(ids, *seqs)
    ops = row.ops(J, row.data)
    if row.ring is not None:  # the ring's slot: the pipeline written planar
        ops = (*ops, J.split_tensor())
    return J.build_pipeline(*ops).lower()


@pytest.mark.parametrize("make", aux.ROWS, ids=lambda m: m.__name__)
def test_aux_rows_equal_the_reference_and_their_per_op_step(make):
    row = make(DIVISOR)
    data = aux.to_device(row.data, CPU)
    fused = aux.fused_call(row, data, CPU)()
    if row.ring is not None:
        assert executor.last_backend() == "torch"
        port = fused[0]  # the first update's slot
    else:
        assert executor.last_backend() == ("torch:divergent" if row.divergent else "torch")
        port = fused
    _assert_matches(port, _reference(row), f"{row.name} vs the reference's lowering")
    # the fused output equals the case's per-op step on the same inputs
    assert _timing.max_diff(fused, row.per_op(data), row.name) <= F32_TOL
    # on the card the row takes its kernel: the plan is made on shapes alone
    if row.divergent:
        ids, seqs = row.ops(T, data)
        got = executor._select_divergent(seqs, ids, T.ParBackend.AUTO, torch.device("cuda"))
    else:
        ops = row.ops(T, data) + ((T.split_tensor(),) if row.ring else ())
        got = executor._select(T.build_pipeline(*ops), T.ParBackend.AUTO, torch.device("cuda"))
    assert got.backend == row.kernel
    out_bytes, src_bytes, flops = aux.row_work(row, data, CPU)
    assert out_bytes > 0 and src_bytes >= 0 and flops > 0


def test_all_13_reference_rows_under_their_names():
    names = [make(DIVISOR).name for make in aux.ROWS]
    assert len(set(names)) == 13
    text = (ROOT / "benchmarks" / "aux_pipelines.py").read_text()
    for name in names:
        assert f'"{name}"' in text, name


def test_the_rotation_row_misses_the_frame():
    """The reference's rotation (l.471) keeps its uncentred map: the share of
    output pixels that read the frame is printed beside the row."""
    row = aux.warp_rotation()
    assert aux.in_frame_share(row.data["m"], (1080, 1920), (640, 360)) == 0.0
    assert "0.0000 of the output pixels" in row.note(row.data)
    centred = row.data["m"].copy()
    centred[:, 2] += (320 - 960, 180 - 540)
    assert aux.in_frame_share(centred, (1080, 1920), (640, 360)) > 0.9


@pytest.mark.parametrize("edge", vertical_fusion.RESOLUTIONS)
def test_vertical_fusion_chain_equals_the_reference(edge):
    img = vertical_fusion.source(edge, DIVISOR)
    x = torch.from_numpy(img)
    port = T.execute_operations(*vertical_fusion.fused_ops(T, x, 200), device="cpu")[..., 0]
    ref = J.build_pipeline(J.image(img[..., None]),
                           vertical_fusion.fused_chain(J, 200)).lower()[..., 0]
    _assert_matches(port, ref, f"{edge}x{edge}")
    assert _timing.max_diff(port, vertical_fusion.per_op(x, 200), "per-op") <= F32_TOL
    plan = executor._select(T.build_pipeline(*vertical_fusion.fused_ops(T, x, 200)),
                            T.ParBackend.AUTO, torch.device("cuda"))
    assert plan.backend == "cuda:pointwise" and plan.kernel.ops.shape[0] == 200


def test_host_overhead_pipeline_equals_the_reference():
    frame, rects = host_overhead.inputs(DIVISOR)
    port = T.execute_operations(*host_overhead.ops(T, frame, rects), device="cpu")
    _assert_matches(port, J.build_pipeline(*host_overhead.ops(J, frame, rects)).lower(),
                    "host_overhead")
    full_frame, full_rects = host_overhead.inputs()
    assert full_frame.shape == (296, 384, 3) and full_rects.shape == (16, 4)
    plan = executor._select(T.build_pipeline(*host_overhead.ops(T, frame, rects)),
                            T.ParBackend.AUTO, torch.device("cuda"))
    assert plan.backend == "cuda:batch_resize" and plan.module.launch is plan.module.batch_resize


@pytest.mark.parametrize("center,angle,scale", [
    ((960, 540), 10.0, 1 / 3.0), ((960, 540), -10.0, 1.0), ((960, 540), 11.0, 1.28),
    ((384, 256), -14.0, 1.0), ((384, 256), 14.0, 1.0), ((120, 67.5), 10.0, 1 / 3.0),
    ((0.5, 33.25), 123.456, 0.7),
])
def test_rotation_matrix_equals_cv2(center, angle, scale):
    np.testing.assert_array_equal(aux.get_rotation_matrix_2d(center, angle, scale),
                                  cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("divisor", [1, 8])
def test_perspective_transform_equals_cv2(divisor):
    h, w = 1080 // divisor, 1920 // divisor
    src = np.float32([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]])
    dst = np.float32([[20, 10], [620, 25], [8, 370], [630, 380]]) / divisor
    np.testing.assert_allclose(aux.get_perspective_transform(src, dst),
                               cv2.getPerspectiveTransform(src, dst), rtol=1e-12, atol=1e-15)
    if divisor == 1:  # the matrix chip_smoke.py's W5 holds
        import chip_smoke

        np.testing.assert_allclose(aux.get_perspective_transform(src, dst),
                                   chip_smoke.PERSPECTIVE_W5, rtol=1e-12, atol=1e-15)


def test_recorder_rows_and_the_physical_checks(tmp_path):
    rec = profiling.BenchmarkRecorder(str(tmp_path / "rows.csv"))
    rec.add_case("ok", profiling.TimingStats.from_samples([4e-5, 5e-5]),
                 profiling.TimingStats.from_samples([4e-6, 6e-6]), floor_s=2e-6)
    _timing.check_physical(rec)
    rec.write()
    header = (tmp_path / "rows.csv").read_text().splitlines()[0].split(",")
    assert header == ["case", "baseline_mean_s", "baseline_var", "baseline_max_s",
                      "baseline_min_s", "fused_mean_s", "fused_var", "fused_max_s",
                      "fused_min_s", "mean_speedup", "analytic_floor_s", "pct_of_floor"]
    assert rec.rows[0]["mean_speedup"] == pytest.approx(9.0)
    assert rec.rows[0]["pct_of_floor"] == 40.0
    # a 5 ps fused time (the reference's clamped differential) is refused
    five_ps = profiling.BenchmarkRecorder("unused.csv")
    five_ps.add_case("5ps", profiling.TimingStats.from_samples([1e-5, 2e-5]),
                     profiling.TimingStats.from_samples([5e-12, 5e-12 + 1e-13]))
    with pytest.raises(AssertionError, match="impossible fused time"):
        _timing.check_physical(five_ps)
    # so is a row of one sample (variance 0)
    single = profiling.BenchmarkRecorder("unused.csv")
    single.add_case("one", profiling.TimingStats.from_samples([1e-5, 2e-5]),
                    profiling.TimingStats.from_samples([3e-6]))
    with pytest.raises(AssertionError, match="single-rep"):
        _timing.check_physical(single)
    fast = profiling.BenchmarkRecorder("unused.csv")
    fast.add_case("fast", profiling.TimingStats.from_samples([1.0, 2.0]),
                  profiling.TimingStats.from_samples([1e-5, 2e-5]))
    with pytest.raises(AssertionError, match="impossible speedup"):
        _timing.check_physical(fast)


def test_output_check():
    a = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    assert _timing.max_diff(a, a.clone(), "u8") == 0.0
    with pytest.raises(AssertionError, match="uint8 values differ"):
        _timing.max_diff(a, a + 1, "u8")
    f = torch.linspace(0, 255, 12).reshape(3, 4)
    assert _timing.max_diff(f, f + 5e-5, "f32") == pytest.approx(5e-5, rel=0.1)
    with pytest.raises(AssertionError, match="max \\|diff\\|"):
        _timing.max_diff(f, f + 2e-4, "f32")
    with pytest.raises(AssertionError):
        _timing.max_diff(f, f.double(), "dtype")
    with pytest.raises(AssertionError, match="non-finite"):
        _timing.max_diff(f / 0, f, "nan")


def test_benchmarks_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _timing.require_card()
    for module in (vertical_fusion, aux, host_overhead):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            module.main(["--quick"])


# --- utils/bounds.py: the byte counts chip_smoke.py computed before they moved ---

#: source bytes touched, as chip_smoke.py computed them for its phase-5
#: plans on the CPU (output bytes and operations follow from the shapes);
#: the frame kernel's leave out a second tap of weight 0 under the edge
#: rule (``bounds.axis_reads``): frames (a) and (b), exact 3:1 resizes, read
#: every output's first tap alone, half the rows and columns a tap table
#: names (4,147,200 and 21,772,800 bytes before)
MOVED_SOURCE_BYTES = {
    "crop_flagship": 52384, "crop_flagship_used37": 41984, "frame_a": 2073600,
    "frame_b": 12441600, "w1_k3_separable": 1909696, "w2_k4_rotation": 5680320,
    "w5_k5a_perspective_640x384": 4499328, "w6_k5b_batch8_ragged7": 926816,
    "d1_circular_first3": 1572864, "d2_nv12_bt709": 1179648, "d3_crop_resize": 356736,
    "d4_warp_crop_pass": 309280,
}


def test_bounds_equal_what_chip_smoke_computed():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    rng = np.random.default_rng(42)
    frame = torch.from_numpy(rng.integers(0, 256, (cs.SRC_H, cs.SRC_W, 3), dtype=np.uint8))
    rects = np.array([[i, i, 60, 120] for i in range(cs.BATCH)], np.int32)
    hd = torch.from_numpy(rng.integers(0, 256, (cs.FRAME_H, cs.FRAME_W, 3), dtype=np.uint8))
    nv12 = torch.from_numpy(rng.integers(0, 256, (cs.NV12_H * 3 // 2, cs.NV12_W), dtype=np.uint8))
    work = {
        "crop_flagship": _timing.pipeline_work(
            T.build_pipeline(*cs.flagship_ops(T, frame, rects)), CPU)[2],
        "crop_flagship_used37": _timing.pipeline_work(
            T.build_pipeline(*cs.flagship_ops(T, frame, rects, used=37)), CPU)[2],
        "frame_a": _timing.pipeline_work(T.build_pipeline(*cs.frame_a_ops(T, hd)), CPU)[2],
        "frame_b": _timing.pipeline_work(T.build_pipeline(*cs.frame_b_ops(T, nv12)), CPU)[2],
    }
    for name, ops in cs.timed_warp_cases(T, T.image(hd)).items():
        work[name] = _timing.pipeline_work(T.build_pipeline(*ops), CPU)[2]
    rows = cs.DivergentRows(T, CPU, frame)
    for name, (ids, seqs) in rows.timed().items():
        work[name] = _timing.pipeline_work(seqs, CPU, ids)[2]
    assert {k: w[1] for k, w in work.items()} == MOVED_SOURCE_BYTES
    # K1's flagship and the MAD chain's bounds, to the last digit
    k1 = bounds.bound(*work["crop_flagship"], 2962.3e9)
    assert k1 == {"bound_ms": 0.001482860895522388, "bound_by": "bytes",
                  "floor_ms": 0.0016769348141646694, "out_bytes": 4915200,
                  "src_bytes_touched": 52384, "flops": 18432000}
    assert bounds.bound(16777216, 16777216, 4194304 * 200, 2950.6e9) == {
        "bound_ms": 0.02504062089552239, "bound_by": "operations",
        "floor_ms": 0.011372070765268081, "out_bytes": 16777216,
        "src_bytes_touched": 16777216, "flops": 838860800}
    assert math.isclose(bounds.floor_s(k1), k1["floor_ms"] * 1e-3)
    # one operation rate for every kernel (all built without FMA): each of
    # these rows was bound by bytes at either rate, so its bound stands
    for name, w in work.items():
        b = bounds.bound(*w, 2962.3e9)
        assert b["bound_by"] == "bytes", name
        assert b["bound_ms"] == (w[0] + w[1]) / bounds.PEAK_BYTES_PER_S * 1e3, name


def test_every_kernel_module_prices_and_launches_under_one_name():
    from cvgpuspeedup_tpu_torch.exec import (cuda_batch_resize, cuda_composed, cuda_divergent,
                                             cuda_divergent_split, cuda_frame_resize,
                                             cuda_pointwise, cuda_warp)

    modules = {"cuda:batch_resize": cuda_batch_resize, "cuda:frame_resize": cuda_frame_resize,
               "cuda:warp": cuda_warp, "cuda:divergent": cuda_divergent,
               "cuda:pointwise": cuda_pointwise, "cuda:composed": cuda_composed,
               "cuda:divergent:split": cuda_divergent_split}
    for name, module in modules.items():
        assert callable(module.work), name
        assert module.launch is getattr(module, "_".join(name.split(":")[1:])), name
    counts = executor.launch_counts()
    assert counts == {name: m.LAUNCHES for name, m in modules.items()}
    # a CPU call runs the plain version: no kernel's count moves
    T.execute_operations(*host_overhead.ops(T, *host_overhead.inputs(DIVISOR)), device="cpu")
    assert executor.launch_counts() == counts


# --- profiler_ms: empty traces are taken again, then the case is named ---


class _FakeProfile:
    """A ``torch.profiler.profile`` whose first ``empty`` traces hold no
    device event, the later ones 20 events of 2 us."""

    def __init__(self, empty):
        self.left = empty

    def __call__(self, activities):
        fake = self

        class _Trace:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                if fake.left > 0:
                    fake.left -= 1
                    return []
                span = type("Span", (), {"elapsed_us": lambda self: 2.0})()
                event = type("Event", (), {"device_type": torch.autograd.DeviceType.CUDA,
                                           "time_range": span})()
                return [event] * 20

        return _Trace()


@pytest.mark.parametrize("empty", [0, 3, 7, 8])
def test_profiler_ms_retries_empty_traces(monkeypatch, empty):
    """Up to eight traces, each empty one logged and taken again after a
    pause; after eight the run fails, naming the case."""
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile(empty))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    heard = []
    if empty == 8:
        with pytest.raises(RuntimeError, match="for the case: all 8 traces of 20 calls"):
            profiling.profiler_ms(lambda: None, what="the case", log=heard.append)
        return
    assert profiling.profiler_ms(lambda: None, what="the case", log=heard.append) == 2e-3
    assert heard == ([f"torch.profiler: {empty} empty trace(s) of the case before this one"]
                     if empty else [])


def test_chip_smoke_takes_the_moved_functions():
    text = (ROOT / "chip_smoke.py").read_text()
    for gone in ("def crop_touched_bytes", "def warp_touched_bytes", "def touched_bytes",
                 "def sectors", "def bound(", "PEAK_BYTES_PER_S ="):
        assert gone not in text, gone
    assert "profiling.profiler_ms(" in text
    for k, args in (("kbr", "args"), ("kfr", "fargs"), ("kw", "wargs"), ("kd", "dargs"),
                    ("kp", "pargs")):
        assert f"bounds.bound(*{k}.work({args}), bandwidth)" in text, k
    assert "host_overhead.host_layers(" in text


# --- scaling --cpu over gloo, two processes ---


def test_scaling_cpu_over_gloo_two_processes(tmp_path):
    import torch_benchmarks_worker

    world = 2
    ctx = mp.start_processes(torch_benchmarks_worker.run,
                             args=(world, str(tmp_path / "store"), str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the two gloo processes did not finish in {GLOO_TIMEOUT_S} s")
    for rank in range(world):
        rows = eval((tmp_path / f"rank{rank}.txt").read_text())
        assert [r["case"] for r in rows] == ["shards_1", "shards_2"]
        assert [r["batch"] for r in rows] == [4, 8]
        assert all(r["max_abs_diff"] == 0.0 and r["images_per_s"] > 0 for r in rows)
        assert rows[0]["scaling_efficiency"] == 1.0 and "core_bound_efficiency" in rows[1]
