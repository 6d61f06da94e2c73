"""The port's profiling helpers: ``tests/test_profiling.py``'s cases bar the
differential one (CUDA events take its place, ``time_cuda``), and the
recorder's columns against the reference's."""

import csv
import inspect

import pytest
import torch

from cvgpuspeedup_tpu.utils import profiling as JP
from cvgpuspeedup_tpu_torch.utils import profiling as TP
from cvgpuspeedup_tpu_torch.utils.profiling import (BenchmarkRecorder, TimingStats,
                                                    kernel_floor_s, mark, time_fn, trace_scope)


def test_time_fn_protocol():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones((4, 4))

    stats = time_fn(fn, iters=5, warmup=2)
    assert stats.iters == 5 and len(calls) == 7
    assert stats.min <= stats.mean <= stats.max and stats.variance >= 0.0


def test_time_fn_takes_tuples_dicts_and_non_tensors():
    assert time_fn(lambda: (torch.ones(2), {"a": [torch.zeros(1)]}, 3), iters=2).iters == 2
    assert time_fn(lambda: None, iters=1, warmup=0).iters == 1


def test_trace_scope_and_mark_annotate_and_compute_nothing():
    with trace_scope("unit-test-range"):
        x = torch.ones((2, 2)) * 2
    mark("unit-test-mark")
    assert float(x[0, 0]) == 2.0
    with pytest.raises(KeyError):
        with trace_scope("a range that an error leaves"):
            raise KeyError("x")


def test_timing_stats_from_samples():
    s = TimingStats.from_samples([1.0, 2.0, 3.0])
    r = JP.TimingStats.from_samples([1.0, 2.0, 3.0])
    assert (s.mean, s.variance, s.min, s.max, s.iters) == (r.mean, r.variance, r.min, r.max, r.iters)


def test_kernel_floor():
    assert kernel_floor_s(3.35e12) == 1.0 and TP.H100_HBM_BPS == 3.35e12
    assert kernel_floor_s(3.35e12, compute_s=2.0) == 2.0
    assert kernel_floor_s(1e9, bandwidth_bps=2e9) == 0.5
    assert not hasattr(TP, "V5E_HBM_BPS") and not hasattr(TP, "differential_device_time")


def test_benchmark_recorder_csv(tmp_path):
    base = TimingStats(mean=2.0, variance=0.1, min=1.9, max=2.2, iters=10)
    fused = TimingStats(mean=0.5, variance=0.01, min=0.4, max=0.6, iters=10)
    rows = {}
    for name, module in (("port", TP), ("reference", JP)):
        path = str(tmp_path / f"{name}.csv")
        rec = module.BenchmarkRecorder(path)
        rec.add_case("batch50", module.TimingStats(**vars(base)), module.TimingStats(**vars(fused)))
        rec.add_case("with_floor", module.TimingStats(**vars(base)),
                     module.TimingStats(**vars(fused)), floor_s=0.25)
        rec.write()
        with open(path) as f:
            rows[name] = list(csv.DictReader(f))
    assert rows["port"] == rows["reference"]
    assert len(rows["port"]) == 2 and rows["port"][0]["case"] == "batch50"
    assert float(rows["port"][0]["mean_speedup"]) == 4.0
    assert float(rows["port"][1]["pct_of_floor"]) == 50.0


def test_an_empty_recorder_writes_nothing(tmp_path):
    path = tmp_path / "none.csv"
    BenchmarkRecorder(str(path)).write()
    assert not path.exists()


@pytest.mark.parametrize("name", ["time_fn", "trace_scope", "mark"])
def test_signatures_are_the_references(name):
    assert (list(inspect.signature(getattr(TP, name)).parameters)
            == list(inspect.signature(getattr(JP, name)).parameters))


def test_time_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TP.time_cuda(lambda: None)
