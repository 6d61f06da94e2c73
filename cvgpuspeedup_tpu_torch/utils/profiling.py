"""Device timing with CUDA events.

Counterpart of ``cvgpuspeedup_tpu/utils/profiling.py``, reduced to
:func:`time_cuda`. It runs only on a CUDA device; without one it raises.
"""

from __future__ import annotations

import time
from typing import Callable, List

import torch

#: cycles per second assumed when sizing the priming sleep; above any
#: Hopper SM clock, so the sleep lasts at least as long as intended
_ASSUMED_CLOCK_HZ = 2.0e9


def time_cuda(fn: Callable[[], object], iters: int = 100, warmup: int = 10) -> List[float]:
    """Device time of ``fn()`` in ms, one sample per call.

    Each sample queues a sleep kernel on the current stream, then a start
    event, ``fn()`` and an end event. The sleep outlasts the host's time to
    queue ``fn()``, so the events bracket the device work alone, with no gap
    left by the host. Take the median of the samples.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(max(4 * host_s, 1e-4) * _ASSUMED_CLOCK_HZ)
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]
