"""Observability: profiler traces, per-stage timers, FLOPs estimation: the
port of shasta_tpu/utils/profiler.py.

- :func:`trace`: context manager around torch.profiler (CPU and CUDA
  activities), writing a Chrome trace under `log_dir`
- :func:`annotate`: a named span (record_function), the mechanism the
  port's steps use for theirs (step.sparse_trunk, step.neck, ...)
- :func:`count`, :func:`counters`, :func:`reset_counters`: named counters
  of the profiled calls (the rows each trunk stage's cap keeps or cuts)
- :class:`StageTimer`: host-side named stage timing with summaries
- :func:`cost_analysis`: FLOPs of one call from FlopCounterMode
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace('/tmp/prof'): step()` records the CPU and, where a card
    is present, its CUDA activity, and writes `log_dir/trace_<pid>_<ns>.json`
    (Chrome trace format: chrome://tracing or Perfetto). Yields the profiler,
    whose key_averages() sums the events."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region visible in profiler timelines (record_function)."""
    return record_function(name)


# name -> the values counted under it since the last reset, summed when read
_COUNTS: dict[str, list] = {}


def recording() -> bool:
    """Whether a torch profiler is recording: counters count only then."""
    return torch.autograd.profiler._is_profiler_enabled


def count(name: str, value) -> None:
    """Adds `value` to counter `name` while a profiler records, else does
    nothing. value: a host int or array, or a tensor on any device (a
    per-lane vector too); a tensor is kept where it is, with no copy to the
    host, until `counters` reads it. A caller that must build a tensor to
    count checks `recording()` first."""
    if not recording():
        return
    value = value.detach() if isinstance(value, torch.Tensor) else np.asarray(value)
    _COUNTS.setdefault(name, []).append(value)


def counters() -> dict:
    """{name: the sum of its counted values}: a number, or a list where a
    vector was counted (vectors of different lengths sum as if padded with
    zeros). The values counted on a device come to the host in one copy
    per device."""
    on_dev: dict = {}
    for vs in _COUNTS.values():
        for v in vs:
            if isinstance(v, torch.Tensor):
                on_dev.setdefault(v.device, []).append(v)
    host = {}
    for ts in on_dev.values():
        flat = torch.cat([t.reshape(-1).double() for t in ts]).cpu().numpy()
        for t, part in zip(ts, np.split(flat, np.cumsum([t.numel() for t in ts])[:-1])):
            host[id(t)] = part if t.dtype.is_floating_point else part.astype(np.int64)
    out = {}
    for name, vs in _COUNTS.items():
        parts = [host[id(v)] if isinstance(v, torch.Tensor) else v.reshape(-1) for v in vs]
        total = np.zeros(max(p.size for p in parts), np.result_type(*parts))
        for p in parts:
            total[:p.size] += p
        out[name] = total.tolist() if any(v.ndim for v in vs) else total[0].item()
    return out


def reset_counters() -> None:
    """Forgets every counted value."""
    _COUNTS.clear()


class StageTimer:
    """Accumulating host-side stage timer.

    with timer.stage("voxelize"): ...
    print(timer.summary())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """block_on: a tensor whose device the stage waits for before it
        stops the clock (the card's queue; nothing to wait for on the
        CPU)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                torch.cuda.synchronize(block_on.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in sorted(self.totals)
        }


def cost_analysis(fn, *args, **kwargs) -> dict:
    """FLOPs of fn(*args, **kwargs), counted by torch's FlopCounterMode
    over the ops it knows (matmuls, convolutions, attention: 2 per
    multiply-add); the call runs once. torch gives no estimate of the
    bytes a call moves or of its least time, so `bytes_accessed` and
    `optimal_seconds`, which XLA's cost analysis fills in the JAX
    package, are None."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": counter.get_total_flops(), "bytes_accessed": None,
            "optimal_seconds": None}
