"""One device timer and one set of the card's peak rates, for the kernel
checks of chip_smoke.py and of the block-extraction probe.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, at its full 700
W limit): the least time a function can take is the larger of its bytes
over HBM_BYTES_PER_S and its operations over PEAK_OPS_PER_S[type].
"""
from __future__ import annotations

import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12
# bf16 on the tensor cores; f32 off them; integer compares at the CUDA-core
# rate of the f32 row
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int32": 67e12}


def median_ms(fn, reps: int = 10, on_card: bool = True) -> float:
    """Median milliseconds of `reps` calls of `fn`. On the card each call
    lies between two CUDA events, and a spin kernel ahead of them holds the
    stream until all are queued, so the host's launch cost stays out. Off
    the card, the host's time of each call."""
    fn()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    if not on_card:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    # cycles at ~2 GHz: twice the host's time to queue the calls, 10 ms at least
    torch.cuda._sleep(max(20_000_000, int(4e9 * host_s * reps)))
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)
