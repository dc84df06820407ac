"""One device timer and one set of the card's peak rates, for the kernel
checks of chip_smoke.py and of the block-extraction probe.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, at its full 700
W limit): the least time a function can take is the larger of its bytes
over HBM_BYTES_PER_S and the time of its operations: a conv's products in
FLOPs over PRODUCT_FLOPS_PER_S[dtype], CUDA-core FMAs over
PEAK_OPS_PER_S["float32"], every other operation one lane instruction at
the rate of the pipe that runs it (`ops_ms`).
"""
from __future__ import annotations

import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12
# FLOP/s: bf16 on the tensor cores; f32 FMAs (two FLOPs each) off them
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# FLOP/s of f32-accurate products on the tensor cores: three TF32 passes
# (hi*hi + hi*lo + lo*hi, each operand split into two TF32 parts) at the
# data sheet's 495 TFLOP/s dense TF32, the fastest f32-accurate route
TF32X3_FLOPS_PER_S = 495e12 / 3
# the rate a conv's products are priced at, by the dtype of its operands
PRODUCT_FLOPS_PER_S = {"bfloat16": PEAK_OPS_PER_S["bfloat16"], "float32": TF32X3_FLOPS_PER_S}
# lane instructions per second: per SM and clock the f32 pipe runs 128 lanes
# and the int32 pipe 64 (NVIDIA H100 Tensor Core GPU Architecture white
# paper), on 132 SMs at the data sheet's 1.98 GHz boost clock
LANE_OPS_PER_S = {"float32": 128 * 132 * 1.98e9, "int32": 64 * 132 * 1.98e9}


def ops_ms(flops: float = 0.0, f32: float = 0.0, int32: float = 0.0) -> float:
    """Least milliseconds for `flops` f32 FMA FLOPs, `f32` other f32 lane
    instructions (adds, selects) and `int32` int32 lane instructions (compares):
    the int32 pipe's time, or all of them at the schedulers' issue rate of one
    warp instruction per SM quarter and clock (128 lanes per SM, the f32
    pipe's rate), whichever is longer."""
    issue = flops / PEAK_OPS_PER_S["float32"] + (f32 + int32) / LANE_OPS_PER_S["float32"]
    return max(issue, int32 / LANE_OPS_PER_S["int32"]) * 1e3


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
