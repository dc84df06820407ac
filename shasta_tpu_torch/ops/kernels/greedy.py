"""greedy_rows: the scan tracker's greedy assignment in one launch on the
card, for every lane at once. It replaces no Pallas kernel: the JAX package
runs the assignment as a `lax.scan` over rows (`greedy_assign_jax`,
shasta_tpu/tracker/greedy.py), which the port's plain version
(`tracker.greedy.greedy_assign_plain`) writes as a host loop of a few small
launches a row.

    greedy_rows(dist (B, N, M) f32, contiguous, on a CUDA device)
      -> (B, N) int64: a column per row, or -1

Bit for bit the plain version: rows in order, row i takes the lowest column
among the columns of least value that no earlier row of its lane took, if
that value is < THRESH; a row with none, or with a NaN, gets -1. Exact
wherever no entry lies below THRESH - INVALID (the tracker's distances are
>= 0). What bounds the kernel (csrc/greedy.cu) is the chain of rows, not
bytes: one block a lane compacts each row's entries below THRESH in
parallel, then one warp decides the rows in order against a bitmap of the
taken columns in shared memory.

`tracker.greedy.greedy_assign` takes this route for a CUDA tensor. Each
launch adds one to `greedy_rows.launches` and counts one under
"tracker.greedy_launches" (`utils.profiler.count`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.profiler import count

MAX_COLUMNS = 1 << 20  # the taken bitmap lives in shared memory


@functools.cache
def _launch_fn():
    from .build import library

    fn = library("greedy").greedy_rows_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def greedy_rows(dist: torch.Tensor) -> torch.Tensor:
    if not dist.is_cuda:
        raise ValueError(f"greedy_rows runs on a CUDA device, got {dist.device}")
    if dist.dim() != 3 or dist.dtype != torch.float32 or not dist.is_contiguous():
        raise ValueError(f"greedy_rows takes a contiguous (B, N, M) float32 tensor, got "
                         f"{dist.dtype} {tuple(dist.shape)} contiguous={dist.is_contiguous()}")
    B, N, M = dist.shape
    if M > MAX_COLUMNS or B * N >= 2**31:
        raise ValueError(f"greedy_rows takes at most {MAX_COLUMNS} columns and 2**31 rows, got "
                         f"{tuple(dist.shape)}")
    if B == 0 or N == 0 or M == 0:  # nothing to launch: no row has a column
        return torch.full((B, N), -1, dtype=torch.int64, device=dist.device)
    cand = torch.empty((B, N, M), dtype=torch.int64, device=dist.device)
    rows = torch.empty((B, N), dtype=torch.int32, device=dist.device)
    match = torch.empty((B, N), dtype=torch.int64, device=dist.device)
    err = _launch_fn()(dist.data_ptr(), B, N, M, cand.data_ptr(), rows.data_ptr(),
                       match.data_ptr(),
                       ctypes.c_void_p(torch.cuda.current_stream(dist.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"greedy_rows launch failed: CUDA error {err}")
    greedy_rows.launches += 1
    count("tracker.greedy_launches", 1)
    return match


greedy_rows.launches = 0
