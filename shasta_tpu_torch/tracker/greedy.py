"""Greedy assignment: the port of shasta_tpu/tracker/greedy.py.

Row-order argmin with column invalidation (track_utils.py:3-14), twice:
- `greedy_assign_np`, the numpy host version the host trackers
  (tracker/pub_tracker.py) call (greedy.py:18-30);
- `greedy_assign`, kept on the device (greedy.py:32-44): a Python loop
  over rows whose body only enqueues tensor ops, with no host read-back.
  A leading lane axis (the JAX jax.vmap over scenes, infer.py:450-453) is
  written out: each row's `min` and column invalidation run for all lanes
  at once, so B lanes cost the launches of one.
"""
from __future__ import annotations

import numpy as np
import torch

INVALID = 1e18
THRESH = 1e16


def greedy_assign_np(dist: np.ndarray) -> np.ndarray:
    """dist (N, M) -> (K, 2) int32 matched [row, col] pairs in row order:
    row i takes the first minimum of its row, if it is < THRESH, and its
    column is then set to INVALID for the rows after it."""
    if dist.shape[0] == 0 or dist.shape[1] == 0:
        return np.zeros((0, 2), np.int32)
    d = dist.copy()
    out = []
    for i in range(d.shape[0]):
        j = int(d[i].argmin())
        if d[i, j] < THRESH:
            d[:, j] = INVALID
            out.append([i, j])
    return np.array(out, np.int32).reshape(-1, 2)


def greedy_assign(dist: torch.Tensor) -> torch.Tensor:
    """dist (..., N, M), at most one leading lane axis -> (..., N) int64
    column per row, -1 if unmatched. Row i takes the first minimum over the
    columns still free, if it is < THRESH.

    A taken column carries +INVALID: its distance then stays >= THRESH,
    so the minimum over all columns is the minimum over the free ones
    whenever it is < THRESH, and a row with no free column below THRESH
    matches nothing, as in the JAX scan."""
    lanes = dist if dist.dim() == 3 else dist[None]
    B, N, M = lanes.shape
    taken = torch.zeros((B, M), dtype=dist.dtype, device=dist.device)
    # row-major (N, B): row i's results are one contiguous `out=` target
    vals = torch.empty((N, B), dtype=dist.dtype, device=dist.device)
    cols = torch.empty((N, B), dtype=torch.int64, device=dist.device)
    for i in range(N):
        torch.min(lanes[:, i] + taken, dim=1, out=(vals[i], cols[i]))
        taken.scatter_add_(1, cols[i, :, None], ((vals[i] < THRESH) * INVALID)[:, None])
    match = torch.where(vals < THRESH, cols, -1).T
    return match if dist.dim() == 3 else match[0]
