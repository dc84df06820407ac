"""Greedy assignment: the port of shasta_tpu/tracker/greedy.py:32-44.

Row-order argmin with column invalidation (track_utils.py:3-14), kept on
the device: a Python loop over rows whose body only enqueues tensor ops,
with no host read-back. A leading lane axis (the JAX jax.vmap over
scenes, infer.py:450-453) is written out: each row's `min` and column
invalidation run for all lanes at once, so B lanes cost the launches of
one.
"""
from __future__ import annotations

import torch

INVALID = 1e18
THRESH = 1e16


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
