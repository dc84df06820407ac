"""Greedy assignment: the port of shasta_tpu/tracker/greedy.py:32-44.

Row-order argmin with column invalidation (track_utils.py:3-14), kept on
the device: a Python loop over rows whose body only enqueues tensor ops,
with no host read-back.
"""
from __future__ import annotations

import torch

INVALID = 1e18
THRESH = 1e16


def greedy_assign(dist: torch.Tensor) -> torch.Tensor:
    """dist (N, M) -> (N,) int64 column per row, -1 if unmatched. Row i takes
    the first minimum over the columns still free, if it is < THRESH.

    A taken column carries +INVALID: its distance then stays >= THRESH,
    so the minimum over all columns is the minimum over the free ones
    whenever it is < THRESH, and a row with no free column below THRESH
    matches nothing, as in the JAX scan."""
    N, M = dist.shape
    taken = torch.zeros((M,), dtype=dist.dtype, device=dist.device)
    vals = torch.empty((N,), dtype=dist.dtype, device=dist.device)
    cols = torch.empty((N,), dtype=torch.int64, device=dist.device)
    for i in range(N):
        torch.min(dist[i] + taken, dim=0, out=(vals[i], cols[i]))
        taken.index_add_(0, cols[i:i + 1], (vals[i:i + 1] < THRESH) * INVALID)
    return torch.where(vals < THRESH, cols, -1)
