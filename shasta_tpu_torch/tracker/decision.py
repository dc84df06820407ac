"""ShaSTA decision rules: the port of shasta_tpu/tracker/decision.py.

Rows (prev dets, matched1 over real curr cols + [dead, FN]) flag dead
tracks and FN propagation; columns (curr dets, matched2 over kept prev
rows + [newborn, FP]) flag FP elimination and newborns
(eval.py:126-181). Fixed-shape masked argmaxes, on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DecisionOutput(NamedTuple):
    dead: torch.Tensor  # (N,) bool: prev det is a dead track
    fn: torch.Tensor  # (N,) bool: prev det propagated as FN
    fn_ref_score: torch.Tensor  # (N,) 1 - P(dead) for FN rows
    keep_prev: torch.Tensor  # (N,) bool: prev rows used in column decisions
    keep: torch.Tensor  # (N,) bool: curr det survives FP elimination
    newborn: torch.Tensor  # (N,) bool: curr det flagged newborn
    ref_score: torch.Tensor  # (N,) 1 - P(FP) per curr det


def apply_decision_rules(matched1: torch.Tensor, matched2: torch.Tensor,
                         n_prev, n_curr, fp_thresh: float = 0.7,
                         decision_thresh: float = 0.5) -> DecisionOutput:
    """matched1 (..., N, N+2) row softmax, matched2 (..., N+2, N) column
    softmax; n_prev, n_curr the real det counts (int or tensor of the
    leading shape: a lane axis of the batched pipeline). Every output has
    the leading shape followed by (N,)."""
    N, D = matched1.shape[-2:]
    dev = matched1.device
    cols = torch.arange(D, device=dev)
    rows_t = torch.arange(N + 2, device=dev)
    ar = torch.arange(N, device=dev)
    n_prev, n_curr = (n[..., None] if isinstance(n, torch.Tensor) else n
                      for n in (n_prev, n_curr))
    prev_valid = ar < n_prev
    curr_valid = ar < n_curr

    col_ok = (cols < n_curr) | (cols >= D - 2)
    m1 = torch.where(col_ok[..., None, :], matched1, float("-inf"))
    row_val, row_arg = m1.max(dim=-1)
    dead = prev_valid & (row_val > decision_thresh) & (row_arg == D - 2)
    fn = prev_valid & (row_val > decision_thresh) & (row_arg == D - 1)
    fn_ref_score = 1.0 - matched1[..., D - 2]
    keep_prev = prev_valid & ~dead & ~fn

    row_ok = (torch.cat([keep_prev, keep_prev.new_ones(keep_prev.shape[:-1] + (2,))], -1)
              & ((rows_t < n_prev) | (rows_t >= N)))
    m2 = torch.where(row_ok[..., None], matched2, float("-inf"))
    col_val, col_arg = m2.max(dim=-2)
    fp_elim = curr_valid & (col_val > fp_thresh) & (col_arg == N + 1)
    newborn = curr_valid & (col_val > decision_thresh) & (col_arg == N)
    keep = curr_valid & ~fp_elim
    ref_score = 1.0 - matched2[..., N + 1, :]
    return DecisionOutput(dead=dead, fn=fn, fn_ref_score=fn_ref_score,
                          keep_prev=keep_prev, keep=keep, newborn=newborn & keep,
                          ref_score=ref_score)
