"""Decision rules, greedy assignment and the scan tracker: frozen copies of
the port's plain torch versions (shasta_tpu_torch/tracker/decision.py,
greedy.py and scan_tracker.py), with the step's bookkeeping around them
(the dead flags, the FN rows, the packed outputs) of shasta_tpu_torch/infer.py.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e18
INVALID = 1e18
THRESH = 1e16

# the nuScenes tracking classes and the merged tracker's per-class tables
NAMES = ["bicycle", "bus", "car", "motorcycle", "pedestrian", "trailer", "truck"]
GATES = {"car": 2, "truck": 2, "bus": 4, "trailer": 2, "pedestrian": 0.75, "motorcycle": 2,
         "bicycle": 1.5}
REFINE = {"bicycle": (0.5, 0.4), "bus": (0.5, 0.7), "car": (0.5, 0.5), "motorcycle": (0.5, 0.5),
          "pedestrian": (0.5, 0.5), "trailer": (0.5, 0.4), "truck": (0.5, 0.5)}

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


class TrackTable(NamedTuple):
    ct: torch.Tensor  # (CAP, 2)
    tracking: torch.Tensor  # (CAP, 2) last motion (-v*lag)
    cls: torch.Tensor  # (CAP,) int32
    tid: torch.Tensor  # (CAP,) int32 tracking id
    age: torch.Tensor  # (CAP,) int32
    active: torch.Tensor  # (CAP,) int32 consecutive-hit counter
    ref_score: torch.Tensor  # (CAP,)
    dead: torch.Tensor  # (CAP,) bool: det carried the ShaSTA dead flag
    used: torch.Tensor  # (CAP,) bool

    @staticmethod
    def empty(cap: int, device) -> "TrackTable":
        z = dict(device=device)
        return TrackTable(
            ct=torch.zeros((cap, 2), **z),
            tracking=torch.zeros((cap, 2), **z),
            cls=torch.full((cap,), -1, dtype=torch.int32, **z),
            tid=torch.zeros((cap,), dtype=torch.int32, **z),
            age=torch.zeros((cap,), dtype=torch.int32, **z),
            active=torch.zeros((cap,), dtype=torch.int32, **z),
            ref_score=torch.zeros((cap,), **z),
            dead=torch.zeros((cap,), dtype=torch.bool, **z),
            used=torch.zeros((cap,), dtype=torch.bool, **z),
        )


class FrameDets(NamedTuple):
    """Per-frame fixed-shape det rows (N, padded, class-major order)."""

    ct: torch.Tensor  # (N, 2) raw centers
    velocity: torch.Tensor  # (N, 2)
    cls: torch.Tensor  # (N,) int32, -1 for padding
    score: torch.Tensor  # (N,)
    ref_score: torch.Tensor  # (N,) decision-rule refined score
    newborn: torch.Tensor  # (N,) bool
    dead: torch.Tensor  # (N,) bool
    valid: torch.Tensor  # (N,) bool


class TrackerParams(NamedTuple):
    gates: torch.Tensor  # (C,) per-class center gate
    alpha: torch.Tensor  # (C,)
    beta: torch.Tensor  # (C,)
    refine: torch.Tensor  # (C,) bool
    max_age: int
    merged_mode: bool = True


def _flag_at(size: int, index: torch.Tensor) -> torch.Tensor:
    """(B, size) bool, True at the (B, n) `index` entries < size of each
    lane (entries == size drop)."""
    out = torch.zeros((index.shape[0], size + 1), dtype=torch.bool, device=index.device)
    out.scatter_(1, index.long(), True)
    return out[:, :size]


def step_frame(table: TrackTable, id_count: torch.Tensor, dets: FrameDets,
               time_lag: torch.Tensor, params: TrackerParams):
    """One tracking step of one scene: the B=1 case of `step_frames`.
    Returns (new_table, id_count, det_tid, det_used, det_refsc); id_count
    is a 0-dim int32 tensor."""
    new_table, id_count, tid, used, ref = step_frames(
        TrackTable(*(t[None] for t in table)), id_count.reshape(1),
        FrameDets(*(d[None] for d in dets)), torch.as_tensor(time_lag).reshape(1),
        params)
    return TrackTable(*(t[0] for t in new_table)), id_count[0], tid[0], used[0], ref[0]


def step_frames(table: TrackTable, id_count: torch.Tensor, dets: FrameDets,
                time_lag: torch.Tensor, params: TrackerParams):
    """One tracking step of B scene lanes (the JAX jax.vmap over scenes,
    infer.py:407-421, written out as a leading lane axis): table fields
    (B, CAP, ...), id_count (B,) int32, det fields (B, N, ...), time_lag
    (B,). Returns (new_table, id_count, det_tid, det_used, det_refsc)."""
    new_table, n_new, tid, used, ref, _ = step_frames_core(table, id_count, dets,
                                                           time_lag, params)
    return new_table, id_count + n_new, tid, used, ref


def step_frames_core(table: TrackTable, id_count: torch.Tensor, dets: FrameDets,
                     time_lag: torch.Tensor, params: TrackerParams):
    """`step_frames` internals (scan_tracker.py:95-200 of the JAX package,
    step_frame_core, with a lane axis): returns (new_table, n_new (B,),
    det_tid, det_used, det_refsc, is_new (B, N)). With id_count 0 the new
    ids are relative (1 + rank within the lane's frame); the fused
    multi-class step rebases them by the global count plus the preceding
    classes' n_new."""
    B, N = dets.ct.shape[:2]
    CAP = table.ct.shape[1]

    tracking = -dets.velocity * time_lag[:, None, None]
    q = dets.ct + tracking  # back-projected det centers
    cls_c = dets.cls.clamp(min=0).long()
    gate = params.gates[cls_c]

    diff = q[:, :, None, :] - table.ct[:, None, :, :]
    dist = torch.sqrt((diff * diff).sum(-1))  # (B, N, CAP)
    invalid = ((dets.cls[:, :, None] != table.cls[:, None, :])
               | ~table.used[:, None, :] | ~dets.valid[:, :, None]
               | (dist > gate[:, :, None]))
    dist = torch.where(invalid, BIG, dist)

    match = greedy_assign(dist)  # (B, N) track slot or -1
    matched = match >= 0
    mslot = match.clamp(min=0)

    prev_ref = table.ref_score.gather(1, mslot)
    prev_active = table.active.gather(1, mslot)
    alpha = params.alpha[cls_c]
    beta = params.beta[cls_c]
    refine = params.refine[cls_c]
    refined = (dets.ref_score > alpha) * beta * dets.score + (1 - beta) * prev_ref
    matched_ref = torch.where(refine, refined, dets.score)

    near_track = dist.min(dim=2).values <= gate
    suppressed = ~matched & ~dets.newborn & near_track
    is_new = dets.valid & ~matched & ~suppressed
    new_rank = torch.cumsum(is_new.to(torch.int32), 1).to(torch.int32) - 1
    new_tid = id_count[:, None] + 1 + new_rank
    n_new = is_new.to(torch.int32).sum(1).to(torch.int32)
    new_ref = torch.where(refine & params.merged_mode, beta * dets.score, dets.score)

    det_used = matched | is_new
    zero_i = torch.zeros_like(new_tid)
    det_tid = torch.where(matched, table.tid.gather(1, mslot),
                          torch.where(is_new, new_tid, zero_i)).to(torch.int32)
    det_active = torch.where(matched, prev_active + 1,
                             torch.where(is_new, 1, 0)).to(torch.int32)
    det_refsc = torch.where(matched, matched_ref, new_ref)

    # ---- aged tracks (compacted into slots N..CAP-1) ----------------------
    col_matched = _flag_at(CAP, torch.where(matched, mslot, CAP))
    t_cls = table.cls.clamp(min=0).long()
    t_gate = params.gates[t_cls]
    near_det = dist.min(dim=1).values <= t_gate
    drop_dead = table.dead & near_det
    C = params.gates.shape[0]
    class_has_dets = _flag_at(C, torch.where(dets.valid, dets.cls.long(), C))
    cls_alive = class_has_dets.gather(1, t_cls) | (not params.merged_mode)
    survive = (table.used & ~col_matched & ~drop_dead
               & (table.age < params.max_age) & cls_alive)
    aged_ref = torch.where(params.refine[t_cls] & params.merged_mode,
                           (1 - params.beta[t_cls]) * table.ref_score,
                           table.ref_score)
    aged_ct = table.ct - table.tracking  # move forward

    rank = torch.cumsum(survive.to(torch.int32), 1) - 1
    dest = torch.where(survive & (rank < CAP - N), N + rank, CAP).long()

    def build(det_rows, aged_rows, fill=0):
        """Slots [0, N) from the det rows, aged rows scattered to `dest`."""
        out = det_rows.new_full((B, CAP + 1) + det_rows.shape[2:], fill)
        out[:, :N] = det_rows
        idx = dest.reshape(dest.shape + (1,) * (aged_rows.dim() - 2))
        out.scatter_(1, idx.expand(aged_rows.shape), aged_rows)
        return out[:, :CAP]

    used_col = det_used[..., None]
    new_table = TrackTable(
        ct=build(torch.where(used_col, dets.ct, 0.0), aged_ct),
        tracking=build(torch.where(used_col, tracking, 0.0), table.tracking),
        cls=build(torch.where(det_used, dets.cls, -1).to(torch.int32), table.cls, -1),
        tid=build(det_tid, table.tid),
        age=build(det_used.to(torch.int32), table.age + 1),
        active=build(det_active, torch.zeros_like(table.active)),
        ref_score=build(torch.where(det_used, det_refsc, 0.0), aged_ref),
        dead=build(det_used & dets.dead, table.dead),
        used=build(det_used, survive),
    )
    return new_table, n_new, det_tid, det_used, det_refsc, is_new




def tracker_params(max_age: int, device) -> TrackerParams:
    """The merged tracker's per-class gates and refinement, in NAMES order."""
    def t(v):
        return torch.tensor(v, device=device)

    return TrackerParams(gates=t([float(GATES[n]) for n in NAMES]),
                         alpha=t([REFINE[n][0] for n in NAMES]),
                         beta=t([REFINE[n][1] for n in NAMES]),
                         refine=t([True] * len(NAMES)), max_age=max_age, merged_mode=True)


def dets_with_fn(boxes, prev_boxes, dec, cls_id: int) -> FrameDets:
    """Tracker rows: the kept current detections [0, N), then the prev
    boxes propagated as FN [N, 2N), moved by the prev frame's lag."""
    fn_ct = prev_boxes[:, :2] + prev_boxes[:1, 9:10] * prev_boxes[:, 7:9]
    no = torch.zeros_like(dec.keep)

    def rows(a, b):
        return torch.cat([a, b], 0)

    return FrameDets(
        ct=rows(boxes[:, :2], fn_ct), velocity=rows(boxes[:, 7:9], prev_boxes[:, 7:9]),
        cls=rows(torch.where(dec.keep, cls_id, -1), torch.where(dec.fn, cls_id, -1)).int(),
        score=rows(boxes[:, 10], prev_boxes[:, 10]),
        ref_score=rows(dec.ref_score, dec.fn_ref_score),
        newborn=rows(dec.newborn, no), dead=rows(no, no), valid=rows(dec.keep, dec.fn))
