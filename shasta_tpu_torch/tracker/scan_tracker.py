"""On-device scene tracker: the port of shasta_tpu/tracker/scan_tracker.py.

A fixed-capacity track table (struct of tensors) advanced one frame per
`step_frame` call (one scene) or `step_frames` call (B scene lanes), with the semantics of PubTracker/PubTrackerMerged:
back-projected centers, per-class gates, greedy row-order assignment,
suppression of non-newborn unmatched dets near a track, removal of
dead-flagged tracks near a det, aging to max_age, per-class score
refinement and the merged quirk (a class with no dets this frame loses
its tracks).

Table layout: slots [0, N) hold this frame's det-derived tracks, slots
[N, CAP) the aged tracks compacted front-first. The JAX scatters with
mode="drop" become masked scatters into a table with one spare row that
is cut off afterwards.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .greedy import greedy_assign

BIG = 1e18


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


def track_scene(frames: FrameDets, time_lags: torch.Tensor, params: TrackerParams,
                cap: int | None = None):
    """Track a whole scene: `step_frame` over its frames in order, from an
    empty table of `cap` slots (default N*(max_age+1)) and id count 0 (the
    JAX lax.scan, scan_tracker.py:203-220). frames: FrameDets with a
    leading (F,) axis; time_lags (F,). Returns (det_tid (F, N), det_used
    (F, N), ref (F, N))."""
    F, N = frames.ct.shape[:2]
    table = TrackTable.empty(cap or N * (params.max_age + 1), frames.ct.device)
    id_count = torch.zeros((), dtype=torch.int32, device=frames.ct.device)
    time_lags = torch.as_tensor(time_lags, device=frames.ct.device)
    outs = []
    for f in range(F):
        table, id_count, tid, used, ref = step_frame(
            table, id_count, FrameDets(*(d[f] for d in frames)), time_lags[f], params)
        outs.append((tid, used, ref))
    return tuple(torch.stack(o) for o in zip(*outs))
