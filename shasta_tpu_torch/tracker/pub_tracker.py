"""Host trackers: the port of shasta_tpu/tracker/pub_tracker.py, greedy or
Hungarian track-id assignment over detection dicts with the ShaSTA flags.

Behavioral reference: tools/nusc_shasta/pub_tracker.py:35-200 (one class)
and pub_tracker_merged.py:57-225 (7 classes, a per-class refinement
table). Host code on numpy f64, as in the JAX package; the device tracker
is tracker/scan_tracker.py.

Kept exactly, with the merged tracker's quirks:
- one id counter across classes;
- a frame with no det of a class drops that class's tracks;
- merged refinement: matched -> (tp > alpha) * beta * conf + (1 - beta) *
  prev; newborn -> beta * conf; aged -> ref *= (1 - beta);
- single refinement: matched -> the same formula; newborn -> conf; no
  decay while aging;
- a non-newborn unmatched det near a track is suppressed, and a dead track
  near a det is not kept alive.
"""
from __future__ import annotations

import numpy as np

from .greedy import greedy_assign_np

NUSCENES_TRACKING_NAMES = [
    "bicycle",
    "bus",
    "car",
    "motorcycle",
    "pedestrian",
    "trailer",
    "truck",
]

# 99.9-percentile L2 velocity-error gates per class (pub_tracker.py:23-31).
NUSCENE_CLS_VELOCITY_ERROR = {
    "car": 2,
    "truck": 2,
    "bus": 4,
    "trailer": 2,
    "pedestrian": 0.75,
    "motorcycle": 2,
    "bicycle": 1.5,
}

# Per-class confidence-refinement table (pub_tracker_merged.py:34-42).
TRK_REF = {
    "bicycle": {"alpha": 0.5, "beta": 0.4, "ref": True},
    "bus": {"alpha": 0.5, "beta": 0.7, "ref": True},
    "car": {"alpha": 0.5, "beta": 0.5, "ref": True},
    "motorcycle": {"alpha": 0.5, "beta": 0.5, "ref": True},
    "pedestrian": {"alpha": 0.5, "beta": 0.5, "ref": True},
    "trailer": {"alpha": 0.5, "beta": 0.4, "ref": True},
    "truck": {"alpha": 0.5, "beta": 0.5, "ref": True},
}


def _assign(dist: np.ndarray, hungarian: bool):
    """(matches [(det, trk)], extra unmatched dets). Hungarian: a pair the
    solver forms over a gated distance (> 1e16) matches nothing and its
    det counts as unmatched once more (pub_tracker.py:118-128)."""
    N, M = dist.shape
    if N == 0 or M == 0:
        return [], []
    if hungarian:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(np.minimum(dist, 1e18))
        pairs = list(zip(rows.tolist(), cols.tolist()))
        matches = [p for p in pairs if dist[p[0], p[1]] <= 1e16]
        extra = [p[0] for p in pairs if dist[p[0], p[1]] > 1e16]
        return matches, extra
    return [tuple(m) for m in greedy_assign_np(dist)], []


def _step_class(results: list[dict], tracks: list[dict], id_count: int, max_age: int,
                hungarian: bool, refine: bool, alpha: float, beta: float,
                merged_mode: bool):
    """One frame of one class: (output tracks, id_count). `results` carry
    the ct/tracking/label_preds fields of `_prep`."""
    N, M = len(results), len(tracks)
    if M > 0 and N > 0:
        det_ct = np.stack([d["ct"] + d["tracking"] for d in results])
        trk_ct = np.stack([t["ct"] for t in tracks])
        det_cat = np.array([d["label_preds"] for d in results])
        trk_cat = np.array([t["label_preds"] for t in tracks])
        gates = np.array([NUSCENE_CLS_VELOCITY_ERROR[d["detection_name"]] for d in results])
        dist = np.sqrt(((trk_ct[None, :, :] - det_ct[:, None, :]) ** 2).sum(-1))
        invalid = (dist > gates[:, None]) | (det_cat[:, None] != trk_cat[None, :])
        dist = dist + invalid * 1e18
    else:
        dist = np.full((N, M), 1e18)

    matches, extra_unmatched = _assign(dist, hungarian)
    matched_det = {m[0] for m in matches}
    matched_trk = {m[1] for m in matches}
    unmatched_dets = [d for d in range(N) if d not in matched_det] + extra_unmatched
    unmatched_tracks = [t for t in range(M) if t not in matched_trk]

    ret = []
    for di, ti in matches:
        track = results[di]
        prev = tracks[ti]
        track["tracking_id"] = prev["tracking_id"]
        if refine:
            tp_prob = track["ref_detection_score"]
            det_conf = track["detection_score"]
            track["ref_detection_score"] = (
                (tp_prob > alpha) * beta * det_conf
                + (1 - beta) * prev["ref_detection_score"]
            )
        elif merged_mode:
            track["ref_detection_score"] = track["detection_score"]
        track["age"] = 1
        track["active"] = prev["active"] + 1
        ret.append(track)

    for i in unmatched_dets:
        track = results[i]
        # a non-newborn det near an existing track is a likely duplicate
        # (pub_tracker.py:148-152)
        if M > 0 and "newborn" not in track:
            gate = NUSCENE_CLS_VELOCITY_ERROR[track["detection_name"]]
            if (dist[i, :] <= gate).sum():
                continue
        id_count += 1
        track["tracking_id"] = id_count
        if merged_mode and refine:
            track["ref_detection_score"] = beta * track["detection_score"]
        else:
            track["ref_detection_score"] = track["detection_score"]
        track["age"] = 1
        track["active"] = 1
        ret.append(track)

    for i in unmatched_tracks:
        track = tracks[i]
        # a dead track near a current det is not kept alive
        # (pub_tracker.py:169-172)
        if N > 0 and "dead" in track:
            gate = NUSCENE_CLS_VELOCITY_ERROR[track["detection_name"]]
            if (dist[:, i] <= gate).sum():
                continue
        if track["age"] < max_age:
            track["age"] += 1
            track["active"] = 0
            if merged_mode and refine:
                track["ref_detection_score"] = (1 - beta) * track["ref_detection_score"]
            if "tracking" in track:
                track["ct"] = track["ct"] - track["tracking"]  # move forward
            ret.append(track)

    return ret, id_count


def _prep(det: dict, time_lag: float) -> dict:
    """A copy of the det dict with its centre, its back-projection
    (-velocity * time_lag) and its class index."""
    det = dict(det)
    det["ct"] = np.array(det["translation"][:2], np.float64)
    det["tracking"] = -np.array(det["velocity"][:2], np.float64) * time_lag
    det["label_preds"] = NUSCENES_TRACKING_NAMES.index(det["detection_name"])
    return det


class PubTracker:
    """One-class tracker (pub_tracker.py:35-200)."""

    def __init__(self, hungarian: bool = False, max_age: int = 0,
                 refine_confidence: bool = False, alpha: float = 0.5, beta: float = 0.5):
        self.hungarian = hungarian
        self.max_age = max_age
        self.refine_confidence = refine_confidence
        self.alpha = alpha
        self.beta = beta
        self.reset()

    def reset(self):
        self.id_count = 0
        self.tracks: list[dict] = []

    def step_centertrack(self, results: list[dict], time_lag: float) -> list[dict]:
        if len(results) == 0:
            self.tracks = []
            return []
        dets = [_prep(d, time_lag) for d in results
                if d["detection_name"] in NUSCENES_TRACKING_NAMES]
        self.tracks, self.id_count = _step_class(
            dets, self.tracks, self.id_count, self.max_age, self.hungarian,
            self.refine_confidence, self.alpha, self.beta, merged_mode=False)
        return self.tracks


class PubTrackerMerged:
    """7-class tracker over the merged json (pub_tracker_merged.py:57-225)."""

    def __init__(self, hungarian: bool = False, max_age: int = 0, trk_ref=None):
        self.hungarian = hungarian
        self.max_age = max_age
        self.trk_ref = trk_ref or TRK_REF
        self.reset()

    def reset(self):
        self.id_count = 0
        self.tracks: list[dict] = []

    def step_centertrack(self, results: list[dict], time_lag: float) -> list[dict]:
        if len(results) == 0:
            self.tracks = []
            return []
        ret = []
        for name in NUSCENES_TRACKING_NAMES:
            dets = [_prep(d, time_lag) for d in results if d["detection_name"] == name]
            # a class with no dets this frame adds nothing to ret, so its
            # tracks are dropped (pub_tracker_merged.py:102-103)
            if len(dets) == 0:
                continue
            cls_tracks = [t for t in self.tracks if t["detection_name"] == name]
            cfg = self.trk_ref[name]
            out, self.id_count = _step_class(
                dets, cls_tracks, self.id_count, self.max_age, self.hungarian,
                cfg["ref"], cfg["alpha"], cfg["beta"], merged_mode=True)
            ret.extend(out)
        self.tracks = ret
        return ret
