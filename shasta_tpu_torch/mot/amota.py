"""Self-contained AMOTA/AMOTP tracking evaluation (nuScenes protocol); a
copy of shasta_tpu/mot/amota.py.

The official scorer (nuscenes.eval.tracking.TrackingEval, used at
validate.py:265-297) needs the devkit + raw dataset; this module
implements the same algorithm self-contained so quality can be measured
closed-loop on any GT source:

  for each class, sweep 40 recall thresholds; at each, filter hypotheses
  by the score cutoff achieving that recall, run CLEAR-MOT accumulation
  (2 m center-distance matching with persistent ids), and compute
    MOTAR = max(0, 1 - (FP + IDSW + FN - (1-r)*P) / (r*P))
  AMOTA = mean MOTAR over thresholds; AMOTP = mean match distance.

Intended for development/regression metrics; the official devkit scorer
remains the reporting path (the JAX package's tracker/runner.py).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from .metrics import MOTAccumulator


def _accumulate(gt_frames, hyp_frames, score_cutoff, dist_threshold):
    acc = MOTAccumulator(dist_threshold=dist_threshold)
    tp_scores = []
    for gt, hyp in zip(gt_frames, hyp_frames):
        hyp_f = [h for h in hyp if h["score"] >= score_cutoff]
        matched = acc.update(
            [g["id"] for g in gt],
            [g["center"] for g in gt] if gt else np.zeros((0, 2)),
            [h["id"] for h in hyp_f],
            [h["center"] for h in hyp_f] if hyp_f else np.zeros((0, 2)),
        )
        # TP scores (matched hypotheses only) drive the recall cutoffs on
        # the full pass (nuscenes devkit accumulate: match_data['conf'])
        if score_cutoff == -np.inf:
            tp_scores.extend(hyp_f[hi]["score"] for hi in matched)
    return acc, tp_scores


def evaluate_amota(
    gt_frames: list[list[dict]],
    hyp_frames: list[list[dict]],
    dist_threshold: float = 2.0,
    n_recalls: int = 40,
    min_recall: float = 0.1,
) -> dict:
    """gt_frames / hyp_frames: per frame, lists of {id, center (2,),
    score (hyps only)}. Single class. Returns amota/amotp/mota/recall."""
    full, tp_scores = _accumulate(gt_frames, hyp_frames, -np.inf, dist_threshold)
    P = full.num_gt
    if P == 0:
        return {"amota": 0.0, "amotp": 0.0, "recall": 0.0, "mota": 0.0}
    max_recall = full.num_matches / P
    scores = np.sort(np.asarray(tp_scores))[::-1]

    recalls = np.linspace(min_recall, 1.0, n_recalls)
    motars, motps = [], []
    for r in recalls:
        want = int(np.ceil(r * P))
        if want > len(scores):  # unreachable recall
            continue
        cutoff = scores[want - 1]
        acc, _ = _accumulate(gt_frames, hyp_frames, cutoff, dist_threshold)
        rP = max(acc.num_matches, 1)
        motar = max(
            0.0,
            1.0 - (acc.num_fp + acc.num_idsw + acc.num_fn - (P - acc.num_matches)) / rP,
        )
        motars.append(motar)
        motps.append(acc.motp)

    n = n_recalls
    amota = float(np.sum(motars) / n) if motars else 0.0
    amotp = float(np.mean(motps)) if motps else 0.0
    return {
        "amota": amota,
        "amotp": amotp,
        "recall": float(max_recall),
        "mota": full.mota,
        "num_thresholds": len(motars),
    }


def frames_from_tracking_result(results: dict, gt: dict, name: str):
    """Helpers to build (gt_frames, hyp_frames) for one class from
    tracking_result-style jsons + {token: [{instance_id, translation,
    tracking_name}]} GT."""
    tokens = sorted(set(results) | set(gt))
    gt_frames, hyp_frames = [], []
    for tok in tokens:
        gt_frames.append([
            {"id": g["instance_id"], "center": np.asarray(g["translation"][:2])}
            for g in gt.get(tok, [])
            if g.get("tracking_name", name) == name
        ])
        hyp_frames.append([
            {
                "id": h["tracking_id"],
                "center": np.asarray(h["translation"][:2]),
                "score": float(h.get("tracking_score", 0.5)),
            }
            for h in results.get(tok, [])
            if h.get("tracking_name") == name
        ])
    return gt_frames, hyp_frames
