"""Greedy score-ordered detection <-> GT association: the port of
shasta_tpu/preprocessing/associate.py.

Behavioral reference: preprocessing/gt_association/associate.py:6-113.
Predictions are visited in descending score order; each takes the closest
unmatched GT of a compatible type within the distance threshold. Type
compatibility is the reference's substring test (`pred_type in gt_type`,
associate.py:52): 'car' matches 'vehicle.car'. Distance: BEV centre L2
(associate.py:107-113).
"""
from __future__ import annotations

import numpy as np


def associate_l2(
    gt_boxes: np.ndarray,  # (M, >=3) centres in cols 0..2
    gt_types: list[str],
    pred_boxes: np.ndarray,  # (N, >=3)
    pred_types: list[str],
    threshold: float,
    pred_scores: np.ndarray | None = None,
):
    """Returns (tp_ind_pairs {pred_idx: gt_idx}, fp_inds, fn_inds), indices
    into the original (unsorted) prediction order. Without pred_scores the
    score is column 7 of a mot row when there is one, else 0 for all."""
    M, N = len(gt_boxes), len(pred_boxes)
    if M == 0 or N == 0:
        return {}, list(range(N)), list(range(M))
    if pred_scores is None:
        pb = np.asarray(pred_boxes)
        pred_scores = pb[:, 7] if pb.shape[1] > 7 else np.zeros(N)
    order = np.argsort(-np.asarray(pred_scores), kind="stable")
    gt_c = np.asarray(gt_boxes, np.float64)[:, :2]
    pr_c = np.asarray(pred_boxes, np.float64)[:, :2]
    dists = np.linalg.norm(gt_c[:, None, :] - pr_c[None, :, :], axis=2)  # (M, N)

    taken: set[int] = set()
    tp_ind_pairs: dict[int, int] = {}
    fp_inds: list[int] = []
    for pred_idx in order:
        ptype = pred_types[pred_idx]
        best, best_d = None, np.inf
        for gt_idx in range(M):
            if gt_idx in taken or ptype not in gt_types[gt_idx]:
                continue
            d = dists[gt_idx, pred_idx]
            if d < best_d:
                best_d, best = d, gt_idx
        if best is not None and best_d < threshold:
            taken.add(best)
            tp_ind_pairs[int(pred_idx)] = int(best)
        else:
            fp_inds.append(int(pred_idx))
    fn_inds = [g for g in range(M) if g not in taken]
    return tp_ind_pairs, fp_inds, fn_inds
