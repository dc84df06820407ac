"""GT affinity matrices of a frame pair (the gt_shasta labels): the port of
shasta_tpu/preprocessing/gt_shasta.py and of the row conversion
(`mot_rows`, nuscenes_chain.py:285-300) that feeds it.

Behavioral reference: preprocessing/make_gt_shasta.py:88-157. For each
frame pair (prev, curr):
- associate dets <-> GT in each frame alone (2 m centre L2, greedy);
- a prev TP and a curr TP sharing a GT instance id: matched[prev, curr] = 1;
- an unmatched prev TP whose GT id is a curr-frame FN GT: the FN column (-1);
- every other prev det (FPs and TPs whose id vanished): the dead column
  (-2), 1 - rowsum;
- curr TPs with no prev match: newborn[curr] = 1.
A scene start gives matched None and newborn from the curr TPs alone.
Labels are written per token as npz {matched or np.array(None), newborn}
(nuscenes_chain.py:355-363), over all the frame's detections in file order.
"""
from __future__ import annotations

import numpy as np

from ..core.boxes import quaternion_yaw
from .associate import associate_l2


def mot_rows(arrs) -> np.ndarray:
    """Rows [translation(3), size(3) w l h, quaternion(4), ...] -> (N, 8) mot
    arrays [x, y, z, yaw, l, w, h, score]; the score is a row's 11th value
    when it has exactly 11 (a detection row), else 0."""
    out = np.zeros((len(arrs), 8))
    for i, b in enumerate(arrs):
        b = np.asarray(b, np.float64)
        out[i, :3] = b[:3]
        out[i, 3] = quaternion_yaw(b[6:10])
        out[i, 4], out[i, 5], out[i, 6] = b[4], b[3], b[5]  # (w, l, h) -> (l, w, h)
        if len(b) == 11:
            out[i, 7] = b[10]
    return out


def frame_gt_matrices(
    prev_dets: np.ndarray | None,
    prev_types: list[str] | None,
    prev_gt: np.ndarray | None,
    prev_gt_types: list[str] | None,
    prev_gt_ids: list | None,
    curr_dets: np.ndarray,
    curr_types: list[str],
    curr_gt: np.ndarray,
    curr_gt_types: list[str],
    curr_gt_ids: list,
    threshold: float = 2.0,
):
    """Returns (matched (N, K+2) or None, newborn (K,))."""
    K = len(curr_dets)
    tp_pairs, _, fn_inds = associate_l2(curr_gt, curr_gt_types, curr_dets, curr_types,
                                        threshold)
    if prev_dets is None:
        newborn = np.zeros((K,))
        for k in tp_pairs:
            newborn[k] = 1
        return None, newborn

    N = len(prev_dets)
    prev_tp_pairs, _, _ = associate_l2(prev_gt, prev_gt_types, prev_dets, prev_types,
                                       threshold)
    matched = np.zeros((N, K + 2))
    newborn = np.zeros((K,))
    prev_tp_idx = list(prev_tp_pairs.keys())
    prev_tp_ids = [prev_gt_ids[g] for g in prev_tp_pairs.values()]

    matched_prev_ids = []
    for curr_idx, gt_idx in tp_pairs.items():
        gid = curr_gt_ids[gt_idx]
        if gid in prev_tp_ids:
            matched_prev_ids.append(gid)
            matched[prev_tp_idx[prev_tp_ids.index(gid)], curr_idx] = 1
        else:
            newborn[curr_idx] = 1

    curr_ids = list(curr_gt_ids)
    for pos, gid in enumerate(prev_tp_ids):
        if gid in matched_prev_ids:
            continue
        if gid in curr_ids and curr_ids.index(gid) in fn_inds:
            matched[prev_tp_idx[pos], -1] = 1  # FN track
    matched[:, -2] = 1 - matched.sum(axis=1)  # dead: everything else
    return matched, newborn


def write_frame_labels(path: str, matched: np.ndarray | None, newborn: np.ndarray) -> None:
    """One token's labels in write_gt_shasta's npz layout, which the
    dataset of either package reads (labels_path/{token}.npz)."""
    np.savez_compressed(path, matched=matched if matched is not None else np.array(None),
                        newborn=newborn)
