"""NMS suite: the port of shasta_tpu/ops/nms.py (SimpleTrack weighted BEV
NMS, circle NMS, rotated NMS).

- `weighted_nms`, `circle_nms_np`, `rotate_nms_np`: host numpy, copies of
  the JAX package's functions; their pairwise IoUs come from the port's
  core/geometry.py (f32, on the CPU), where the JAX package's came from
  its XLA geometry.
- `rotate_nms`: on tensors, the counterpart of rotate_nms_jax: a keep
  mask from score-ordered greedy suppression over the pre-sorted IoU mask
  matrix (the reference's iou3d_nms.cpp:90-117), one step per box.

Boxes for weighted_nms are mot arrays [x, y, z, o(yaw), l, w, h, s];
rotate_nms takes geometry rows [x, y, z, w, l, h, yaw].
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry


def mot_to_geometry_rows(boxes: np.ndarray) -> np.ndarray:
    """mot rows -> geometry rows [x, y, z, w', l', h, yaw] where w' spans
    the box-local x axis (shasta_tpu/mot/bbox.py MotBBox.to_geometry_rows):
    mot_3d puts l along heading x and corners_bev puts index 3 along local
    x, so mot-l maps to slot 3; mot yaw is CCW, corners_bev's rotation CW+."""
    b = np.asarray(boxes, np.float64)
    out = np.zeros((len(b), 7))
    out[:, :3] = b[:, :3]
    out[:, 3] = b[:, 4]  # l -> local-x extent
    out[:, 4] = b[:, 5]  # w -> local-y extent
    out[:, 5] = b[:, 6]  # h
    out[:, 6] = -b[:, 3]
    return out


def _iou_np(fn, boxes: np.ndarray) -> np.ndarray:
    """Pairwise IoU matrix of geometry rows, f32 on the CPU."""
    g = torch.as_tensor(np.asarray(boxes), dtype=torch.float32)
    return fn(g, g).numpy()


def weighted_nms(dets: np.ndarray, inst_types: list, threshold_low: float = 0.1,
                 threshold_high: float = 0.5, threshold_yaw: float = 0.3):
    """SimpleTrack BEV weighted-mean NMS (py_nms/nms.py:13-80 semantics).

    Survivors above threshold_high vote a score-weighted average box whose
    yaw outliers (vs the median yaw) are excluded; boxes above
    threshold_low are suppressed. Returns (result_boxes (K, 8), types)."""
    dets = np.atleast_2d(np.asarray(dets, np.float64))
    n = len(dets)
    if n == 0:
        return np.zeros((0, 8)), []
    scores = dets[:, 7]
    yaws = dets[:, 3]
    iou = _iou_np(geometry.iou_3d, mot_to_geometry_rows(dets))

    result, result_types = [], []
    alive = np.ones(n, bool)
    for index in np.argsort(-scores, kind="stable"):
        if not alive[index]:
            continue
        # degenerate boxes are dropped outright (nms.py weird_bbox)
        if dets[index, 4] <= 0 or dets[index, 5] <= 0 or dets[index, 6] <= 0:
            alive[index] = False
            continue
        same_type = np.array([inst_types[i] == inst_types[index] for i in range(n)])
        related = alive & same_type
        ious = np.where(related, iou[index], 0.0)
        vote_idx = np.nonzero(ious > threshold_high)[0]

        if len(vote_idx) >= 2:
            if len(vote_idx) <= 2:
                median_yaw = yaws[vote_idx][np.argmax(scores[vote_idx])]
            elif len(vote_idx) % 2 == 0:
                median_yaw = np.median(np.append(yaws[vote_idx], yaws[vote_idx][0]))
            else:
                median_yaw = np.median(yaws[vote_idx])
            keep_yaw = np.abs(yaws[vote_idx] - median_yaw) % (2 * np.pi) < threshold_yaw
            vote_idx = vote_idx[keep_yaw]
            w = scores[vote_idx][:, None]
            avg = np.sum(w * dets[vote_idx, :7], axis=0) / np.sum(w)
            out = np.append(avg, scores[index])
            result.append(out)
        else:
            result.append(dets[index].copy())
        result_types.append(inst_types[index])
        alive &= ~(ious > threshold_low)

    return np.stack(result) if result else np.zeros((0, 8)), result_types


def circle_nms_np(dets_xys: np.ndarray, thresh: float, post_max_size: int | None = None):
    """Center-distance NMS; dets_xys rows [x, y, score]
    (circle_nms_jit.py:4-30 semantics). Returns kept indices."""
    order = np.argsort(-dets_xys[:, 2], kind="stable")
    suppressed = np.zeros(len(dets_xys), bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        d2 = (dets_xys[:, 0] - dets_xys[i, 0]) ** 2 + (dets_xys[:, 1] - dets_xys[i, 1]) ** 2
        suppressed |= d2 <= thresh
        suppressed[i] = True
    if post_max_size is not None:
        keep = keep[:post_max_size]
    return np.asarray(keep, np.int64)


def rotate_nms_np(boxes7: np.ndarray, scores: np.ndarray, iou_threshold: float,
                  pre_max_size: int | None = None, post_max_size: int | None = None):
    """Rotated-BEV NMS (box_torch_ops.rotate_nms_pcdet / iou3d_nms.cpp
    semantics). boxes7: geometry rows [x,y,z,w,l,h,yaw]. Returns indices."""
    order = np.argsort(-scores, kind="stable")
    if pre_max_size is not None:
        order = order[:pre_max_size]
    iou = _iou_np(geometry.iou_bev, np.asarray(boxes7)[order])
    n = len(order)
    suppressed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(int(order[i]))
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    if post_max_size is not None:
        keep = keep[:post_max_size]
    return np.asarray(keep, np.int64)


def rotate_nms(boxes7: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Rotated NMS on the boxes' device -> keep mask (N,) bool: greedy
    suppression in score order (stable) over the IoU mask matrix, one step
    per box (the JAX lax.scan)."""
    n = boxes7.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes7[order]
    # row i suppresses only later boxes
    over = (geometry.iou_bev(b, b) > iou_threshold).triu(1)
    suppressed = torch.zeros(n, dtype=torch.bool, device=boxes7.device)
    for i in range(n):
        suppressed |= over[i] & ~suppressed[i]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes7.device)
    keep[order] = ~suppressed
    return keep
