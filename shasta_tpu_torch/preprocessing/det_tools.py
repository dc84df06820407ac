"""Detection post-processing tools: BEV NMS, oracle FP removal, type filter;
the port of shasta_tpu/preprocessing/det_tools.py. The NMS's pairwise IoUs
are the port's geometry in f32 on the CPU (ops/nms.py).

Behavioral reference: preprocessing/detection_nms.py:119-184 (SimpleTrack
weighted NMS over per-scene det npz), preprocessing/remove_fp.py:42-112
(oracle: keep TP detections only), preprocessing/filter_track_types.py
(restrict raw results json to the 7 tracking classes).
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..core.boxes import quaternion_yaw
from ..ops.nms import weighted_nms
from .associate import associate_l2

TRACKING_CLASSES = (
    "bicycle", "bus", "car", "motorcycle", "pedestrian", "trailer", "truck",
)


def _nu_to_mot(rows) -> np.ndarray:
    """[t(3) s(3) q(4) (score)] rows -> (N, 8) mot [x,y,z,o,l,w,h,s]."""
    out = np.zeros((len(rows), 8))
    for i, b in enumerate(rows):
        b = np.asarray(b, np.float64)
        out[i, :3] = b[:3]
        out[i, 3] = quaternion_yaw(b[6:10])
        out[i, 4] = b[4]  # l
        out[i, 5] = b[3]  # w
        out[i, 6] = b[5]  # h
        if len(b) >= 11:
            out[i, 7] = b[10]
    return out


def nms_detections_npz(
    det_dir: str,
    out_dir: str,
    threshold_low: float = 0.1,
    threshold_high: float = 0.5,
    threshold_yaw: float = 0.3,
):
    """Apply weighted NMS to every frame of every per-scene det npz
    (detection_nms.py main loop)."""
    os.makedirs(out_dir, exist_ok=True)
    for fn in sorted(os.listdir(det_dir)):
        if not fn.endswith(".npz"):
            continue
        data = np.load(os.path.join(det_dir, fn), allow_pickle=True)
        bboxes, types = data["bboxes"], data["types"]
        out_boxes, out_types = [], []
        for fi in range(len(bboxes)):
            if len(bboxes[fi]) == 0:
                out_boxes.append([])
                out_types.append([])
                continue
            mot = _nu_to_mot(bboxes[fi])
            kept, kept_types = weighted_nms(
                mot, list(types[fi]), threshold_low, threshold_high, threshold_yaw
            )
            # back to nu rows [t s q score]
            rows = []
            for b in kept:
                yaw = b[3]
                rows.append(
                    list(b[:3]) + [b[5], b[4], b[6]]
                    + [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)] + [b[7]]
                )
            out_boxes.append(rows)
            out_types.append(kept_types)
        np.savez_compressed(
            os.path.join(out_dir, fn),
            bboxes=np.asarray(out_boxes, dtype=object),
            types=np.asarray(out_types, dtype=object),
            allow_pickle=True,
        )


def remove_fp_npz(det_dir: str, gt_dir: str, out_dir: str, threshold: float = 2.0):
    """Oracle ablation: keep only GT-associated TP detections
    (remove_fp.py:42-112)."""
    os.makedirs(out_dir, exist_ok=True)
    for fn in sorted(os.listdir(det_dir)):
        if not fn.endswith(".npz"):
            continue
        dets = np.load(os.path.join(det_dir, fn), allow_pickle=True)
        gts = np.load(os.path.join(gt_dir, fn), allow_pickle=True)
        out_boxes, out_types = [], []
        for fi in range(len(dets["bboxes"])):
            rows = dets["bboxes"][fi]
            dtypes = list(dets["types"][fi])
            if len(rows) == 0:
                out_boxes.append([])
                out_types.append([])
                continue
            mot_d = _nu_to_mot(rows)
            mot_g = _nu_to_mot(gts["bboxes"][fi])
            tp_pairs, _, _ = associate_l2(
                mot_g, list(gts["types"][fi]), mot_d, dtypes, threshold
            )
            keep = sorted(tp_pairs.keys())
            out_boxes.append([rows[i] for i in keep])
            out_types.append([dtypes[i] for i in keep])
        np.savez_compressed(
            os.path.join(out_dir, fn),
            bboxes=np.asarray(out_boxes, dtype=object),
            types=np.asarray(out_types, dtype=object),
            allow_pickle=True,
        )


def filter_track_types(results_json: str, out_json: str):
    """Filter a raw results json to the 7 tracking classes
    (filter_track_types.py)."""
    with open(results_json) as f:
        data = json.load(f)
    data["results"] = {
        tok: [d for d in dets if d.get("detection_name") in TRACKING_CLASSES]
        for tok, dets in data["results"].items()
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_json)) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(data, f)
