"""Tracking-result scoring: the port of GENERAL_TO_TRACKING and
eval_tracking_lite (shasta_tpu/tracker/runner.py:553-606). The rest of the
JAX runner (the affinity-eval loops, save_first_frame/track and the
official TrackingEval wrapper) is not ported yet."""
from __future__ import annotations

import json
import os

from ..mot.amota import evaluate_amota, frames_from_tracking_result

GENERAL_TO_TRACKING = {
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.bus": "bus",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.trailer": "trailer",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
}


def eval_tracking_lite(results: dict, gt_info_dir: str, classes=None) -> dict:
    """Devkit-free AMOTA over the gt_info per-frame artifacts
    ({gt_info_dir}/{token}.json with frame_ids, frame_types and
    frame_bboxes). A development metric: the official TrackingEval remains
    the reporting path. results: {token: [annos]} of a tracking result."""
    gt: dict[str, list] = {}
    for tok in results:
        path = os.path.join(gt_info_dir, tok + ".json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            d = json.load(f)
        annos = []
        for gid, gtype, box in zip(d["frame_ids"], d["frame_types"], d["frame_bboxes"]):
            name = GENERAL_TO_TRACKING.get(gtype)
            if name is None:
                continue
            annos.append({
                "instance_id": gid,
                "translation": list(box[:3]),
                "tracking_name": name,
            })
        gt[tok] = annos

    classes = classes or sorted({a["tracking_name"] for v in gt.values() for a in v})
    out = {}
    for cls in classes:
        gt_frames, hyp_frames = frames_from_tracking_result(results, gt, cls)
        out[cls] = evaluate_amota(gt_frames, hyp_frames)
    if out:
        out["mean_amota"] = float(
            sum(v["amota"] for k, v in out.items() if isinstance(v, dict)) / len(out)
        )
    return out
