"""Detection-submission writer: sensor-frame dets -> nuScenes results json;
the port of shasta_tpu/data/submission.py.

Behavioral reference: det3d/datasets/nuscenes/nuscenes.py:441-511
(evaluation: _second_det_to_nusc_box + _lidar_nusc_box_to_global + the
velocity/attribute assignment) and nusc_common.py:160-201. Devkit-free via
NuscDB.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..core.boxes import yaw_to_quaternion
from ..core.transforms import quat_multiply, quat_to_rotmat
from ..preprocessing.nusc_db import NuscDB

# most-common attribute per class (cls_attr_dist argmax, nuscenes.py:492-494)
DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "trailer": "vehicle.parked",
    "construction_vehicle": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "motorcycle": "cycle.without_rider",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}


def _attribute_for(name: str, velocity: np.ndarray) -> str | None:
    """Velocity-based attribute rules (nuscenes.py:461-480)."""
    if np.hypot(velocity[0], velocity[1]) > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return None
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return None


def sensor_dets_to_global_annos(
    db: NuscDB,
    token: str,
    boxes: np.ndarray,  # (N, >=9) [x,y,z,w,l,h,yaw,vx,vy] sensor frame
    scores: np.ndarray,
    names: list[str],
) -> list[dict]:
    sample = db.get("sample", token)
    sd = db.sample_lidar_data(sample)
    pose = db.get("ego_pose", sd["ego_pose_token"])
    cs = db.get("calibrated_sensor", sd["calibrated_sensor_token"])
    ego_t, ego_q = np.asarray(pose["translation"]), np.asarray(pose["rotation"])
    s_t, s_q = np.asarray(cs["translation"]), np.asarray(cs["rotation"])
    R_e, R_s = quat_to_rotmat(ego_q), quat_to_rotmat(s_q)

    annos = []
    for b, score, name in zip(np.atleast_2d(boxes), scores, names):
        t = R_s @ b[:3] + s_t
        t = R_e @ t + ego_t
        q = quat_multiply(ego_q, quat_multiply(s_q, yaw_to_quaternion(b[6])))
        v = np.array([b[7], b[8], 0.0]) if len(b) > 8 else np.zeros(3)
        v = R_e @ (R_s @ v)
        attr = _attribute_for(name, v)
        annos.append({
            "sample_token": token,
            "translation": t.tolist(),
            "size": [float(b[3]), float(b[4]), float(b[5])],
            "rotation": [float(x) for x in q],
            "velocity": [float(v[0]), float(v[1])],
            "detection_name": name,
            "detection_score": float(score),
            "attribute_name": attr if attr is not None else DEFAULT_ATTRIBUTE.get(name, ""),
        })
    return annos


def write_detection_submission(
    db: NuscDB,
    detections: dict[str, tuple[np.ndarray, np.ndarray, list[str]]],
    out_path: str,
) -> str:
    """detections: {token: (boxes, scores, names)} in sensor frame."""
    results = {
        tok: sensor_dets_to_global_annos(db, tok, *payload)
        for tok, payload in detections.items()
    }
    out = {
        "results": results,
        "meta": {
            "use_camera": False,
            "use_lidar": True,
            "use_radar": False,
            "use_map": False,
            "use_external": False,
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out_path
