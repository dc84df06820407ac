"""Training/eval info pkls: lidar paths + multi-sweep transform chains; the
port of shasta_tpu/preprocessing/infos.py.

Behavioral reference: det3d/datasets/nuscenes/nusc_common.py:354-608
(_fill_trainval_infos / create_nuscenes_infos): per key-frame sample, the
LIDAR_TOP path, up to (nsweeps-1) preceding non-key sweeps each with a 4x4
transform into the reference frame and a time lag, plus GT boxes/names for
train splits. Devkit-free via nusc_db.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..core.boxes import quaternion_yaw
from ..core.transforms import quat_inverse, quat_to_rotmat
from .nusc_db import NuscDB


def _se3(rot_q, trans) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_rotmat(np.asarray(rot_q))
    T[:3, 3] = np.asarray(trans)
    return T


def _inv_se3(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


def _sensor_to_global(db: NuscDB, sd: dict) -> np.ndarray:
    cs = db.get("calibrated_sensor", sd["calibrated_sensor_token"])
    pose = db.get("ego_pose", sd["ego_pose_token"])
    return _se3(pose["rotation"], pose["translation"]) @ _se3(
        cs["rotation"], cs["translation"]
    )


def create_nuscenes_infos(
    dataroot: str,
    version: str = "v1.0-trainval",
    nsweeps: int = 10,
    scene_names=None,
    with_gt: bool = True,
    out_path: str | None = None,
) -> list[dict]:
    db = NuscDB(dataroot, version)
    sd_by_token = {r["token"]: r for r in db.table("sample_data")}
    infos = []
    for scene in db.scene:
        if scene_names is not None and scene["name"] not in scene_names:
            continue
        for sample in db.scene_samples(scene):
            ref_sd = db.sample_lidar_data(sample)
            ref_global = _sensor_to_global(db, ref_sd)
            ref_from_global = _inv_se3(ref_global)
            info = {
                "token": sample["token"],
                "timestamp": sample["timestamp"] * 1e-6,
                "lidar_path": os.path.join(dataroot, ref_sd["filename"]),
                "sweeps": [],
            }
            # walk backwards through preceding (non-key) sweeps
            sd = ref_sd
            while len(info["sweeps"]) < nsweeps - 1:
                prev_tok = sd.get("prev", "")
                if not prev_tok or prev_tok not in sd_by_token:
                    break
                sd = sd_by_token[prev_tok]
                sweep_global = _sensor_to_global(db, sd)
                tm = ref_from_global @ sweep_global
                info["sweeps"].append(
                    {
                        "lidar_path": os.path.join(dataroot, sd["filename"]),
                        "transform_matrix": tm,
                        "time_lag": (sample["timestamp"] - sd["timestamp"]) * 1e-6,
                        "token": sd["token"],
                    }
                )
            if with_gt:
                names, boxes = [], []
                for ann in db.annotations_for_sample(sample["token"]):
                    names.append(db.category_name(ann["instance_token"]))
                    # global -> sensor frame box (7-row [x,y,z,w,l,h,yaw])
                    t = ref_from_global[:3, :3] @ np.asarray(
                        ann["translation"]
                    ) + ref_from_global[:3, 3]
                    # yaw in the sensor frame
                    q = np.asarray(ann["rotation"])
                    yaw_g = quaternion_yaw(q)
                    # rotate heading vector into sensor frame
                    hv = ref_from_global[:3, :3] @ np.array(
                        [np.cos(yaw_g), np.sin(yaw_g), 0.0]
                    )
                    yaw = float(np.arctan2(hv[1], hv[0]))
                    boxes.append(list(t) + list(ann["size"]) + [yaw])
                info["gt_names"] = np.asarray(names)
                info["gt_boxes"] = np.asarray(boxes).reshape(-1, 7)
            infos.append(info)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "wb") as f:
            pickle.dump(infos, f)
    return infos
