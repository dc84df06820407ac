"""The offline preprocessing chain producing data/nusc_preprocessed/**: the
port of shasta_tpu/preprocessing/nuscenes_chain.py (numpy host code).

Behavioral reference: preprocessing.sh:1-27 chaining token_info.py,
ego_pose.py, gt_info.py, detection.py, get_det_info.py,
get_det_sensor_info.py, get_frame_info.py, make_gt_shasta.py. Artifact
formats are byte-compatible (same npz keys / json layouts) so either
codebase can consume the tree. Implemented devkit-free on top of
:mod:`.nusc_db`.

Array formats (reference gt_info.py:18-24, detection.py:32-35):
  GT bbox row:  translation(3) + size(3) + rotation quat(4) + velocity(2)
  det bbox row: translation(3) + size(3) + rotation quat(4) + score
  sensor det row: trans(3) + wlh(3) + quat(4) + velocity(2) + score (13)

Scene splits: the reference uses the devkit's create_splits_scenes(); here
pass an explicit scene-name list (or None = every scene in the dataroot).
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..core.transforms import (
    global_to_sensor_box,
    quat_inverse,
    quat_to_rotmat,
)
from .gt_shasta import frame_gt_matrices, mot_rows
from .nusc_db import NuscDB


def _scenes(db: NuscDB, scene_names):
    for s in db.scene:
        if scene_names is None or s["name"] in scene_names:
            yield s


def _ensure(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


# -- stage 1: token_info (token_info.py:42-108, 2hz + 20hz modes) -----------

def _select_20hz(entries):
    """10 Hz frame selection over the 20 Hz chain (token_info.py:18-39):
    every key frame is selected and resets the counter; non-key frames are
    selected when an even number of frames has passed since the key."""
    counter = -1
    out = []
    for tok, is_key, sample_token in entries:
        counter += 1
        if is_key:
            out.append([tok, is_key, sample_token, True])
            counter = 0
        else:
            out.append([tok, is_key, sample_token, counter % 2 == 0])
    return out


def write_token_info(db: NuscDB, scene_names, out_dir: str, mode: str = "2hz"):
    folder = _ensure(os.path.join(out_dir, "token_info"))
    for scene in _scenes(db, scene_names):
        if mode == "2hz":
            tokens = [s["token"] for s in db.scene_samples(scene)]
        else:  # 20hz: [sd_token, is_key_frame, sample_token, selected]
            entries = [
                (sd["token"], bool(sd.get("is_key_frame")), sd["sample_token"])
                for sd in db.lidar_sd_chain(scene)
            ]
            tokens = _select_20hz(entries)
        with open(os.path.join(folder, scene["name"] + ".json"), "w") as f:
            json.dump(tokens, f)


# -- stage 2: ego_info (ego_pose.py:17-57; 20hz = every sweep frame) --------

def write_ego_info(db: NuscDB, scene_names, out_dir: str, mode: str = "2hz"):
    folder = _ensure(os.path.join(out_dir, "ego_info"))
    for scene in _scenes(db, scene_names):
        ego = {}
        if mode == "2hz":
            sds = [db.sample_lidar_data(s) for s in db.scene_samples(scene)]
        else:
            sds = db.lidar_sd_chain(scene)
        for i, sd in enumerate(sds):
            pose = db.get("ego_pose", sd["ego_pose_token"])
            ego[str(i)] = list(pose["translation"]) + list(pose["rotation"])
        np.savez_compressed(os.path.join(folder, scene["name"] + ".npz"), **ego)


# -- stage 3: gt_info (gt_info.py:27-88) ------------------------------------

def box_velocity(db: NuscDB, ann_token: str, max_time_diff: float = 1.5) -> np.ndarray:
    """GT velocity from neighboring annotations (devkit box_velocity)."""
    ann = db.get("sample_annotation", ann_token)
    has_prev = ann["prev"] != ""
    has_next = ann["next"] != ""
    if not has_prev and not has_next:
        return np.array([np.nan, np.nan, np.nan])
    first = db.get("sample_annotation", ann["prev"]) if has_prev else ann
    last = db.get("sample_annotation", ann["next"]) if has_next else ann
    pos_first = np.asarray(first["translation"])
    pos_last = np.asarray(last["translation"])
    t_first = 1e-6 * db.get("sample", first["sample_token"])["timestamp"]
    t_last = 1e-6 * db.get("sample", last["sample_token"])["timestamp"]
    if t_last - t_first > max_time_diff:
        return np.array([np.nan, np.nan, np.nan])
    return (pos_last - pos_first) / max(t_last - t_first, 1e-6)


def write_gt_info(db: NuscDB, scene_names, out_dir: str, mode: str = "2hz"):
    folder = _ensure(os.path.join(out_dir, "gt_info"))
    if mode == "20hz":
        # gt_info.py 20hz branch: boxes at EVERY sweep frame via key-frame
        # interpolation (devkit get_boxes); no per-frame jsons, no
        # lidar-points filter (counts don't exist for interpolated boxes).
        for scene in _scenes(db, scene_names):
            IDS, types, bboxes = [], [], []
            for sd in db.lidar_sd_chain(scene):
                boxes = db.boxes_at_sample_data(sd)
                IDS.append([b["instance_token"] for b in boxes])
                types.append([b["category_name"] for b in boxes])
                bboxes.append([
                    list(b["translation"]) + list(b["size"]) + list(b["rotation"])
                    for b in boxes
                ])
            np.savez_compressed(
                os.path.join(folder, scene["name"] + ".npz"),
                ids=np.asarray(IDS, dtype=object),
                types=np.asarray(types, dtype=object),
                bboxes=np.asarray(bboxes, dtype=object),
                allow_pickle=True,
            )
        return
    indiv = _ensure(os.path.join(folder, "individual_frames"))
    for scene in _scenes(db, scene_names):
        IDS, types, bboxes = [], [], []
        for sample in db.scene_samples(scene):
            fids, ftypes, fboxes = [], [], []
            for ann in db.annotations_for_sample(sample["token"]):
                if ann["num_lidar_pts"] + ann["num_radar_pts"] > 0:
                    fids.append(ann["instance_token"])
                    ftypes.append(db.category_name(ann["instance_token"]))
                    velo = box_velocity(db, ann["token"])
                    fboxes.append(
                        list(ann["translation"]) + list(ann["size"])
                        + list(ann["rotation"]) + list(velo[:2])
                    )
            with open(os.path.join(indiv, sample["token"] + ".json"), "w") as f:
                json.dump(
                    {"frame_ids": fids, "frame_types": ftypes, "frame_bboxes": fboxes},
                    f,
                )
            IDS.append(fids)
            types.append(ftypes)
            bboxes.append(fboxes)
        np.savez_compressed(
            os.path.join(folder, scene["name"] + ".npz"),
            ids=np.asarray(IDS, dtype=object),
            types=np.asarray(types, dtype=object),
            bboxes=np.asarray(bboxes, dtype=object),
            allow_pickle=True,
        )


# -- stage 4: per-scene detection npz (detection.py:38-102) -----------------

def write_detections(results_json: str, out_dir: str, det_name: str = "cp"):
    with open(results_json) as f:
        det_data = json.load(f)["results"]
    token_dir = os.path.join(out_dir, "token_info")
    folder = _ensure(os.path.join(out_dir, "detections", det_name, "dets"))
    for fn in sorted(os.listdir(token_dir)):
        scene_name = fn[:-5]
        with open(os.path.join(token_dir, fn)) as f:
            tokens = json.load(f)
        bboxes = [[] for _ in tokens]
        types = [[] for _ in tokens]
        velos = [[] for _ in tokens]
        for i, tok in enumerate(tokens):
            # 20hz token rows are [sd_token, is_key, sample_token, selected];
            # detections exist per keyframe sample token only
            if isinstance(tok, list):
                if not tok[1]:
                    continue
                tok = tok[2]
            for s in det_data.get(tok, []):
                bboxes[i].append(
                    list(s["translation"]) + list(s["size"]) + list(s["rotation"])
                    + [s["detection_score"]]
                )
                types[i].append(s["detection_name"])
                velos[i].append(list(s["velocity"]))
        np.savez_compressed(
            os.path.join(folder, scene_name + ".npz"),
            bboxes=np.asarray(bboxes, dtype=object),
            types=np.asarray(types, dtype=object),
            velos=np.asarray(velos, dtype=object),
            allow_pickle=True,
        )


# -- stage 5: per-frame det jsons (get_det_info.py:23-60) -------------------

def write_det_frames(results_json: str, out_dir: str, det_name: str = "cp"):
    with open(results_json) as f:
        det_data = json.load(f)["results"]
    indiv = _ensure(os.path.join(out_dir, "detections", det_name, "individual_frames"))
    cls_dir = _ensure(
        os.path.join(out_dir, "detections", det_name, "cls_individual_frames")
    )
    for tok, dets in det_data.items():
        rows = [
            list(s["translation"]) + list(s["size"]) + list(s["rotation"])
            + list(s["velocity"])[:2] + [s["detection_score"]]
            for s in dets
        ]
        with open(os.path.join(indiv, tok + ".json"), "w") as f:
            json.dump(rows, f)
        with open(os.path.join(cls_dir, tok + ".json"), "w") as f:
            json.dump(dets, f)


# -- stage 6: sensor-frame det jsons (get_det_sensor_info.py:45-112) --------

def write_sensor_det_frames(
    db: NuscDB, results_json: str, out_dir: str, det_name: str = "cp"
):
    with open(results_json) as f:
        det_data = json.load(f)["results"]
    folder = _ensure(
        os.path.join(out_dir, "detections", det_name, "sensor_individual_frames")
    )
    for tok, dets in det_data.items():
        sample = db.get("sample", tok)
        sd = db.sample_lidar_data(sample)
        pose = db.get("ego_pose", sd["ego_pose_token"])
        cs = db.get("calibrated_sensor", sd["calibrated_sensor_token"])
        ego_t, ego_q = np.asarray(pose["translation"]), np.asarray(pose["rotation"])
        s_t, s_q = np.asarray(cs["translation"]), np.asarray(cs["rotation"])
        rows = []
        for s in dets:
            t, q = global_to_sensor_box(
                np.asarray(s["translation"]), np.asarray(s["rotation"]),
                ego_t, ego_q, s_t, s_q,
            )
            # velocity is a global-frame vector: rotate only
            v = np.asarray(list(s["velocity"]) + [0.0])
            v = quat_to_rotmat(quat_inverse(s_q)) @ (
                quat_to_rotmat(quat_inverse(ego_q)) @ v
            )
            rows.append(
                list(t) + list(s["size"]) + list(q) + list(v[:2])
                + [s["detection_score"]]
            )
        with open(os.path.join(folder, tok + ".json"), "w") as f:
            json.dump(rows, f)


# -- stage 7: frame_info (get_frame_info.py:16-57) --------------------------

def write_frame_info(db: NuscDB, scene_names, out_path: str):
    frame_info = {}
    for scene in _scenes(db, scene_names):
        for sample in db.scene_samples(scene):
            prev_t, next_t = sample["prev"], sample["next"]
            ts = sample["timestamp"]
            frame_info[sample["token"]] = {
                "prev": prev_t,
                "next": next_t,
                "timestamp": ts,
                "prev_timestamp": db.get("sample", prev_t)["timestamp"] if prev_t else ts,
                "next_timestamp": db.get("sample", next_t)["timestamp"] if next_t else ts,
            }
    _ensure(os.path.dirname(out_path) or ".")
    with open(out_path, "w") as f:
        json.dump(frame_info, f)


# -- stage 8: gt_shasta matrices (make_gt_shasta.py:45-167) -----------------

def write_gt_shasta(
    out_dir: str,
    det_name: str = "cp",
    name: str = "gt_shasta",
    threshold: float = 2.0,
    frame_info_path: str | None = None,
):
    """Per-token (matched, newborn) npz from per-scene det + gt npz files."""
    det_dir = os.path.join(out_dir, "detections", det_name, "dets")
    gt_dir = os.path.join(out_dir, "gt_info")
    token_dir = os.path.join(out_dir, "token_info")
    npz_path = _ensure(os.path.join(out_dir, name, det_name, "individual_frames"))

    restrict = None
    if frame_info_path and os.path.exists(frame_info_path):
        with open(frame_info_path) as f:
            restrict = set(json.load(f).keys())

    for fn in sorted(os.listdir(token_dir)):
        scene_name = fn[:-5]
        with open(os.path.join(token_dir, fn)) as f:
            tokens = json.load(f)
        dets = np.load(os.path.join(det_dir, scene_name + ".npz"), allow_pickle=True)
        gts = np.load(os.path.join(gt_dir, scene_name + ".npz"), allow_pickle=True)
        det_boxes, det_types = dets["bboxes"], dets["types"]
        gt_boxes, gt_ids, gt_types = gts["bboxes"], gts["ids"], gts["types"]

        # 20hz token rows are [sd_token, is_key, sample_token, selected];
        # affinity GT is keyframe-paired (detections exist only there), so
        # keep the key rows and pair each with the previous KEY row.
        frames = [
            (fi, tok if isinstance(tok, str) else tok[2])
            for fi, tok in enumerate(tokens)
            if isinstance(tok, str) or tok[1]
        ]
        for ki, (fi, tok) in enumerate(frames):
            if restrict is not None and tok not in restrict:
                continue
            curr_d = mot_rows(det_boxes[fi])
            curr_t = list(det_types[fi])
            curr_g = mot_rows(gt_boxes[fi])
            if ki == 0:
                prev = (None,) * 5
            else:
                pfi = frames[ki - 1][0]
                prev = (
                    mot_rows(det_boxes[pfi]),
                    list(det_types[pfi]),
                    mot_rows(gt_boxes[pfi]),
                    list(gt_types[pfi]),
                    list(gt_ids[pfi]),
                )
            matched, newborn = frame_gt_matrices(
                *prev, curr_d, curr_t, curr_g, list(gt_types[fi]), list(gt_ids[fi]),
                threshold=threshold,
            )
            np.savez_compressed(
                os.path.join(npz_path, tok + ".npz"),
                matched=matched if matched is not None else np.array(None),
                newborn=newborn,
            )


# -- full chain (preprocessing.sh) ------------------------------------------

def run_chain(
    dataroot: str,
    version: str,
    results_json: str,
    out_dir: str,
    split: str,
    scene_names=None,
    det_name: str = "cp",
    with_gt: bool = True,
    mode: str = "2hz",
):
    """mode='20hz' writes token/ego/gt artifacts over the full LIDAR sweep
    chain (10 Hz selection flags, interpolated GT) into {split}_20hz; the
    detection stages remain keyed by keyframe sample tokens, since
    CenterPoint results only exist at key frames."""
    db = NuscDB(dataroot, version)
    split_dir = os.path.join(out_dir, f"{split}_{mode}")
    write_token_info(db, scene_names, split_dir, mode=mode)
    write_ego_info(db, scene_names, split_dir, mode=mode)
    if with_gt:
        write_gt_info(db, scene_names, split_dir, mode=mode)
    write_detections(results_json, split_dir, det_name)
    write_det_frames(results_json, split_dir, det_name)
    write_sensor_det_frames(db, results_json, split_dir, det_name)
    frame_info_path = os.path.join(out_dir, f"{split}_frame_info.json")
    write_frame_info(db, scene_names, frame_info_path)
    if with_gt:
        write_gt_shasta(split_dir, det_name, frame_info_path=frame_info_path)
