"""Waymo full-frame decoding + infos + official-format prediction files;
the port of shasta_tpu/data/waymo_decode.py (numpy, on the host).

Behavioral reference (det3d/datasets/waymo/):
  waymo_decoder.py:22-68    decode_frame / decode_annos (frame_name,
                            veh_to_global, object extraction)
  waymo_decoder.py:71-154   range-image -> point-cloud extraction (the
                            reference defers to TF's range_image_utils;
                            here the spherical-projection math is numpy)
  waymo_decoder.py:156-207  global_vel_to_ref + extract_objects (speed /
                            accel / difficulty levels)
  waymo_common.py:52-115    _create_pd_detection (KITTI->Waymo coordinate
                            conversion + tracking-id UUIDs)
  waymo_common.py:176-320   veh_pos_to_transform / _fill_infos /
                            create_waymo_infos (10-sweep transform chains)
  waymo_common.py:282-304   sort_frame / get_available_frames

Everything is dependency-free: protos parse via data/waymo_protos.py and
the pose algebra is plain numpy (the reference routes a pure rotation
through pyquaternion; R^-1 == R^T for rotations, applied directly here).
Range images and their poses decode through
waymo_protos.decode_matrix_float: the same float64 arrays as the JAX
module's per-value decode, read with np.frombuffer.
"""
from __future__ import annotations

import os
import pickle
import uuid
from functools import reduce

import numpy as np

TYPE_LIST = ("UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST")
CAT_NAME_TO_ID = {"VEHICLE": 1, "PEDESTRIAN": 2, "SIGN": 3, "CYCLIST": 4}
# tracking label index -> Waymo Label.Type, sign ignored (waymo_common.py:39)
LABEL_TO_TYPE = {0: 1, 1: 2, 2: 4}


# ---------------------------------------------------------------------------
# range image -> points (waymo_decoder.py:71-154 without TF)
# ---------------------------------------------------------------------------
def range_image_to_points(
    range_image: np.ndarray,
    extrinsic: np.ndarray,
    inclinations: np.ndarray,
    pixel_pose: np.ndarray | None = None,
    frame_pose: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Spherical range image -> cartesian points in the vehicle frame.

    range_image: (H, W, C) with channel 0 = range (<=0 marks empty) and
      channels 1: carried through as features (intensity, elongation, nlz).
    extrinsic: (4, 4) sensor-to-vehicle transform.
    inclinations: (H,) beam inclination per ROW, top row first (the
      reference reverses the calibration order, waymo_decoder.py:114).
    pixel_pose: optional (H, W, 4, 4) per-pixel vehicle-to-global pose
      (TOP lidar rolling-shutter correction); frame_pose (4, 4) required
      with it — points are mapped global -> reference vehicle frame.

    Returns (points (N, 3+C-1) [x, y, z, features...], mask (H, W) of the
    valid pixels). Matches TF range_image_utils: azimuth spans pi..-pi
    left-to-right, corrected by the extrinsic yaw.
    """
    H, W = range_image.shape[:2]
    r = range_image[..., 0]
    mask = r > 0

    az_correction = float(np.arctan2(extrinsic[1, 0], extrinsic[0, 0]))
    ratios = (np.arange(W, 0, -1, dtype=np.float64) - 0.5) / W
    azimuth = (ratios * 2 - 1) * np.pi - az_correction  # (W,)

    cos_az = np.cos(azimuth)[None, :]
    sin_az = np.sin(azimuth)[None, :]
    cos_incl = np.cos(inclinations)[:, None]
    sin_incl = np.sin(inclinations)[:, None]

    x = cos_az * cos_incl * r
    y = sin_az * cos_incl * r
    z = sin_incl * r
    pts = np.stack([x, y, z, np.ones_like(r)], axis=-1)  # (H, W, 4) sensor

    pts = pts @ extrinsic.T  # sensor -> vehicle
    if pixel_pose is not None:
        if frame_pose is None:
            raise ValueError("frame_pose is required with pixel_pose")
        pts = np.einsum("hwij,hwj->hwi", pixel_pose, pts)  # vehicle -> global
        pts = pts @ np.linalg.inv(frame_pose).T  # global -> ref vehicle

    feats = range_image[..., 1:]
    out = np.concatenate([pts[..., :3], feats], axis=-1)
    return out[mask], mask


def compute_inclination(inclination_range, height: int) -> np.ndarray:
    """Uniform beam inclinations when the calibration lists none
    (range_image_utils.compute_inclination): bin centers bottom-up."""
    lo, hi = inclination_range
    frac = (np.arange(height, dtype=np.float64) + 0.5) / height
    return lo + frac * (hi - lo)


# ---------------------------------------------------------------------------
# object extraction (waymo_decoder.py:156-207)
# ---------------------------------------------------------------------------
def global_vel_to_ref(vel, global_from_ref_rotation: np.ndarray):
    """Global-frame (vx, vy) -> reference-vehicle frame (:156-162).

    The reference normalizes through pyquaternion; for the pure rotation
    the pose carries this is exactly R^T @ v."""
    v = np.array([vel[0], vel[1], 0.0])
    ref = np.asarray(global_from_ref_rotation, np.float64).T @ v
    return [ref[0], ref[1], 0.0]


def extract_objects(laser_labels, global_from_ref_rotation) -> list[dict]:
    """Label protos -> annotation dicts with ALL the reference fields
    (:164-207): 9-dof box incl. ref-frame velocity, num_points, difficulty
    levels, global speed/accel.

    Difficulty quirk preserved: the reference's `combined = 999` for empty
    boxes (:176-177) is dead code — the following if/else (:178-185)
    always overwrites it — so combined is 1/2 from the point count when
    the labeler level is unset, else the labeler level."""
    objects = []
    for object_id, label in enumerate(laser_labels):
        box = label.box
        speed = [label.metadata.speed_x, label.metadata.speed_y]
        accel = [label.metadata.accel_x, label.metadata.accel_y]
        num_points = label.num_lidar_points_in_box
        if label.detection_difficulty_level == 0:
            combined = 1 if num_points >= 5 else 2
        else:
            combined = label.detection_difficulty_level
        ref_velocity = global_vel_to_ref(speed, global_from_ref_rotation)
        objects.append({
            "id": object_id,
            "name": label.id,
            "label": label.type,
            "box": np.array([
                box.center_x, box.center_y, box.center_z,
                box.length, box.width, box.height,
                ref_velocity[0], ref_velocity[1], box.heading,
            ], dtype=np.float32),
            "num_points": num_points,
            "detection_difficulty_level": label.detection_difficulty_level,
            "combined_difficulty_level": combined,
            "global_speed": np.array(speed, dtype=np.float32),
            "global_accel": np.array(accel, dtype=np.float32),
        })
    return objects


def frame_name(frame) -> str:
    """'{scene}_{location}_{time_of_day}_{timestamp}' (:29-33)."""
    return "{}_{}_{}_{}".format(
        frame.context.name,
        frame.context.stats.location,
        frame.context.stats.time_of_day,
        frame.timestamp_micros,
    )


def decode_annos(frame, frame_id: int) -> dict:
    """Frame proto -> annos dict (:45-68): veh_to_global + objects."""
    veh_to_global = np.array(frame.pose.transform)
    ref_pose = np.reshape(veh_to_global, [4, 4])
    return {
        "scene_name": frame.context.name,
        "frame_name": frame_name(frame),
        "frame_id": frame_id,
        "veh_to_global": veh_to_global,
        "objects": extract_objects(frame.laser_labels, ref_pose[:3, :3]),
    }


# ---------------------------------------------------------------------------
# infos with sweep transform chains (waymo_common.py:176-320)
# ---------------------------------------------------------------------------
def veh_pos_to_transform(veh_pos: np.ndarray):
    """4x4 vehicle pose -> (global_from_car, car_from_global) (:176-189)."""
    veh_pos = np.asarray(veh_pos, np.float64).reshape(4, 4)
    global_from_car = veh_pos.copy()
    car_from_global = np.eye(4)
    R = veh_pos[:3, :3]
    t = veh_pos[:3, 3]
    car_from_global[:3, :3] = R.T
    car_from_global[:3, 3] = -R.T @ t
    return global_from_car, car_from_global


def _get_obj(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def sort_frame(frames: list[str]) -> list[str]:
    """seq_X_frame_Y.pkl names in (seq, frame) order (:282-295)."""
    idx = [int(f.split("_")[1]) * 1000 + int(f.split("_")[3][:-4]) for f in frames]
    return [frames[r] for r in np.argsort(np.asarray(idx))]


def get_available_frames(root: str, split: str) -> list[str]:
    return sort_frame(list(os.listdir(os.path.join(root, split, "lidar"))))


def fill_infos(root_path: str, frames: list[str], split: str = "train",
               nsweeps: int = 1) -> list[dict]:
    """Per-frame info dicts incl. the multi-sweep veh_to_global transform
    chains (:191-280): sweep k's transform_matrix maps ITS vehicle frame
    into the reference frame via ref_from_global @ global_from_car."""
    infos = []
    for fname in frames:
        lidar_path = os.path.join(root_path, split, "lidar", fname)
        anno_path = os.path.join(root_path, split, "annos", fname)
        ref_obj = _get_obj(anno_path)
        ref_time = 1e-6 * int(ref_obj["frame_name"].split("_")[-1])
        ref_pose = np.reshape(ref_obj["veh_to_global"], [4, 4])
        _, ref_from_global = veh_pos_to_transform(ref_pose)

        info = {
            "path": lidar_path,
            "anno_path": anno_path,
            "token": fname,
            "timestamp": ref_time,
            "sweeps": [],
        }
        sequence_id = int(fname.split("_")[1])
        frame_id = int(fname.split("_")[3][:-4])

        prev_id = frame_id
        sweeps: list[dict] = []
        while len(sweeps) < nsweeps - 1:
            if prev_id <= 0:
                if not sweeps:
                    sweeps.append({
                        "path": lidar_path,
                        "token": fname,
                        "transform_matrix": None,
                        "time_lag": 0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                prev_id -= 1
                curr_name = f"seq_{sequence_id}_frame_{prev_id}.pkl"
                curr_obj = _get_obj(
                    os.path.join(root_path, split, "annos", curr_name)
                )
                curr_pose = np.reshape(curr_obj["veh_to_global"], [4, 4])
                global_from_car, _ = veh_pos_to_transform(curr_pose)
                tm = reduce(np.dot, [ref_from_global, global_from_car])
                time_lag = ref_time - 1e-6 * int(
                    curr_obj["frame_name"].split("_")[-1]
                )
                sweeps.append({
                    "path": os.path.join(root_path, split, "lidar", curr_name),
                    "transform_matrix": tm,
                    "time_lag": time_lag,
                })
        info["sweeps"] = sweeps

        if split != "test":
            annos = ref_obj["objects"]
            num_points_in_gt = np.array([a["num_points"] for a in annos])
            gt_boxes = np.array([a["box"] for a in annos]).reshape(-1, 9)
            if len(gt_boxes) != 0:
                # Waymo -> KITTI-style convention the models consume
                # (:266-270): heading flips to -pi/2 - r, l/w swap
                gt_boxes[:, -1] = -np.pi / 2 - gt_boxes[:, -1]
                gt_boxes[:, [3, 4]] = gt_boxes[:, [4, 3]]
            gt_names = np.array([TYPE_LIST[a["label"]] for a in annos])
            mask = (num_points_in_gt > 0).reshape(-1)
            info["gt_boxes"] = gt_boxes[mask, :].astype(np.float32)
            info["gt_names"] = gt_names[mask].astype(str)
        infos.append(info)
    return infos


def create_waymo_infos(root_path: str, split: str = "train",
                       nsweeps: int = 1) -> str:
    """fill_infos over the available frames -> infos pkl (:307-320)."""
    frames = get_available_frames(root_path, split)
    infos = fill_infos(root_path, frames, split, nsweeps)
    out = os.path.join(
        root_path,
        f"infos_{split}_{nsweeps:02d}sweeps_filter_zero_gt.pkl",
    )
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    return out


def reorganize_info(infos: list[dict]) -> dict:
    return {info["token"]: info for info in infos}


# ---------------------------------------------------------------------------
# official-format prediction files (waymo_common.py:41-115)
# ---------------------------------------------------------------------------
class UUIDGeneration:
    """Stable uuid per tracking id within one submission (:43-50)."""

    def __init__(self):
        self.mapping: dict = {}

    def get_uuid(self, seed) -> str:
        if seed not in self.mapping:
            self.mapping[seed] = uuid.uuid4().hex
        return self.mapping[seed]


def create_pd_detection(detections: dict, infos: dict, result_path: str,
                        tracking: bool = False) -> str:
    """Predictions -> metrics_pb2.Objects bin (:52-115).

    detections: {token: {"box3d_lidar": (N, 7+) KITTI-convention boxes,
      "scores": (N,), "label_preds": (N,) tracking label ints,
      "tracking_ids": (N,) when tracking}}; infos: reorganize_info() dict
    whose anno pkls carry scene_name/frame_name.
    """
    from .waymo_protos import encode_objects

    uuid_gen = UUIDGeneration()
    rows = []
    for token, detection in detections.items():
        info = infos[token]
        obj = _get_obj(info["anno_path"])
        box3d = np.array(detection["box3d_lidar"], np.float64).copy()
        scores = np.asarray(detection["scores"], np.float64)
        labels = np.asarray(detection["label_preds"], np.int64)
        # KITTI -> Waymo: r2 = -pi/2 - r1, then w/l swap (:67-72)
        box3d[:, -1] = -box3d[:, -1] - np.pi / 2
        box3d = box3d[:, [0, 1, 2, 4, 3, 5, -1]]
        tracking_ids = detection.get("tracking_ids") if tracking else None
        for i in range(box3d.shape[0]):
            det = box3d[i]
            label = {
                "box": {
                    "center_x": det[0], "center_y": det[1], "center_z": det[2],
                    "length": det[3], "width": det[4], "height": det[5],
                    "heading": det[-1],
                },
                "type": LABEL_TO_TYPE[int(labels[i])],
            }
            if tracking:
                label["id"] = uuid_gen.get_uuid(int(tracking_ids[i]))
            rows.append({
                "object": label,
                "score": float(scores[i]),
                "context_name": obj["scene_name"],
                "frame_timestamp_micros": int(obj["frame_name"].split("_")[-1]),
            })
    name = "tracking_pred.bin" if tracking else "detection_pred.bin"
    path = os.path.join(result_path, name)
    with open(path, "wb") as f:
        f.write(encode_objects(rows))
    return path


def create_gt_detection(infos: list[dict], result_path: str) -> str:
    """GT -> Objects bin for local official eval (:117-174)."""
    from .waymo_protos import encode_objects

    rows = []
    for info in infos:
        obj = _get_obj(info["anno_path"])
        annos = obj["objects"]
        if not annos:
            continue
        for ann in annos:
            if ann["num_points"] == 0:
                continue
            name = TYPE_LIST[ann["label"]]
            if name == "UNKNOWN":
                continue
            box = np.asarray(ann["box"], np.float64)
            det = box[[0, 1, 2, 3, 4, 5, -1]]
            rows.append({
                "object": {
                    "box": {
                        "center_x": det[0], "center_y": det[1],
                        "center_z": det[2], "length": det[3],
                        "width": det[4], "height": det[5],
                        "heading": det[6],
                    },
                    "type": CAT_NAME_TO_ID[name],
                    "num_lidar_points_in_box": int(ann["num_points"]),
                    "id": ann["name"],
                },
                "score": 1.0,
                "context_name": obj["scene_name"],
                "frame_timestamp_micros": int(obj["frame_name"].split("_")[-1]),
            })
    path = os.path.join(result_path, "gt_preds.bin")
    with open(path, "wb") as f:
        f.write(encode_objects(rows))
    return path


# ---------------------------------------------------------------------------
# full-frame point extraction (waymo_decoder.py:71-154, TF-free)
# ---------------------------------------------------------------------------
LASER_TOP = 1  # dataset.proto LaserName.TOP


def _rotation_matrix(roll, pitch, yaw) -> np.ndarray:
    """transform_utils.get_rotation_matrix: R = Rz(yaw) Ry(pitch) Rx(roll),
    vectorized over leading dims."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    o = np.ones_like(cr)
    z = np.zeros_like(cr)
    rx = np.stack([
        np.stack([o, z, z], -1),
        np.stack([z, cr, -sr], -1),
        np.stack([z, sr, cr], -1),
    ], -2)
    ry = np.stack([
        np.stack([cp, z, sp], -1),
        np.stack([z, o, z], -1),
        np.stack([-sp, z, cp], -1),
    ], -2)
    rz = np.stack([
        np.stack([cy, -sy, z], -1),
        np.stack([sy, cy, z], -1),
        np.stack([z, z, o], -1),
    ], -2)
    return rz @ ry @ rx


def extract_points_from_range_image(laser, calibration, frame_pose) -> list[np.ndarray]:
    """One laser's two returns -> [points (N, 6)] in the vehicle frame
    (waymo_decoder.py:71-132). TOP lidar applies the per-pixel pose
    (rolling-shutter correction) through the frame pose."""
    import zlib

    from .waymo_protos import decode_matrix_float

    if laser.name != calibration.name:
        raise ValueError("Laser and calibration do not match")
    pixel_pose = None
    fp = None
    if laser.name == LASER_TOP and laser.ri_return1.range_image_pose_compressed:
        fp = np.asarray(frame_pose.transform, np.float64).reshape(4, 4)
        # (H, W, 6) roll/pitch/yaw + xyz
        pose = decode_matrix_float(
            zlib.decompress(laser.ri_return1.range_image_pose_compressed))
        R = _rotation_matrix(pose[..., 0], pose[..., 1], pose[..., 2])
        pixel_pose = np.zeros(pose.shape[:2] + (4, 4))
        pixel_pose[..., :3, :3] = R
        pixel_pose[..., :3, 3] = pose[..., 3:6]
        pixel_pose[..., 3, 3] = 1.0

    extrinsic = np.asarray(calibration.extrinsic.transform, np.float64).reshape(4, 4)
    points_list = []
    for ri in (laser.ri_return1, laser.ri_return2):
        if not ri.range_image_compressed:
            continue
        range_image = decode_matrix_float(
            zlib.decompress(ri.range_image_compressed))  # (H, W, 4)
        H = range_image.shape[0]
        if len(calibration.beam_inclinations):
            incl = np.asarray(calibration.beam_inclinations, np.float64)
        else:
            incl = compute_inclination(
                (calibration.beam_inclination_min, calibration.beam_inclination_max),
                H,
            )
        incl = incl[::-1]  # top row first (waymo_decoder.py:114)
        pts, _ = range_image_to_points(
            range_image, extrinsic, incl,
            pixel_pose=pixel_pose,
            frame_pose=fp if pixel_pose is not None else None,
        )
        points_list.append(pts)
    return points_list


def extract_points(lasers, laser_calibrations, frame_pose) -> dict:
    """All lasers -> {'points_xyz' (N,3), 'points_feature' (N,2)}
    (waymo_decoder.py:135-154; feature = intensity, elongation)."""
    key = lambda x: x.name  # noqa: E731
    xyz, feat = [], []
    for laser, calib in zip(sorted(lasers, key=key),
                            sorted(laser_calibrations, key=key)):
        pl = extract_points_from_range_image(laser, calib, frame_pose)
        if not pl:
            continue
        points = np.concatenate(pl, axis=0)
        xyz.append(points[:, :3].astype(np.float32))
        feat.append(points[:, 3:5].astype(np.float32))
    if not xyz:
        # every laser decoded to zero points: on real data this means the
        # RangeImage/Context field numbering is wrong (the exact failure
        # mode of the round-3 schema transcription bug), not an empty sweep
        import warnings
        warnings.warn(
            "extract_points: all %d lasers decoded to zero points — "
            "range_image_compressed empty on every return; check the proto "
            "schema field numbers" % len(list(lasers)), RuntimeWarning)
        return {"points_xyz": np.zeros((0, 3), np.float32),
                "points_feature": np.zeros((0, 2), np.float32)}
    return {
        "points_xyz": np.concatenate(xyz, axis=0),
        "points_feature": np.concatenate(feat, axis=0),
    }


def decode_frame(frame, frame_id: int) -> dict:
    """Frame proto -> lidar example dict (waymo_decoder.py:22-42)."""
    lidars = extract_points(frame.lasers, frame.context.laser_calibrations,
                            frame.pose)
    return {
        "scene_name": frame.context.name,
        "frame_name": frame_name(frame),
        "frame_id": frame_id,
        "lidars": lidars,
    }


def extract_raw_pc(tfrecord_path: str, out_dir: str) -> str:
    """TFRecord -> raw_pc/{segment}.npz of {str(frame): (N, 3) pc}
    (preprocessing/waymo_data/testset/raw_pc.py contract; feeds
    preprocessing.waymo_ground.remove_ground_tree)."""
    from .tfrecord import read_tfrecord
    from .waymo_protos import parse_frame

    seg = os.path.basename(tfrecord_path).split(".")[0]
    out = {}
    for i, payload in enumerate(read_tfrecord(tfrecord_path)):
        frame = parse_frame(payload)
        out[str(i)] = decode_frame(frame, i)["lidars"]["points_xyz"]
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, seg + ".npz"), **out)
    return seg


# ---------------------------------------------------------------------------
# point loading over the pkl tree (pipelines/loading.py:71-175, Waymo branch)
# ---------------------------------------------------------------------------
def read_single_waymo(obj: dict) -> np.ndarray:
    """lidar pkl -> (N, 5) [x, y, z, tanh(intensity), elongation]
    (loading.py:71-80)."""
    points_xyz = obj["lidars"]["points_xyz"]
    points_feature = np.array(obj["lidars"]["points_feature"], copy=True)
    points_feature[:, 0] = np.tanh(points_feature[:, 0])
    return np.concatenate([points_xyz, points_feature], axis=-1)


def read_single_waymo_sweep(sweep: dict) -> tuple[np.ndarray, np.ndarray]:
    """Sweep pkl -> points transformed into the reference frame + per-point
    time lags (loading.py:82-101)."""
    obj = _get_obj(sweep["path"])
    points_sweep = read_single_waymo(obj).T  # 5 x N
    nbr = points_sweep.shape[1]
    if sweep["transform_matrix"] is not None:
        points_sweep[:3, :] = sweep["transform_matrix"].dot(
            np.vstack((points_sweep[:3, :], np.ones(nbr)))
        )[:3, :]
    times = sweep["time_lag"] * np.ones((1, nbr))
    return points_sweep.T, times.T


def load_waymo_points(info: dict, nsweeps: int = 1) -> np.ndarray:
    """Reference frame + (nsweeps-1) aligned sweeps -> (N, 5) or, with
    sweeps, (N, 6) with the time-lag channel appended
    (loading.py:150-175 WaymoDataset branch)."""
    obj = _get_obj(info["path"])
    points = read_single_waymo(obj)
    if nsweeps <= 1:
        return points
    sweep_points = [points]
    sweep_times = [np.zeros((points.shape[0], 1))]
    for i in range(nsweeps - 1):
        ps, ts = read_single_waymo_sweep(info["sweeps"][i])
        sweep_points.append(ps)
        sweep_times.append(ts)
    pts = np.concatenate(sweep_points, axis=0)
    times = np.concatenate(sweep_times, axis=0).astype(pts.dtype)
    return np.hstack([pts, times])
