"""The traffic generator: synthetic nuScenes-like scenes made from a seed.

A copy of shasta_tpu_torch/data/synthetic.py's `write_track_split` and its
helpers (`_box_surface`, `_cloud`), kept here so that a change to the
program cannot move the yardstick, and extended to the seven nuScenes
tracking classes of the mix file:

- every scene holds the mix's `objects`, split over the classes by their
  shares with the largest remainder, so each seed gets the same class
  counts in another order, moving at constant velocity;
- each frame detects each object with probability `detect_p` (noisy box,
  score in [0.3, 1)) and adds false positives at `fp_ratio` of each
  class's true detections; a class's detections are capped at its max_obj;
- a frame's cloud is its key cloud (`key_points`, 80% around the scene's
  static ground spots, 20% on the objects) and nsweeps - 1 sweeps drawn
  from a pool of nsweeps + 2 per scene, each with its own small transform
  and time lag. Frames are `frame_dt` apart.

`write_split` writes the files the port's NuScenesTrackDataset reads;
`stream_scenes` gives the same kind of scenes in memory, voxelized.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

from ..reference.points import det_row, sweep_cloud, voxelize, yaw_to_quaternion


def class_counts(shares, n: int) -> list[int]:
    """n split by shares, largest remainder first (ties to the earlier class)."""
    s = np.asarray(shares, np.float64)
    q = s / s.sum() * n
    out = np.floor(q).astype(int)
    order = sorted(range(len(s)), key=lambda i: (-(q[i] - out[i]), i))
    for i in order[: n - int(out.sum())]:
        out[i] += 1
    return out.tolist()


def _box_surface(center, size, yaw, n, rng) -> np.ndarray:
    """n points on the four side faces and the top of a box."""
    w, l, h = size
    u = rng.uniform(-0.5, 0.5, (n, 3)) * (w, l, h)
    face = rng.integers(0, 5, n)
    u[face == 0, 0], u[face == 1, 0] = w / 2, -w / 2
    u[face == 2, 1], u[face == 3, 1] = l / 2, -l / 2
    u[face == 4, 2] = h / 2
    c, s = np.cos(yaw), np.sin(yaw)
    xy = u[:, :2] @ np.array([[c, s], [-s, c]])
    return np.concatenate([xy, u[:, 2:]], 1) + center


def _cloud(spots, objects, n, rng) -> np.ndarray:
    """(n, 5) f32 rows [x, y, z, intensity, 0]: 80% around the ground spots,
    20% on the objects' surfaces (all around the spots without objects)."""
    n_obj = n // 5 if objects else 0
    g = spots[rng.integers(0, len(spots), n - n_obj)] + rng.normal(0, 0.01, (n - n_obj, 3))
    parts = [g]
    if n_obj:
        per = np.array_split(np.arange(n_obj), len(objects))
        parts += [_box_surface(np.asarray(o["translation"]), o["size"], o["yaw"], len(p), rng)
                  for o, p in zip(objects, per)]
    xyz = np.concatenate(parts)
    return np.concatenate([xyz, rng.uniform(0, 1, (n, 1)), np.zeros((n, 1))],
                          1).astype(np.float32)


def make_scene(rng, mix: dict, pc_range, nsweeps: int) -> dict:
    """One scene: ground spots, objects and a pool of nsweeps + 2 sweeps."""
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:])
    ground_z = lo[2] + 0.4 * (hi[2] - lo[2])
    n_spots, n_obj = mix["spots"], mix["objects"]
    spots = np.stack([rng.uniform(0.9 * lo[0], 0.9 * hi[0], n_spots),
                      rng.uniform(0.9 * lo[1], 0.9 * hi[1], n_spots),
                      np.full(n_spots, ground_z)], 1)
    counts = class_counts([c["share"] for c in mix["classes"]], n_obj)
    kinds = rng.permutation(np.repeat(np.arange(len(counts)), counts))
    pos0 = rng.uniform(0.7 * lo[:2], 0.7 * hi[:2], (n_obj, 2))
    vel = rng.normal(0, 2.0, (n_obj, 2))
    yaw = rng.uniform(-np.pi, np.pi, n_obj)
    pool = []
    for k in range(nsweeps + 2):
        tm = np.eye(4)
        tm[:2, 3] = rng.normal(0, 0.02, 2)
        pool.append({"points": _cloud(spots, [], mix["sweep_points"], rng),
                     "transform_matrix": tm, "time_lag": 0.05 * (k + 1)})
    return dict(spots=spots, kinds=kinds, pos0=pos0, vel=vel, yaw=yaw, pool=pool,
                ground_z=ground_z, lo=lo, hi=hi)


def objects_at(scene: dict, t: int, mix: dict) -> list[dict]:
    out = []
    for o, k in enumerate(scene["kinds"]):
        c = mix["classes"][k]
        xy = scene["pos0"][o] + mix["frame_dt"] * t * scene["vel"][o]
        out.append({"name": c["name"], "category": c["category"],
                    "translation": [float(xy[0]), float(xy[1]),
                                    float(scene["ground_z"] + c["size"][2] / 2)],
                    "size": list(c["size"]), "yaw": float(scene["yaw"][o]),
                    "velocity": [float(v) for v in scene["vel"][o]]})
    return out


def detections(rng, scene: dict, objs: list[dict], mix: dict, caps: dict) -> list[tuple]:
    """The frame's detections (name, translation, size, yaw, velocity,
    score), class by class in the mix's order; caps: {name: max_obj}."""
    lo, hi = scene["lo"], scene["hi"]
    by_class: dict = {c["name"]: [] for c in mix["classes"]}
    for o in objs:
        if rng.random() < mix["detect_p"]:
            by_class[o["name"]].append((
                o["name"], np.asarray(o["translation"]) + rng.normal(0, 0.2, 3), o["size"],
                o["yaw"] + rng.normal(0, 0.05), np.asarray(o["velocity"]) + rng.normal(0, 0.3, 2),
                rng.uniform(0.3, 1.0)))
    out = []
    for c in mix["classes"]:
        dets = by_class[c["name"]]
        for _ in range(int(round(len(dets) * mix["fp_ratio"]))):
            dets.append((c["name"], np.append(rng.uniform(0.7 * lo[:2], 0.7 * hi[:2]),
                                              scene["ground_z"] + 0.8),
                         c["size"], rng.uniform(-np.pi, np.pi), np.zeros(2),
                         rng.uniform(0.1, 0.5)))
        out += dets[: caps.get(c["name"], len(dets))]
    return out


def _sweep_choice(rng, pool_len: int, nsweeps: int) -> np.ndarray:
    return np.sort(rng.choice(pool_len, min(nsweeps, pool_len), replace=False))


def write_split(root: str, seed: int, mix: dict, pp: dict, caps: dict) -> dict:
    """A preprocessed val split under root, in the files the port's
    NuScenesTrackDataset reads (the layout of write_track_split): the infos
    pickle, the frame-info JSON, per-frame sensor and class detection JSONs
    and the lidar .bin files. pp: the configuration's point_pipeline.
    Returns the dataset's keyword arguments and the tokens in order."""
    rng = np.random.default_rng(seed)
    root = os.path.abspath(root)
    dirs = {k: os.path.join(root, "val_2hz", "detections", "cp", d) for k, d in
            (("det", "sensor_individual_frames"), ("cls", "cls_individual_frames"))}
    dirs["lidar"] = os.path.join(root, "lidar")
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    nsweeps = int(pp["nsweeps"])
    n_frames, dt_us = mix["frames"], int(round(mix["frame_dt"] * 1e6))
    infos, frame_info, tokens = [], {}, []
    for si in range(mix["scenes"]):
        scene = make_scene(rng, mix, pp["pc_range"], nsweeps)
        pool = []
        for k, sw in enumerate(scene["pool"]):
            path = os.path.join(dirs["lidar"], f"s{si}_sweep{k}.bin")
            sw["points"].tofile(path)
            pool.append({"lidar_path": path, "transform_matrix": sw["transform_matrix"].tolist(),
                         "time_lag": sw["time_lag"]})
        stoks = [f"s{si}f{t}" for t in range(n_frames)]
        for t, tok in enumerate(stoks):
            ts = dt_us * (t + 1) + si * (n_frames + 20) * dt_us
            objs = objects_at(scene, t, mix)
            path = os.path.join(dirs["lidar"], f"{tok}.bin")
            _cloud(scene["spots"], objs, mix["key_points"], rng).tofile(path)
            chosen = _sweep_choice(rng, len(pool), nsweeps)
            infos.append({"token": tok, "lidar_path": path, "timestamp": ts,
                          "sweeps": [pool[i] for i in chosen]})
            frame_info[tok] = {
                "prev": stoks[t - 1] if t else "",
                "next": stoks[t + 1] if t + 1 < n_frames else "",
                "timestamp": ts, "prev_timestamp": ts - dt_us if t else ts,
                "next_timestamp": ts + dt_us if t + 1 < n_frames else ts}
            rows, cls = [], []
            for name, tr, size, y, v, score in detections(rng, scene, objs, mix, caps):
                q = yaw_to_quaternion(y).tolist()
                rows.append([*map(float, tr), *size, *q, *map(float, v), float(score)])
                cls.append({"sample_token": tok, "translation": [float(x) for x in tr],
                            "size": list(size), "rotation": q,
                            "velocity": [float(x) for x in v], "detection_name": name,
                            "detection_score": float(score),
                            "attribute_name": "pedestrian.moving" if name == "pedestrian"
                            else "vehicle.moving"})
            for key, obj in (("det", rows), ("cls", cls)):
                with open(os.path.join(dirs[key], tok + ".json"), "w") as f:
                    json.dump(obj, f)
        tokens += stoks
    info_path = os.path.join(root, "infos_val.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    frame_info_path = os.path.join(root, "val_frame_info.json")
    with open(frame_info_path, "w") as f:
        json.dump(frame_info, f)
    return {"kwargs": dict(info_path=info_path, det_path=dirs["det"], cls_info_path=dirs["cls"],
                           frame_info_path=frame_info_path, test_mode=True),
            "tokens": tokens}


def stream_scenes(seed: int, mix: dict, pp: dict, caps: dict, device="cpu") -> list[list[dict]]:
    """The mix's scenes in memory, one list of frames per scene. A frame:
    the voxel arrays of its cloud (key cloud and nsweeps - 1 sweeps of the
    pool, as the dataset reads them), padded to max_voxels; `boxes`
    {class: (n_c, 11) f32 det rows [x, y, z, w, l, h, yaw, vx, vy, dt,
    score]} for every class with a detection; `lag`, the time since the
    scene's previous frame (0 at its first)."""
    rng = np.random.default_rng(seed)
    nsweeps = int(pp["nsweeps"])
    scenes = []
    for _ in range(mix["scenes"]):
        scene = make_scene(rng, mix, pp["pc_range"], nsweeps)
        frames = []
        for t in range(mix["frames"]):
            objs = objects_at(scene, t, mix)
            key = _cloud(scene["spots"], objs, mix["key_points"], rng)
            chosen = _sweep_choice(rng, len(scene["pool"]), nsweeps)
            # the dataset's draw of nsweeps - 1 of the listed sweeps
            use = rng.choice(len(chosen), min(nsweeps - 1, len(chosen)), replace=False)
            sweeps = [scene["pool"][chosen[i]] for i in use]
            pts = sweep_cloud(key, sweeps)
            lag = mix["frame_dt"] if t else 0.0
            boxes: dict = {}
            for name, tr, size, y, v, score in detections(rng, scene, objs, mix, caps):
                boxes.setdefault(name, []).append(det_row(tr, size, y, v, lag, score))
            frame = voxelize(pts, pp, device)
            frame["boxes"] = {k: np.asarray(v, np.float32) for k, v in boxes.items()}
            frame["lag"] = lag
            frames.append(frame)
        scenes.append(frames)
    return scenes
