"""The MVP traffic: scenes.py's scenes, each frame's cloud as the point rows
of CenterPoint-MVP (Yin, Zhou, Krähenbühl, NeurIPS 2021), painted and with
virtual points, padded to a fixed row count with a mask.

A row has 16 channels: x, y, z (0:3); 11 channels (3:14) that a real
point fills with its intensity and zeros, and a painted or virtual point
with the one-hot of its 2D detection's class over nuScenes' ten detection
classes (3:13) and that detection's score (13); the type (14: 1 real, 0
painted, -1 virtual); the time lag (15).

A frame of the mix (made with the draws of scenes.stream_scenes, then its
own):
- the real points: the key cloud and nsweeps - 1 sweeps, as stream_scenes
  makes them (`sweep_cloud`);
- the key cloud's object points (its last fifth, split over the objects
  in order) painted: type 0, their object's class and score;
- `virtual_points` virtual points an object a sweep, for the key frame
  (lag 0) and each sweep (at its time lag), uniform inside the object's
  box moved back by its velocity times the lag, with its class and score:
  type -1. Each object's 2D score is drawn once a frame, in [0.3, 1).

Only the rows' count varies from frame to frame; `rows` pads them to the
mix's `cloud_rows`.
"""
from __future__ import annotations

import numpy as np

from ..reference.points import det_row, sweep_cloud
from .scenes import _cloud, _sweep_choice, detections, make_scene, objects_at

# nuScenes' ten detection classes, in CenterPoint's task order
DETECTION_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
                     "motorcycle", "bicycle", "pedestrian", "traffic_cone")
ROW = 16
TYPE, TIME = 14, 15


def _box_volume(center, size, yaw, n, rng) -> np.ndarray:
    """n points uniform inside a box."""
    u = rng.uniform(-0.5, 0.5, (n, 3)) * np.asarray(size)
    c, s = np.cos(yaw), np.sin(yaw)
    xy = u[:, :2] @ np.array([[c, s], [-s, c]])
    return np.concatenate([xy, u[:, 2:]], 1) + center


def cloud_rows(rng, pts: np.ndarray, key_points: int, objs: list[dict], lags: list,
               per_object: int) -> np.ndarray:
    """The frame's (N, 16) f32 rows from its real cloud pts (N_real, 5)
    [x, y, z, intensity, lag] (the key cloud's rows first), its objects and
    the lags of the key frame and its sweeps."""
    paint = np.zeros((len(objs), 11), np.float32)
    for i, o in enumerate(objs):
        paint[i, DETECTION_CLASSES.index(o["name"])] = 1.0
    paint[:, 10] = rng.uniform(0.3, 1.0, len(objs))
    real = np.zeros((len(pts), ROW), np.float32)
    real[:, :4] = pts[:, :4]
    real[:, TYPE] = 1.0
    real[:, TIME] = pts[:, 4]
    n_obj = key_points // 5
    owner = np.concatenate([np.full(len(p), i) for i, p in
                            enumerate(np.array_split(np.arange(n_obj), len(objs)))])
    painted = slice(key_points - n_obj, key_points)
    real[painted, 3:14] = paint[owner]
    real[painted, TYPE] = 0.0
    parts = [real]
    for lag in lags:
        for i, o in enumerate(objs):
            v = np.zeros((per_object, ROW), np.float32)
            center = np.asarray(o["translation"]) - lag * np.append(o["velocity"], 0.0)
            v[:, :3] = _box_volume(center, o["size"], o["yaw"], per_object, rng)
            v[:, 3:14] = paint[i]
            v[:, TYPE] = -1.0
            v[:, TIME] = lag
            parts.append(v)
    return np.concatenate(parts)


def rows(cloud: np.ndarray, n_cap: int) -> tuple[np.ndarray, np.ndarray]:
    """cloud (N, 16) padded with zero rows to (n_cap, 16), and its mask."""
    if len(cloud) > n_cap:
        raise ValueError(f"a cloud of {len(cloud)} rows over the mix's {n_cap}")
    out = np.zeros((n_cap, cloud.shape[1]), np.float32)
    out[:len(cloud)] = cloud
    return out, np.arange(n_cap) < len(cloud)


def mvp_scenes(seed: int, mix: dict, pp: dict, caps: dict) -> list[list[dict]]:
    """The mix's scenes in memory, one list of frames per scene. A frame:
    `cloud` (cloud_rows, 16) f32 host rows and their mask `cloud_valid`;
    `boxes` {class: (n_c, 11) f32 det rows} for every class with a
    detection; `lag`, the time since the scene's previous frame (0 at its
    first). caps: {name: max_obj}."""
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
            use = rng.choice(len(chosen), min(nsweeps - 1, len(chosen)), replace=False)
            sweeps = [scene["pool"][chosen[i]] for i in use]
            pts = sweep_cloud(key, sweeps)
            lag = mix["frame_dt"] if t else 0.0
            boxes: dict = {}
            for name, tr, size, y, v, score in detections(rng, scene, objs, mix, caps):
                boxes.setdefault(name, []).append(det_row(tr, size, y, v, lag, score))
            cloud = cloud_rows(rng, pts, mix["key_points"], objs,
                               [0.0] + [sw["time_lag"] for sw in sweeps], mix["virtual_points"])
            frame = dict(zip(("cloud", "cloud_valid"), rows(cloud, mix["cloud_rows"])))
            frame["boxes"] = {k: np.asarray(v, np.float32) for k, v in boxes.items()}
            frame["lag"] = lag
            frames.append(frame)
        scenes.append(frames)
    return scenes
