"""Synthetic data, made from a seed with numpy.

- `make_batch`: fixed-shape batches, a copy of
  shasta_tpu.data.synthetic.make_batch (same seed, same arrays: the parity
  tests feed one batch to both packages). `cfg` needs max_obj, grid_shape
  and num_input_features.
- `write_track_split`: a preprocessed split on disk, in the files the
  nuScenes dataset reader (data/nuscenes.py) reads, a train split with its
  GT affinity labels; `write_split_config` points a config at it.
- `build_synthetic_world`, `build_micro_nusc`: raw nuScenes dataroots (the
  devkit's json tables, lidar .bin files, a detector results json and a
  key-frame infos pickle) that the offline chain (preprocessing/) reads;
  copies of tests/fixtures_nusc.py's builders, which write the same tables,
  clouds, results and infos for the same arguments.
- `build_synthetic_waymo`: raw Waymo segments (TFRecords of Frame protos
  with range images, GT and detection Objects bins) that the Waymo
  extraction reads; `write_waymo_pkl_tree` decodes them into the
  {split}/{lidar,annos} pkl tree of create_data --waymo.
"""
from __future__ import annotations

import json
import os
import pathlib
import pickle
import struct
import zlib

import numpy as np

from ..core.boxes import yaw_to_quaternion
from ..preprocessing.gt_shasta import frame_gt_matrices, mot_rows, write_frame_labels


def make_batch(
    cfg,
    batch_size: int = 1,
    num_voxels_cap: int = 30000,
    points_per_voxel: int = 10,
    n_dets: int | None = None,
    with_gt: bool = False,
    seed: int = 0,
    occupancy: float = 0.9,
) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    B, V, P = batch_size, num_voxels_cap, points_per_voxel
    N = cfg.max_obj
    n = n_dets if n_dets is not None else max(1, N // 2)
    Z, Y, X = cfg.grid_shape

    def frame():
        m = int(V * occupancy)
        # unique random voxel coords, key-sorted like the host pipeline's
        # sort_voxels mode; duplicate draws go to the invalid tail
        coords = np.stack(
            [
                rng.integers(0, Z - 1, size=V),
                rng.integers(0, Y, size=V),
                rng.integers(0, X, size=V),
            ],
            axis=1,
        ).astype(np.int32)
        key = (coords[:, 0].astype(np.int64) * Y + coords[:, 1]) * X + coords[:, 2]
        order = np.argsort(key, kind="stable")
        m_ord = np.concatenate([order[order < m], order[order >= m]])
        coords = coords[m_ord] if m < V else coords[order]
        key = (coords[:, 0].astype(np.int64) * Y + coords[:, 1]) * X + coords[:, 2]
        dup = np.zeros((V,), bool)
        dup[1:m] = key[1:m] == key[:m - 1]
        keep = np.concatenate([np.where(~dup[:m])[0], np.where(dup[:m])[0],
                               np.arange(m, V)])
        coords = coords[keep]
        m -= int(dup.sum())
        nump = rng.integers(1, P + 1, size=V).astype(np.int32)
        vox = rng.normal(size=(V, P, cfg.num_input_features)).astype(np.float32)
        valid = (np.arange(V) < m)
        nump = np.where(valid, nump, 0).astype(np.int32)
        return vox, coords, nump, valid

    def boxes():
        b = np.zeros((N, 11), np.float32)
        b[:n, :2] = rng.uniform(-50, 50, (n, 2))
        b[:n, 2] = rng.uniform(-2, 1, n)
        b[:n, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
        b[:n, 6] = rng.uniform(-np.pi, np.pi, n)
        b[:n, 7:9] = rng.normal(size=(n, 2))
        b[:n, 9] = 0.5
        b[:n, 10] = rng.uniform(0.1, 1.0, n)
        return b

    batch: dict[str, np.ndarray] = {}
    for prefix in ("", "prev_"):
        vox, coords, nump, valid = frame()
        batch[prefix + "voxels"] = np.stack([vox] * B)
        batch[prefix + "coordinates"] = np.stack([coords] * B)
        batch[prefix + "num_points"] = np.stack([nump] * B)
        batch[prefix + "voxels_valid"] = np.stack([valid] * B)
    batch["det_boxes"] = np.stack([boxes() for _ in range(B)])
    batch["prev_det_boxes"] = np.stack([boxes() for _ in range(B)])

    if with_gt:
        gt = np.zeros((B, N + 2, N + 2), np.float32)
        for b in range(B):
            perm = rng.permutation(n)
            for i in range(n):
                r = rng.random()
                if r < 0.7:
                    gt[b, i, perm[i]] = 1.0  # matched pair
                elif r < 0.85:
                    gt[b, i, N] = 1.0  # dead track col
                else:
                    gt[b, i, N + 1] = 1.0  # FN col
            # newborn / FP rows over curr dets with no matched prev
            matched_cols = gt[b, :N, :N].sum(axis=0)
            for k in range(n):
                if matched_cols[k] == 0:
                    if rng.random() < 0.5:
                        gt[b, N, k] = 1.0  # newborn
                    else:
                        gt[b, N + 1, k] = 1.0  # FP
        batch["gt"] = gt
    return batch


# (tracking name, nuScenes category, size [w, l, h], share of the objects)
_CLASSES = (("car", "vehicle.car", (1.9, 4.6, 1.7), 0.7),
            ("pedestrian", "human.pedestrian.adult", (0.7, 0.7, 1.8), 0.2),
            ("bus", "vehicle.bus.rigid", (2.9, 11.0, 3.5), 0.1))


def _box_surface(center, size, yaw, n, rng) -> np.ndarray:
    """n points on the four side faces and the top of a box."""
    w, l, h = size
    u = rng.uniform(-0.5, 0.5, (n, 3)) * (w, l, h)
    face = rng.integers(0, 5, n)
    u[face == 0, 0], u[face == 1, 0] = w / 2, -w / 2
    u[face == 2, 1], u[face == 3, 1] = l / 2, -l / 2
    u[face == 4, 2] = h / 2
    c, s = np.cos(yaw), np.sin(yaw)
    # the box's x axis is its width, y its length; yaw turns it about z
    xy = u[:, :2] @ np.array([[c, s], [-s, c]])
    return np.concatenate([xy, u[:, 2:]], 1) + center


def _cloud(spots, objects, n, rng) -> np.ndarray:
    """(n, 5) f32 lidar rows [x, y, z, intensity, ring]: 80% drawn around the
    scene's static ground spots, 20% on the objects' surfaces."""
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


def write_track_split(root, cfg, n_scenes: int = 2, n_frames: int = 8, seed: int = 0,
                      n_objects: int = 40, n_points: int = 40000, n_spots: int = 12000,
                      sweeps_per_frame: int | None = None, split: str = "val") -> dict:
    """Write a synthetic preprocessed split in the files NuScenesTrackDataset
    reads, made from `seed` with numpy: the infos pickle (lidar paths and
    sweeps), the frame-info JSON, per-frame sensor (13-float rows) and class
    (detection dicts) detection JSONs, the lidar .bin files, and the
    gt_info JSONs that eval_tracking_lite scores against.

    cfg: a config (utils.Config) whose point_pipeline gives the range and
    the sweep count. Each scene holds n_objects objects (cars, pedestrians,
    buses) moving at constant velocity inside 70% of the range; each frame
    detects each object with probability 0.85 (noisy box, score in [0.3,
    1)) plus two false positives. A frame's key cloud has n_points points
    (80% around the scene's n_spots static ground spots, 20% on the
    objects); it lists sweeps_per_frame sweeps (default nsweeps) from a
    pool of nsweeps + 2 sweep files per scene, each with its own small
    transform and time lag. Frames are 0.5 s apart and scenes follow one
    another in time.

    split "val" gives a test-mode split; "train" also writes each frame's
    GT affinity labels (gt_shasta/cp/individual_frames/{token}.npz,
    frame_gt_matrices over all its detections and its GT objects, paired
    with the scene's previous frame) and its kwargs carry labels_path and
    test_mode=False. One split per root (the lidar files share a folder).
    Returns {split: the dataset kwargs, "gt_info_dir": ..., "tokens": the
    frame tokens in order}."""
    rng = np.random.default_rng(seed)
    root = os.path.abspath(str(root))
    pp = cfg.point_pipeline
    lo, hi = np.asarray(pp["pc_range"][:3]), np.asarray(pp["pc_range"][3:])
    nsweeps = int(pp["nsweeps"])
    n_sw = nsweeps if sweeps_per_frame is None else sweeps_per_frame
    if split not in ("val", "train"):
        raise ValueError(f"split must be 'val' or 'train', got {split!r}")
    split_dir = os.path.join(root, f"{split}_2hz")
    dirs = {k: os.path.join(split_dir, *p) for k, p in (
        ("det", ("detections", "cp", "sensor_individual_frames")),
        ("cls", ("detections", "cp", "cls_individual_frames")),
        ("gt", ("gt_info", "individual_frames")))}
    if split == "train":
        dirs["labels"] = os.path.join(split_dir, "gt_shasta", "cp", "individual_frames")
    dirs["lidar"] = os.path.join(root, "lidar")
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    ground_z = lo[2] + 0.4 * (hi[2] - lo[2])
    names = [c[0] for c in _CLASSES]
    shares = np.array([c[3] for c in _CLASSES])

    infos, frame_info, tokens = [], {}, []
    for si in range(n_scenes):
        spots = np.stack([rng.uniform(0.9 * lo[0], 0.9 * hi[0], n_spots),
                          rng.uniform(0.9 * lo[1], 0.9 * hi[1], n_spots),
                          np.full(n_spots, ground_z)], 1)
        kinds = rng.choice(len(_CLASSES), n_objects, p=shares / shares.sum())
        pos0 = rng.uniform(0.7 * lo[:2], 0.7 * hi[:2], (n_objects, 2))
        vel = rng.normal(0, 2.0, (n_objects, 2))
        yaw = rng.uniform(-np.pi, np.pi, n_objects)
        pool = []
        for k in range(nsweeps + 2):
            path = os.path.join(dirs["lidar"], f"s{si}_sweep{k}.bin")
            _cloud(spots, [], n_points // 2, rng).tofile(path)
            tm = np.eye(4)
            tm[:2, 3] = rng.normal(0, 0.02, 2)
            pool.append({"lidar_path": path, "transform_matrix": tm.tolist(),
                         "time_lag": 0.05 * (k + 1)})
        stoks = [f"s{si}f{t}" for t in range(n_frames)]
        prev = (None,) * 5  # the previous frame's (dets, types, GT, GT types, ids)
        for t, tok in enumerate(stoks):
            # 2 Hz frames; each scene starts 10 s after the one before ends,
            # so the frames of a split sort by timestamp scene by scene
            ts = 500_000 * (t + 1) + si * (n_frames + 20) * 500_000
            objs = []
            for o in range(n_objects):
                name, cat, size, _ = _CLASSES[kinds[o]]
                xy = pos0[o] + 0.5 * t * vel[o]
                objs.append({"id": f"s{si}o{o}", "name": name, "category": cat,
                             "translation": [float(xy[0]), float(xy[1]),
                                             float(ground_z + size[2] / 2)],
                             "size": list(size), "yaw": float(yaw[o]),
                             "velocity": [float(v) for v in vel[o]]})
            path = os.path.join(dirs["lidar"], f"{tok}.bin")
            _cloud(spots, objs, n_points, rng).tofile(path)
            chosen = rng.choice(len(pool), min(n_sw, len(pool)), replace=False)
            infos.append({"token": tok, "lidar_path": path, "timestamp": ts,
                          "sweeps": [pool[i] for i in sorted(chosen)]})
            frame_info[tok] = {
                "prev": stoks[t - 1] if t else "", "next": stoks[t + 1] if t + 1 < n_frames else "",
                "timestamp": ts, "prev_timestamp": ts - 500_000 if t else ts,
                "next_timestamp": ts + 500_000 if t + 1 < n_frames else ts}
            gt = {"frame_ids": [], "frame_types": [], "frame_bboxes": []}
            rows, dets = [], []
            for o in objs:
                q = yaw_to_quaternion(o["yaw"]).tolist()
                gt["frame_ids"].append(o["id"])
                gt["frame_types"].append(o["category"])
                gt["frame_bboxes"].append(o["translation"] + o["size"] + q + o["velocity"])
                if rng.random() < 0.85:
                    dets.append((o["name"], np.asarray(o["translation"]) + rng.normal(0, 0.2, 3),
                                 o["size"], o["yaw"] + rng.normal(0, 0.05),
                                 np.asarray(o["velocity"]) + rng.normal(0, 0.3, 2),
                                 rng.uniform(0.3, 1.0)))
            for _ in range(2):
                name = names[rng.integers(len(names))]
                dets.append((name, np.append(rng.uniform(0.7 * lo[:2], 0.7 * hi[:2]),
                                             ground_z + 0.8),
                             _CLASSES[names.index(name)][2], rng.uniform(-np.pi, np.pi),
                             np.zeros(2), rng.uniform(0.1, 0.5)))
            cls = []
            for name, tr, size, y, v, score in dets:
                q = yaw_to_quaternion(y).tolist()
                rows.append([*map(float, tr), *size, *q, *map(float, v), float(score)])
                cls.append({"sample_token": tok, "translation": [float(x) for x in tr],
                            "size": list(size), "rotation": q,
                            "velocity": [float(x) for x in v], "detection_name": name,
                            "detection_score": float(score),
                            "attribute_name": "vehicle.moving" if name != "pedestrian"
                            else "pedestrian.moving"})
            for key, obj in (("det", rows), ("cls", cls), ("gt", gt)):
                with open(os.path.join(dirs[key], tok + ".json"), "w") as f:
                    json.dump(obj, f)
            if split == "train":
                # the rows write_detections / write_gt_info would hold
                curr = (mot_rows([c["translation"] + c["size"] + c["rotation"]
                                  + [c["detection_score"]] for c in cls]),
                        [c["detection_name"] for c in cls], mot_rows(gt["frame_bboxes"]),
                        gt["frame_types"], gt["frame_ids"])
                write_frame_labels(os.path.join(dirs["labels"], tok + ".npz"),
                                   *frame_gt_matrices(*prev, *curr))
                prev = curr
        tokens += stoks

    info_path = os.path.join(root, f"infos_{split}.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    frame_info_path = os.path.join(root, f"{split}_frame_info.json")
    with open(frame_info_path, "w") as f:
        json.dump(frame_info, f)
    kwargs = dict(info_path=info_path, det_path=dirs["det"], cls_info_path=dirs["cls"],
                  frame_info_path=frame_info_path, test_mode=split == "val")
    if split == "train":
        kwargs["labels_path"] = dirs["labels"]
    return {split: kwargs, "gt_info_dir": dirs["gt"], "tokens": tokens}


def write_split_config(config_path: str, val: dict, out_path: str, **overrides) -> str:
    """A config file that runs `config_path` and serves `val` (dataset
    kwargs, as write_track_split returns) as its val split; each override
    name=dict merges into that config's dict of the same name (point_pipeline,
    model), any other value replaces it. Returns out_path."""
    lines = [
        "import importlib.util as _u",
        f"_s = _u.spec_from_file_location('_split_base', {str(config_path)!r})",
        "_m = _u.module_from_spec(_s)",
        "_s.loader.exec_module(_m)",
        "globals().update({k: v for k, v in vars(_m).items() if not k.startswith('__')})",
        "del _u, _s, _m",
        f"data = dict(data, val={val!r})",
    ]
    for k, v in overrides.items():
        lines.append(f"{k} = dict({k}, **{v!r})" if isinstance(v, dict) else f"{k} = {v!r}")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_path


# ---------------------------------------------------------------------------
# Raw nuScenes dataroots (copies of tests/fixtures_nusc.py)
# ---------------------------------------------------------------------------

def _write_png(path, pixels: np.ndarray) -> None:
    """An 8-bit grey (H, W) or RGB (H, W, 3) image as a PNG, with zlib alone."""
    h, w = pixels.shape[:2]
    color = 0 if pixels.ndim == 2 else 2
    raw = b"".join(b"\0" + row.tobytes() for row in np.ascontiguousarray(pixels, np.uint8))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                                       0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _rotmat_to_quat(R):
    """Rotation matrix -> quaternion [w, x, y, z] (for camera extrinsics)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return [float(w), float(x), float(y), float(z)]


# forward-looking camera: x_cam = -y_ego (right), y_cam = -z_ego (down),
# z_cam = +x_ego (forward); columns of R are the camera axes in ego coords
CAM_ROT = _rotmat_to_quat(np.array([[0.0, 0.0, 1.0],
                                    [-1.0, 0.0, 0.0],
                                    [0.0, -1.0, 0.0]]))
CAM_TRANS = [1.5, 0.0, 1.5]
CAM_INTRINSIC = [[400.0, 0.0, 300.0], [0.0, 400.0, 200.0], [0.0, 0.0, 1.0]]
CAM_WH = (600, 400)


def _write_tables(ver: pathlib.Path, tables) -> None:
    for name, table in tables:
        with open(ver / f"{name}.json", "w") as f:
            json.dump(table, f)


def build_synthetic_world(tmp_path, n_scenes=4, n_frames=12, n_objects=5,
                          det_noise=0.3, fp_per_frame=3, miss_prob=0.2,
                          span=18.0, seed=0):
    """A raw-table world under tmp_path/nuScenes (version v1.0-mini) for
    closed-loop tests: moving cars with constant velocity, noisy
    detections, mid-score false positives, and detection dropouts (so FP
    elimination and FN propagation have real work to do). Every frame is a
    key frame. Returns dict(root, results, infos, scene_names)."""
    root = pathlib.Path(tmp_path) / "nuScenes"
    ver = root / "v1.0-mini"
    ver.mkdir(parents=True)
    rng = np.random.default_rng(seed)

    scenes, samples, sample_data, ego_pose, anns = [], [], [], [], []
    instances, results = [], {}
    sweeps_dir = root / "sweeps"
    sweeps_dir.mkdir(exist_ok=True)
    infos = []

    for si in range(n_scenes):
        stoks = [f"s{si}f{i}" for i in range(n_frames)]
        scenes.append({
            "token": f"scene{si}", "name": f"scene-{si:04d}",
            "first_sample_token": stoks[0], "last_sample_token": stoks[-1],
            "log_token": "log0",
        })
        # constant-velocity cars
        pos0 = rng.uniform(-span, span, (n_objects, 2))
        vel = rng.uniform(-3, 3, (n_objects, 2))
        yaw = rng.uniform(-np.pi, np.pi, n_objects)
        for i, tok in enumerate(stoks):
            t_us = 1_000_000 * (i + 1) // 2
            samples.append({
                "token": tok, "timestamp": t_us, "scene_token": f"scene{si}",
                "prev": stoks[i - 1] if i > 0 else "",
                "next": stoks[i + 1] if i < n_frames - 1 else "",
            })
            bin_path = sweeps_dir / f"LIDAR_TOP_{si}_{i}.bin"
            # background returns + a dense cluster on every real object, so
            # BEV descriptors carry occupancy signal (true dets sit on
            # points, false positives on empty ground)
            bg = rng.uniform(-1, 1, size=(800, 5)).astype(np.float32)
            bg[:, :2] *= span
            bg[:, 2] = rng.uniform(-2, 0.5, 800)
            clusters = []
            for k in range(n_objects):
                cx, cy = pos0[k] + vel[k] * 0.5 * i
                c = np.zeros((40, 5), np.float32)
                c[:, 0] = cx + rng.uniform(-2.2, 2.2, 40)
                c[:, 1] = cy + rng.uniform(-1.0, 1.0, 40)
                c[:, 2] = rng.uniform(0.0, 1.5, 40)
                c[:, 3] = rng.uniform(0, 30, 40)
                clusters.append(c)
            pts = np.concatenate([bg] + clusters).astype(np.float32)
            pts.tofile(bin_path)
            sample_data.append({
                "token": f"sd{si}_{i}", "sample_token": tok, "is_key_frame": True,
                "timestamp": t_us, "filename": f"sweeps/LIDAR_TOP_{si}_{i}.bin",
                "ego_pose_token": f"ego{si}_{i}", "calibrated_sensor_token": "cs0",
                "prev": f"sd{si}_{i-1}" if i > 0 else "",
                "next": f"sd{si}_{i+1}" if i < n_frames - 1 else "",
            })
            ego_pose.append({
                "token": f"ego{si}_{i}",
                "translation": [0.0, 0.0, 0.0], "rotation": [1.0, 0, 0, 0],
            })
            infos.append({
                "token": tok,
                "lidar_path": str(bin_path),
                "sweeps": [],
            })
            dets = []
            for k in range(n_objects):
                x, y = pos0[k] + vel[k] * 0.5 * i
                anns.append({
                    "token": f"ann{si}_{i}_{k}", "sample_token": tok,
                    "instance_token": f"inst{si}_{k}",
                    "translation": [float(x), float(y), 0.5],
                    "size": [2.0, 4.5, 1.6],
                    "rotation": list(yaw_to_quaternion(float(yaw[k]))),
                    "num_lidar_pts": 10, "num_radar_pts": 0,
                    "prev": f"ann{si}_{i-1}_{k}" if i > 0 else "",
                    "next": f"ann{si}_{i+1}_{k}" if i < n_frames - 1 else "",
                })
                if rng.random() < miss_prob:
                    continue  # detection dropout
                nx, ny = x + rng.normal(0, det_noise), y + rng.normal(0, det_noise)
                dets.append({
                    "sample_token": tok,
                    "translation": [float(nx), float(ny), 0.5],
                    "size": [2.0, 4.5, 1.6],
                    "rotation": list(yaw_to_quaternion(float(yaw[k]))),
                    "velocity": [float(vel[k][0]), float(vel[k][1])],
                    "detection_name": "car",
                    "detection_score": float(rng.uniform(0.6, 0.95)),
                    "attribute_name": "vehicle.moving",
                })
            for _ in range(int(fp_per_frame)):
                fx, fy = rng.uniform(-span, span, 2)
                dets.append({
                    "sample_token": tok,
                    "translation": [float(fx), float(fy), 0.5],
                    "size": [2.0, 4.0, 1.5],
                    "rotation": [1.0, 0, 0, 0],
                    "velocity": [0.0, 0.0],
                    "detection_name": "car",
                    "detection_score": float(rng.uniform(0.4, 0.8)),
                    "attribute_name": "vehicle.moving",
                })
            results[tok] = dets
        for k in range(n_objects):
            instances.append({"token": f"inst{si}_{k}", "category_token": "cat_car"})

    _write_tables(ver, (
        ("scene", scenes), ("sample", samples), ("sample_data", sample_data),
        ("ego_pose", ego_pose),
        ("calibrated_sensor", [{"token": "cs0", "translation": [0, 0, 1.8],
                                "rotation": [1.0, 0, 0, 0]}]),
        ("sample_annotation", anns), ("instance", instances),
        ("category", [{"token": "cat_car", "name": "vehicle.car"}]), ("attribute", []),
        ("log", [{"token": "log0", "location": "synthetic"}]), ("map", []),
    ))
    results_path = root / "cp_results.json"
    with open(results_path, "w") as f:
        json.dump({"results": results, "meta": {}}, f)
    infos_path = root / "infos.pkl"
    with open(infos_path, "wb") as f:
        pickle.dump(infos, f)
    return dict(root=root, results=results_path, infos=infos_path,
                scene_names=[s["name"] for s in scenes])


def build_micro_nusc(tmp_path):
    """One scene under tmp_path/nuScenes (v1.0-mini), 3 key frames with two
    non-key lidar sweeps between each pair (the 20 Hz chain), 2 moving cars +
    1 FP detection, a front camera and a small map mask. Returns dict(root,
    results, infos, tokens)."""
    root = pathlib.Path(tmp_path) / "nuScenes"
    ver = root / "v1.0-mini"
    ver.mkdir(parents=True)
    rng = np.random.default_rng(0)

    n_frames = 3
    sample_tokens = [f"samp{i}" for i in range(n_frames)]
    scene = [{
        "token": "scene0", "name": "scene-0001",
        "first_sample_token": sample_tokens[0],
        "last_sample_token": sample_tokens[-1],
        "log_token": "log0",
    }]
    logs = [{"token": "log0", "location": "micro-town"}]
    # small rasterized map mask (res 0.5 m/px, 100 m x 100 m)
    maps_dir = root / "maps"
    maps_dir.mkdir(parents=True, exist_ok=True)
    mask = np.zeros((200, 200), np.uint8)
    mask[80:120, :] = 255  # a horizontal "road" band
    _write_png(maps_dir / "micro_map.png", mask)
    maps = [{
        "token": "map0", "log_tokens": ["log0"],
        "filename": "maps/micro_map.png", "category": "semantic_prior",
        "resolution": 0.5,
    }]
    samples, sample_data, ego_pose, anns = [], [], [], []
    calibrated = [
        {
            "token": "cs0",
            "translation": [0.9, 0.0, 1.8],
            "rotation": [1.0, 0, 0, 0],
        },
        {
            "token": "cs_cam",
            "translation": list(CAM_TRANS),
            "rotation": list(CAM_ROT),
            "camera_intrinsic": CAM_INTRINSIC,
        },
    ]
    instances = [
        {"token": "inst_a", "category_token": "cat_car"},
        {"token": "inst_b", "category_token": "cat_car"},
    ]
    categories = [{"token": "cat_car", "name": "vehicle.car"}]

    results = {}
    for i, tok in enumerate(sample_tokens):
        t_us = 1_000_000 * (i + 1) // 2  # 2 Hz
        samples.append({
            "token": tok, "timestamp": t_us, "scene_token": "scene0",
            "prev": sample_tokens[i - 1] if i > 0 else "",
            "next": sample_tokens[i + 1] if i < n_frames - 1 else "",
        })
        # lidar bin
        sweeps_dir = root / "sweeps"
        sweeps_dir.mkdir(exist_ok=True)
        bin_path = sweeps_dir / f"LIDAR_TOP_{i}.bin"
        pts = rng.uniform(-1, 1, size=(3000, 5)).astype(np.float32)
        pts[:, :2] *= 50
        pts[:, 2] = rng.uniform(-3, 1, 3000)
        pts.tofile(bin_path)
        sample_data.append({
            "token": f"sd{i}", "sample_token": tok, "is_key_frame": True,
            "timestamp": t_us,
            "filename": f"sweeps/LIDAR_TOP_{i}.bin",
            "ego_pose_token": f"ego{i}", "calibrated_sensor_token": "cs0",
            "prev": f"sd{i-1}m1" if i > 0 else "",
            "next": f"sd{i}m0" if i < n_frames - 1 else "",
        })
        # two intermediate (non-key) sweeps toward the next key frame, so
        # the 20 Hz chain + GT interpolation are exercised
        if i < n_frames - 1:
            for m in range(2):
                sample_data.append({
                    "token": f"sd{i}m{m}",
                    "sample_token": sample_tokens[i + 1],
                    "is_key_frame": False,
                    "timestamp": t_us + (m + 1) * 500_000 // 3,
                    "filename": f"sweeps/LIDAR_TOP_{i}.bin",
                    "ego_pose_token": f"ego{i}",
                    "calibrated_sensor_token": "cs0",
                    "prev": f"sd{i}" if m == 0 else f"sd{i}m0",
                    "next": f"sd{i}m1" if m == 0 else f"sd{i+1}",
                })
        # front camera key frame (for the scene renderer)
        cam_dir = root / "samples"
        cam_dir.mkdir(exist_ok=True)
        cam_file = cam_dir / f"CAM_FRONT_{i}.png"
        if not cam_file.exists():
            _write_png(cam_file, np.full((CAM_WH[1], CAM_WH[0], 3), 90, np.uint8))
        sample_data.append({
            "token": f"sdc{i}", "sample_token": tok, "is_key_frame": True,
            "timestamp": t_us,
            "filename": f"samples/CAM_FRONT_{i}.png",
            "width": CAM_WH[0], "height": CAM_WH[1],
            "ego_pose_token": f"ego{i}", "calibrated_sensor_token": "cs_cam",
            "prev": f"sdc{i-1}" if i > 0 else "",
            "next": f"sdc{i+1}" if i < n_frames - 1 else "",
        })
        ego_pose.append({
            "token": f"ego{i}",
            "translation": [0.0, 0.0, 0.0],
            "rotation": [1.0, 0, 0, 0],
        })
        # two GT cars moving +x at 4 m/s
        dets = []
        for k, inst in enumerate(("inst_a", "inst_b")):
            x = 10.0 * (k + 1) + 2.0 * i
            y = 5.0 * k
            anns.append({
                "token": f"ann{i}_{k}", "sample_token": tok,
                "instance_token": inst,
                "translation": [x, y, 0.5],
                "size": [2.0, 4.5, 1.6],
                "rotation": list(yaw_to_quaternion(0.1 * k)),
                "num_lidar_pts": 10, "num_radar_pts": 0,
                "prev": f"ann{i-1}_{k}" if i > 0 else "",
                "next": f"ann{i+1}_{k}" if i < n_frames - 1 else "",
            })
            dets.append({
                "sample_token": tok,
                "translation": [x + 0.1, y - 0.05, 0.5],
                "size": [2.0, 4.5, 1.6],
                "rotation": list(yaw_to_quaternion(0.1 * k)),
                "velocity": [4.0, 0.0],
                "detection_name": "car",
                "detection_score": 0.9 - 0.1 * k,
                "attribute_name": "vehicle.moving",
            })
        # one far FP
        dets.append({
            "sample_token": tok,
            "translation": [45.0, -40.0, 0.5],
            "size": [2.0, 4.0, 1.5],
            "rotation": [1.0, 0, 0, 0],
            "velocity": [0.0, 0.0],
            "detection_name": "car",
            "detection_score": 0.3,
            "attribute_name": "vehicle.moving",
        })
        results[tok] = dets

    _write_tables(ver, (
        ("scene", scene), ("sample", samples), ("sample_data", sample_data),
        ("ego_pose", ego_pose), ("calibrated_sensor", calibrated),
        ("sample_annotation", anns), ("instance", instances),
        ("category", categories), ("attribute", []),
        ("log", logs), ("map", maps),
    ))
    results_path = root / "cp_results.json"
    with open(results_path, "w") as f:
        json.dump({"results": results, "meta": {}}, f)

    # infos pkl (create_data equivalent for the micro set)
    infos = []
    for i, tok in enumerate(sample_tokens):
        infos.append({
            "token": tok,
            "lidar_path": str(root / "sweeps" / f"LIDAR_TOP_{i}.bin"),
            "sweeps": [],
        })
    infos_path = root / "infos.pkl"
    with open(infos_path, "wb") as f:
        pickle.dump(infos, f)

    return dict(root=root, results=results_path, infos=infos_path, tokens=sample_tokens)


# ---------------------------------------------------------------------------
# Raw Waymo segments: TFRecords of Frame protos and Objects bins
# ---------------------------------------------------------------------------

# Waymo's five lasers (dataset.proto LaserName): TOP 64 beams listed in the
# calibration, the four short-range lasers with only an inclination range;
# mount (x, y, z, yaw) on the vehicle
_WAYMO_LASERS = (
    (1, (1.43, 0.0, 2.18, 0.0), (-0.307, 0.042)),
    (2, (4.07, 0.0, 0.69, 0.0), (-1.571, 0.524)),
    (3, (3.24, 1.03, 0.98, np.pi / 2), (-1.571, 0.524)),
    (4, (3.24, -1.03, 0.98, -np.pi / 2), (-1.571, 0.524)),
    (5, (-1.15, 0.0, 0.46, np.pi), (-1.571, 0.524)),
)
# share of valid pixels per (laser kind, return): ~150k returns a frame
# at the real widths (TOP 64 x 2650, the others 200 x 600)
_WAYMO_VALID = {("top", 1): 0.85, ("top", 2): 0.02, ("side", 1): 0.01, ("side", 2): 0.002}
# Label.Type -> (length, width, height) of the synthetic objects
_WAYMO_SIZES = {1: (4.6, 2.0, 1.7), 2: (0.9, 0.9, 1.8), 4: (1.8, 0.7, 1.7)}


def _pose(yaw, t) -> np.ndarray:
    m = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = t
    return m


def _waymo_range_image(rng, hw, incl_top_first, height, valid):
    """(H, W, 4) [range, intensity, elongation, nlz]: rows that look down
    hit a flat ground at the mount's height, the others a wall 10-75 m
    away; empty pixels hold range -1."""
    h, w = hw
    ground = height / np.sin(np.maximum(-incl_top_first, 1e-3))
    r = np.where(incl_top_first < -0.02, np.minimum(ground, 75.0), 0.0)[:, None]
    r = r + np.where(r > 0, 0.0, rng.uniform(10.0, 75.0, (h, w)))
    r = r + rng.normal(0.0, 0.02, (h, w))
    mask = rng.random((h, w)) < valid
    ri = np.zeros((h, w, 4), np.float32)
    ri[..., 0] = np.where(mask, r, -1.0)
    ri[..., 1] = np.where(mask, rng.random((h, w)), 0.0)
    ri[..., 2] = np.where(mask, 0.5 * rng.random((h, w)), 0.0)
    ri[..., 3] = np.where(mask, -1.0, 0.0)
    return ri


def build_synthetic_waymo(root, n_segments=2, n_frames=20, top_hw=(64, 2650),
                          side_hw=(200, 600), n_objects=80, dets_per_frame=150,
                          miss_prob=0.1, det_noise=0.2, seed=0):
    """Raw Waymo segments under root, written with the port's codec
    (data.waymo_protos, data.tfrecord): records/segment-*.tfrecord of Frame
    protos at 10 Hz (the five lasers' two returns as zlib-compressed
    MatrixFloat range images, the TOP lidar's per-pixel pose, the laser
    calibrations, the vehicle pose and the frame's labelled objects in the
    vehicle frame), gt.bin (the labels as metrics Objects) and dets.bin
    (dets_per_frame boxes a frame: the objects detected with noise, missed
    with miss_prob, and false positives). The ego drives at 10 m/s; the
    objects move at constant velocity around it. Returns dict(records (the
    record directory), gt_bin, det_bin, segments (context names),
    timestamps (per segment), points (valid returns of each segment's
    first frame))."""
    from .tfrecord import write_tfrecord
    from .waymo_protos import encode_frame, encode_matrix_float, encode_objects

    root = pathlib.Path(root)
    rec_dir = root / "records"
    rec_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    gt_rows, det_rows, segments, stamps, points = [], [], [], [], []
    for k in range(n_segments):
        name = f"{seed:05d}{k:04d}_0000_000_0200_000"
        segments.append(name)
        types = rng.choice([1, 1, 1, 2, 4], n_objects)
        pos = rng.uniform(-60.0, 60.0, (n_objects, 2)) + [[30.0, 0.0]]
        vel = rng.normal(0.0, 3.0, (n_objects, 2)) * (types == 1)[:, None]
        vel += rng.normal(0.0, 1.0, (n_objects, 2))
        yaw_obj = np.arctan2(vel[:, 1], vel[:, 0])
        npts = np.where(rng.random(n_objects) < 0.1, 0, rng.integers(1, 500, n_objects))
        level = np.where(rng.random(n_objects) < 0.2, 2, 0)
        top_incl = np.sort(rng.uniform(*_WAYMO_LASERS[0][2], top_hw[0]))  # bottom-up
        calibs = [{
            "name": laser,
            "extrinsic": {"transform": [float(v) for v in _pose(myaw, (mx, my, mz)).reshape(-1)]},
            **({"beam_inclinations": [float(v) for v in top_incl]} if laser == 1 else {
                "beam_inclination_min": rng_incl[0], "beam_inclination_max": rng_incl[1]}),
        } for laser, (mx, my, mz, myaw), rng_incl in _WAYMO_LASERS]
        ts0 = 1_550_000_000_000_000 + 10**9 * k
        payloads, seg_ts = [], []
        for i in range(n_frames):
            t = 0.1 * i
            ego_yaw = 0.02 * t
            pose = _pose(ego_yaw, (10.0 * t, 0.5 * t, 0.0))
            ts = ts0 + 100_000 * i
            seg_ts.append(ts)
            lasers, n_valid = [], 0
            for laser, (_, _, mz, _), incl_range in _WAYMO_LASERS:
                kind = "top" if laser == 1 else "side"
                hw = top_hw if kind == "top" else side_hw
                incl = (top_incl if kind == "top" else
                        (np.arange(hw[0]) + 0.5) / hw[0] * (incl_range[1] - incl_range[0])
                        + incl_range[0])[::-1]
                entry = {"name": laser}
                for ret in (1, 2):
                    ri = _waymo_range_image(rng, hw, incl, mz, _WAYMO_VALID[(kind, ret)])
                    n_valid += int((ri[..., 0] > 0).sum())
                    msg = {"range_image_compressed": zlib.compress(encode_matrix_float(ri), 1)}
                    if kind == "top" and ret == 1:
                        # rolling shutter: the columns span the 0.1 s sweep
                        dt = (np.arange(hw[1]) / hw[1] - 0.5) * 0.1
                        pp = np.zeros(hw + (6,), np.float32)
                        pp[..., 2] = ego_yaw + 0.002 * dt
                        pp[..., 3] = pose[0, 3] + 10.0 * dt
                        pp[..., 4] = pose[1, 3] + 0.5 * dt
                        msg["range_image_pose_compressed"] = zlib.compress(
                            encode_matrix_float(pp), 1)
                    entry[f"ri_return{ret}"] = msg
                lasers.append(entry)
            if i == 0:
                points.append(n_valid)
            # objects: global -> this frame's vehicle frame
            p_glob = pos + vel * t
            rel = (p_glob - pose[:2, 3]) @ pose[:2, :2]
            heading = yaw_obj - ego_yaw
            labels = []
            for j in range(n_objects):
                length, width, height = _WAYMO_SIZES[int(types[j])]
                labels.append({
                    "box": {"center_x": float(rel[j, 0]), "center_y": float(rel[j, 1]),
                            "center_z": 0.5 * height, "width": width, "length": length,
                            "height": height, "heading": float(heading[j])},
                    "metadata": {"speed_x": float(vel[j, 0]), "speed_y": float(vel[j, 1]),
                                 "accel_x": 0.0, "accel_y": 0.0},
                    "type": int(types[j]), "id": f"{name}-obj{j}",
                    "detection_difficulty_level": int(level[j]),
                    "num_lidar_points_in_box": int(npts[j]),
                })
                gt_rows.append({"object": labels[-1], "score": 1.0, "context_name": name,
                                "frame_timestamp_micros": ts})
            payloads.append(encode_frame({
                "context": {"name": name,
                            "stats": {"location": "location_sf", "time_of_day": "Day",
                                      "weather": "sunny"},
                            "laser_calibrations": calibs},
                "timestamp_micros": ts,
                "pose": {"transform": [float(v) for v in pose.reshape(-1)]},
                "lasers": lasers,
                "laser_labels": labels,
            }))
            seen = np.flatnonzero(rng.random(n_objects) >= miss_prob)
            n_fp = max(dets_per_frame - len(seen), 0)
            fp_types = rng.choice([1, 2, 4], n_fp)
            fp_xy = rng.uniform(-75.0, 75.0, (n_fp, 2))
            for j, typ, xy, score in (
                    [(j, types[j], rel[j] + rng.normal(0.0, det_noise, 2), rng.uniform(0.5, 1.0))
                     for j in seen]
                    + [(None, fp_types[f], fp_xy[f], rng.uniform(0.05, 0.5))
                       for f in range(n_fp)]):
                length, width, height = _WAYMO_SIZES[int(typ)]
                head = heading[j] if j is not None else rng.uniform(-np.pi, np.pi)
                v = vel[j] if j is not None else np.zeros(2)
                det_rows.append({
                    "object": {
                        "box": {"center_x": float(xy[0]), "center_y": float(xy[1]),
                                "center_z": 0.5 * height, "width": width, "length": length,
                                "height": height,
                                "heading": float(head + rng.normal(0.0, 0.05))},
                        "metadata": {"speed_x": float(v[0]), "speed_y": float(v[1])},
                        "type": int(typ),
                    },
                    "score": float(score), "context_name": name,
                    "frame_timestamp_micros": ts,
                })
        write_tfrecord(str(rec_dir / f"segment-{name}_with_camera_labels.tfrecord"), payloads)
        stamps.append(seg_ts)
    gt_bin, det_bin = root / "gt.bin", root / "dets.bin"
    gt_bin.write_bytes(encode_objects(gt_rows))
    det_bin.write_bytes(encode_objects(det_rows))
    return dict(records=rec_dir, gt_bin=gt_bin, det_bin=det_bin, segments=segments,
                timestamps=stamps, points=points)


def write_waymo_pkl_tree(records, root, split="train") -> list[str]:
    """The {split}/{lidar,annos}/seq_{s}_frame_{f}.pkl tree that
    create_data --waymo reads (det3d's waymo_converter layout): per frame of
    record s (sorted by name), data.waymo_decode.decode_frame's lidar dict
    and decode_annos' annotations. Returns the pkl names."""
    from .tfrecord import read_tfrecord
    from .waymo_decode import decode_annos, decode_frame
    from .waymo_protos import parse_frame

    names = []
    for sub in ("lidar", "annos"):
        os.makedirs(os.path.join(root, split, sub), exist_ok=True)
    for s, rec in enumerate(sorted(os.listdir(records))):
        for f, payload in enumerate(read_tfrecord(os.path.join(records, rec))):
            frame = parse_frame(payload)
            name = f"seq_{s}_frame_{f}.pkl"
            for sub, obj in (("lidar", decode_frame(frame, f)), ("annos", decode_annos(frame, f))):
                with open(os.path.join(root, split, sub, name), "wb") as fh:
                    pickle.dump(obj, fh)
            names.append(name)
    return names
