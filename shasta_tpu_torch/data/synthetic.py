"""Synthetic data, made from a seed with numpy.

- `make_batch`: fixed-shape batches, a copy of
  shasta_tpu.data.synthetic.make_batch (same seed, same arrays: the parity
  tests feed one batch to both packages). `cfg` needs max_obj, grid_shape
  and num_input_features.
- `write_track_split`: a preprocessed split on disk, in the files the
  nuScenes dataset reader (data/nuscenes.py) reads, a train split with its
  GT affinity labels; `write_split_config` points a config at it.
"""
from __future__ import annotations

import json
import os
import pickle

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
