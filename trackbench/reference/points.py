"""The reference's data path: reading a split's files as
the nuScenes dataset does (the same generator draws in the same order),
the sweeps' transform and the voxelizer (det3d's points_to_voxel: first
arrival order, at most max_points points a voxel, at most max_voxels
voxels; the valid rows sorted by key, padded to max_voxels), in torch on
the device it is given.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch


def yaw_to_quaternion(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2.0), 0.0, 0.0, np.sin(yaw / 2.0)])


def quaternion_yaw(q) -> float:
    """Yaw of a [w, x, y, z] quaternion: the x axis rotated by it."""
    q = np.asarray(q, np.float64)
    n = np.linalg.norm(q)
    w, x, y, z = q / (n if n > 0 else 1.0)
    return float(np.arctan2(2.0 * (x * y + z * w), 1.0 - 2.0 * (y * y + z * z)))


def det_row(tr, size, yaw, vel, dt, score) -> list:
    """[x, y, z, w, l, h, yaw, vx, vy, dt, score]."""
    return [*map(float, tr), *map(float, size), float(yaw), *map(float, vel), float(dt),
            float(score)]


def sweep_cloud(key: np.ndarray, sweeps: list[dict]) -> np.ndarray:
    """The key cloud (lag channel 0) and each sweep without the ego
    vehicle's returns (|x| and |y| below 1 m), moved by its 4 x 4 transform,
    its time lag in channel 4."""
    key = key.copy()
    key[:, 4] = 0.0
    clouds = [key]
    for sw in sweeps:
        p = sw["points"].copy()
        p[:, 4] = 0.0
        p = p[~((np.abs(p[:, 0]) < 1.0) & (np.abs(p[:, 1]) < 1.0))]
        tm = np.asarray(sw["transform_matrix"])
        xyz1 = np.concatenate([p[:, :3], np.ones((len(p), 1), np.float32)], 1)
        p[:, :3] = (xyz1 @ tm.T)[:, :3]
        p[:, 4] = sw["time_lag"]
        clouds.append(p)
    return np.concatenate(clouds, axis=0)


def voxelize(points, pp: dict, device="cpu") -> dict:
    """The step's voxel arrays of one cloud (N, 5) under the point pipeline
    pp, as host arrays: voxels (V, P, 5), coordinates (V, 3) zyx, num_points
    (V,), voxels_valid (V,), V = max_voxels. A point's cell is the floor of
    its float32 offset from the range's corner over the voxel size, in
    float64 (the port's host runtime's arithmetic). A voxel keeps its first
    max_points points in arrival order; past max_voxels the voxels whose
    first point came last are dropped; the valid rows are sorted by their
    (z, y, x) key. Computed on `device`."""
    p = torch.as_tensor(np.ascontiguousarray(points, np.float32), device=device)
    vs = torch.tensor(pp["voxel_size"], dtype=torch.float32, device=device)
    lo = torch.tensor(pp["pc_range"][:3], dtype=torch.float32, device=device)
    gs = np.round((np.asarray(pp["pc_range"][3:], np.float64) - np.asarray(pp["pc_range"][:3]))
                  / np.asarray(pp["voxel_size"], np.float64)).astype(np.int64)  # x, y, z
    # the offset in float32, divided in float64 by the float32 voxel size
    c = torch.floor((p[:, :3] - lo).double() / vs.double()).long()
    ok = ((c >= 0) & (c < torch.tensor(gs, device=device))).all(1)
    idx = torch.nonzero(ok)[:, 0]
    c = c[idx]
    key = (c[:, 2] * int(gs[1]) + c[:, 1]) * int(gs[0]) + c[:, 0]
    sk, order = torch.sort(key, stable=True)  # by voxel, arrival order inside
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = sk[1:] != sk[:-1]
    vid = torch.cumsum(head.long(), 0) - 1
    ar = torch.arange(len(sk), device=device)
    pos = ar - torch.cummax(torch.where(head, ar, 0), 0).values
    n_vox, V, P = int(head.sum()), pp["max_voxels"], pp["max_points_in_voxel"]
    keep_vox = torch.ones(n_vox, dtype=torch.bool, device=device)
    if n_vox > V:  # the voxels whose first point (order[head]) arrived first
        first = order[head]
        keep_vox[torch.argsort(first, stable=True)[V:]] = False
    new_id = torch.cumsum(keep_vox.long(), 0) - 1
    kp = keep_vox[vid] & (pos < P)
    M = int(keep_vox.sum())
    voxels = torch.zeros((V, P, p.shape[1]), dtype=torch.float32, device=device)
    voxels[new_id[vid[kp]], pos[kp]] = p[idx[order[kp]]]
    num = torch.zeros(V, dtype=torch.int32, device=device)
    num.index_add_(0, new_id[vid[kp]], torch.ones(int(kp.sum()), dtype=torch.int32,
                                                  device=device))
    coords = torch.zeros((V, 3), dtype=torch.int32, device=device)
    hk = head & keep_vox[vid]
    coords[new_id[vid[hk]]] = c[order[hk]].flip(1).int()
    return dict(voxels=voxels.cpu().numpy(), coordinates=coords.cpu().numpy(),
                num_points=num.cpu().numpy(), voxels_valid=np.arange(V) < M)


class SplitReader:
    """A val split read as the port's dataset reads it in test mode: one
    numpy generator of seed 0 drawn in index order, for each frame the
    nsweeps - 1 sweeps of the frame's and then of its previous frame's
    (the frame's own at a scene's start), detections filtered to det_type.
    `frame(i)` gives frame i's voxel arrays, det rows and detection dicts;
    the frames have to be asked for in index order."""

    def __init__(self, kwargs: dict, pp: dict, det_type, max_objects: int, device="cpu"):
        with open(kwargs["info_path"], "rb") as f:
            self.infos = pickle.load(f)
        with open(kwargs["frame_info_path"]) as f:
            self.frame_info = json.load(f)
        self.kw, self.pp, self.det_type, self.max_objects = kwargs, pp, det_type, max_objects
        self.rng = np.random.default_rng(0)
        self.device = device
        self.next = 0

    def _dets(self, token: str, dt: float):
        with open(os.path.join(self.kw["det_path"], token + ".json")) as f:
            raw = json.load(f)
        with open(os.path.join(self.kw["cls_info_path"], token + ".json")) as f:
            cls = json.load(f)
        rows, dicts = [], []
        for b, ci in zip(raw, cls):
            if ci["detection_name"] not in self.det_type:
                continue
            b = np.asarray(b, np.float64)
            rows.append(np.concatenate([b[:3], b[3:6], [quaternion_yaw(b[6:10])], b[10:12],
                                        [dt], [ci["detection_score"]]]))
            dicts.append(ci)
        if len(rows) > self.max_objects:
            raise ValueError(f"{token}: more detections than max_obj (the mix caps them)")
        boxes = np.zeros((self.max_objects, 11), np.float64)
        if rows:
            boxes[:len(rows)] = np.stack(rows)
        return boxes.astype(np.float32), dicts

    def _choose(self, info):
        sweeps = info.get("sweeps", [])
        if not sweeps:
            return []
        return [sweeps[i] for i in self.rng.choice(
            len(sweeps), min(self.pp["nsweeps"] - 1, len(sweeps)), replace=False)]

    def skip(self, i: int) -> None:
        """Frame i's generator draws, without reading it."""
        self._advance(i)
        self._choose(self.infos[i])
        self._choose(self.infos[i - 1] if self.frame_info[self.infos[i]["token"]]["prev"]
                     else self.infos[i])

    def _advance(self, i: int) -> None:
        if i != self.next:
            raise ValueError("frames are read in index order")
        self.next += 1

    def frame(self, i: int) -> dict:
        self._advance(i)
        info = self.infos[i]
        tok = info["token"]
        fi = self.frame_info[tok]
        dt = 1e-6 * fi["timestamp"] - 1e-6 * fi["prev_timestamp"]
        prev = fi["prev"]
        prev_boxes, prev_dicts = (self._dets(prev, dt) if prev else
                                  (np.zeros((self.max_objects, 11), np.float32), []))
        boxes, dicts = self._dets(tok, dt)
        chosen = self._choose(info)
        self._choose(self.infos[i - 1] if prev else info)  # the prev frame's draw
        sweeps = [dict(sw, points=np.fromfile(sw["lidar_path"], np.float32).reshape(-1, 5))
                  for sw in chosen]
        key = np.fromfile(info["lidar_path"], np.float32).reshape(-1, 5)
        out = voxelize(sweep_cloud(key, sweeps), self.pp, self.device)
        out.update(token=tok, prev_token=prev, det_boxes=boxes, prev_det_boxes=prev_boxes,
                   cls_det_boxes=dicts, prev_cls_det_boxes=prev_dicts)
        return out
