"""nuScenes tracking dataset: the port of shasta_tpu/data/nuscenes.py
(frame pairs, detection loading, GT affinity matrices, the host point
pipeline and `collate`).

Behavioral reference: det3d/datasets/nuscenes/nuscenes.py:54-411. Reads the
preprocessed artifact tree the JAX package and the reference write:

  {split}_frame_info.json            token -> prev/next tokens + timestamps
  detections/cp/sensor_individual_frames/{token}.json
      rows [tx,ty,tz, w,l,h, qw,qx,qy,qz, vx,vy, score] (13) in LiDAR frame
  detections/cp/cls_individual_frames/{token}.json
      full detection dicts (translation/size/rotation/velocity/name/score)
  gt_shasta/cp/individual_frames/{token}.npz   matched (N, K+2), newborn (K)
  infos_{split}_10sweeps_withvelo*.pkl         lidar paths + sweep transforms

Numpy only, with the same np.random.Generator calls in the same order as
the JAX dataset, so a sample is bit-identical to the JAX dataset's for the
same seed. Voxelization runs the port's C++ runtime and raises where the
library cannot be built (no numpy fallback). The samples are fixed-shape:
(max_obj, 11) det rows and (V, P, 5) voxels with validity masks.
`CachedFeatureDataset` serves training's precomputed BEV descriptors.
"""
from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from .. import runtime
from ..core.boxes import quaternion_yaw


# ---------------------------------------------------------------------------
# Detection loading (nuscenes.py:213-293)
# ---------------------------------------------------------------------------

def load_frame_detections(
    det_path: str,
    cls_path: str,
    token: str,
    det_type: Sequence[str] | None,
    max_objects: int,
    time_diff: float,
    rng: np.random.Generator,
):
    """Returns (boxes11 (max_obj, 11), cls_dicts list, keep indices, count).

    Row layout [x,y,z,w,l,h,yaw,vx,vy,dt,score] (nuscenes.py:230-232);
    class-filtered, randomly subsampled (sorted index order) past max_obj.
    """
    boxes = np.zeros((max_objects, 11), np.float64)
    with open(os.path.join(det_path, token + ".json")) as f:
        raw = json.load(f)
    with open(os.path.join(cls_path, token + ".json")) as f:
        cls_info = json.load(f)

    rows, cls_out, keep = [], [], []
    for i, (b, ci) in enumerate(zip(raw, cls_info)):
        if det_type is not None and ci["detection_name"] not in det_type:
            continue
        b = np.asarray(b, np.float64)
        yaw = quaternion_yaw(b[6:10])
        rows.append(
            np.concatenate(
                [b[:3], b[3:6], [yaw], b[10:12], [time_diff], [ci["detection_score"]]]
            )
        )
        cls_out.append(ci)
        keep.append(i)

    if len(rows) > max_objects:
        sel = sorted(rng.choice(len(rows), size=max_objects, replace=False).tolist())
        rows = [rows[i] for i in sel]
        cls_out = [cls_out[i] for i in sel]
        keep = [keep[i] for i in sel]

    n = len(rows)
    if n:
        boxes[:n] = np.stack(rows)
    return boxes, cls_out, keep, n


# ---------------------------------------------------------------------------
# GT affinity-matrix construction (nuscenes.py:296-349)
# ---------------------------------------------------------------------------

def build_gt_matrix(
    matched: np.ndarray | None,  # (N_all, K_all+2) or None for scene starts
    newborn: np.ndarray,  # (K_all,)
    prev_keep: Sequence[int],
    keep: Sequence[int],
    max_objects: int,
    fp_ratio: float,
    dead_trk_ratio: float,
    rng: np.random.Generator,
):
    """Exact reference semantics, including the train-time subsampling of
    dead-track rows and FP columns.

    Returns (gt (max+2, max+2), n_prev_effective, n_curr_effective).

    NOTE (reference quirk, preserved): the subsampling compacts rows/cols
    of `gt` (nuscenes.py:327, 348) but the det-box arrays are NOT
    re-indexed by the caller, so after compaction gt row i labels prev det
    prev_keep[temp_prev_keep[i]] while the network row i still sees prev
    det prev_keep[i]. The released behavior is replicated bit for bit.
    """
    M = max_objects
    gt = np.zeros((M + 2, M + 2))
    n_prev_eff = 0

    if matched is not None:
        npk, nk = len(prev_keep), len(keep)
        sub = matched[np.asarray(prev_keep, int)][:, np.asarray(keep, int)] if npk and nk else np.zeros((npk, nk))
        gt[:npk, :nk] = sub
        if npk:
            gt[:npk, -2] = matched[np.asarray(prev_keep, int), -2]
            gt[:npk, -1] = 1 - gt[:npk, :].sum(axis=1)

        dead_trk = gt[:npk, -2]
        fn = gt[:npk, -1]
        prev_tp = gt[:npk, :-2].sum(axis=1) + fn
        prev_tp_idx = list(np.nonzero(prev_tp == 1)[0])
        dead_trk_idx = list(np.nonzero(dead_trk == 1)[0])
        rng.shuffle(dead_trk_idx)
        num_keep_dead = int(dead_trk_ratio * prev_tp.sum())
        temp_prev_keep = sorted(dead_trk_idx[:num_keep_dead] + prev_tp_idx)

        n_prev_eff = len(temp_prev_keep)
        gt[: n_prev_eff, :] = gt[temp_prev_keep, :]
        gt[n_prev_eff:-2, :] = 0.0

    nk = len(keep)
    gt[-2, :nk] = newborn[np.asarray(keep, int)] if nk else 0.0
    gt[-1, :nk] = 1 - gt[:, :nk].sum(axis=0) if nk else 0.0

    tp = gt[:-1, :nk].sum(axis=0)
    fp = gt[-1, :nk]
    tp_idx = list(np.nonzero(tp == 1)[0])
    fp_idx = list(np.nonzero(fp == 1)[0])
    rng.shuffle(fp_idx)
    num_keep_fp = int(fp_ratio * tp.sum())
    temp_keep = sorted(fp_idx[:num_keep_fp] + tp_idx)

    n_curr_eff = len(temp_keep)
    gt[:, : n_curr_eff] = gt[:, temp_keep]
    gt[:, n_curr_eff:-2] = 0.0
    return gt, n_prev_eff, n_curr_eff


# ---------------------------------------------------------------------------
# Point-cloud pipeline (det3d/datasets/pipelines/loading.py:117-182 +
# preprocess.py Voxelization, fixed-shape output)
# ---------------------------------------------------------------------------

def read_nusc_points(path: str) -> np.ndarray:
    """nuScenes .pcd.bin -> (N, 5) [x, y, z, intensity, ring->0]."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    out = pts[:, :5].copy()
    out[:, 4] = 0.0  # timestamp channel, filled per-sweep
    return out


def _remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Drop ego-vehicle returns: points with |x| AND |y| below radius
    (loading.py read_sweep -> remove_close, min_distance=1.0)."""
    close = (np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius)
    return points[~close]


def choose_sweeps(info: dict, nsweeps: int, rng: np.random.Generator) -> np.ndarray:
    """The sweeps a frame's cloud takes: nsweeps - 1 of info's, drawn
    without replacement (a frame with no sweep draws nothing)."""
    sweeps = info.get("sweeps", [])
    if not sweeps:
        return np.zeros((0,), np.int64)
    return rng.choice(len(sweeps), min(nsweeps - 1, len(sweeps)), replace=False)


def load_sweep_points(info: dict, nsweeps: int, rng: np.random.Generator) -> np.ndarray:
    """Key frame + (nsweeps-1) randomly chosen transformed sweeps.

    Matches loading.py:117-148: sweep points ego-filtered (remove_close)
    and transformed by the stored 4x4 transform_matrix; per-point time lag
    in the 5th channel.
    """
    points = read_nusc_points(info["lidar_path"])
    clouds = [points]
    sweeps = info.get("sweeps", [])
    if sweeps:
        for i in choose_sweeps(info, nsweeps, rng):
            sw = sweeps[i]
            p = _remove_close(read_nusc_points(sw["lidar_path"]))
            tm = np.asarray(sw["transform_matrix"])
            if tm is not None and tm.shape == (4, 4):
                xyz1 = np.concatenate([p[:, :3], np.ones((len(p), 1), np.float32)], 1)
                p[:, :3] = (xyz1 @ tm.T)[:, :3]
            p[:, 4] = sw.get("time_lag", 0.0)
            clouds.append(p)
    return np.concatenate(clouds, axis=0)


@dataclass
class PointPipelineConfig:
    voxel_size: tuple[float, float, float] = (0.075, 0.075, 0.2)
    pc_range: tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    max_points_in_voxel: int = 10
    max_voxels: int = 120000
    nsweeps: int = 10
    shuffle_points: bool = True
    # train aug (configs/nusc/car.py:105-113)
    global_rot_noise: tuple[float, float] | None = (-0.78539816, 0.78539816)
    global_scale_noise: tuple[float, float] | None = (0.9, 1.1)
    global_translate_std: float | None = 0.5
    # host-side key-sort of the voxel rows (the JAX trunk can then skip its
    # stage-0 argsort; the port's results do not depend on the row order)
    sort_voxels: bool = False
    # Occupancy-tiered capacities: pad each frame to the SMALLEST tier
    # >= its actual voxel count instead of always max_voxels (padded rows
    # are masked, so results do not change). Tiers are clipped to
    # max_voxels; max_voxels is always the last tier.
    voxel_tiers: tuple[int, ...] | None = None


def augment_points(points: np.ndarray, cfg: PointPipelineConfig, rng: np.random.Generator):
    """Global rotation/scale/translate noise (preprocess.py:62-151 via
    det3d/core/sampler/preprocess.py global_* functions). Train mode only."""
    if cfg.global_rot_noise is not None:
        ang = rng.uniform(*cfg.global_rot_noise)
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, -s], [s, c]])
        points[:, :2] = points[:, :2] @ rot.T
    if cfg.global_scale_noise is not None:
        points[:, :3] *= rng.uniform(*cfg.global_scale_noise)
    if cfg.global_translate_std:
        points[:, :3] += rng.normal(0, cfg.global_translate_std, size=3)
    return points


def voxelize_frame(
    points: np.ndarray, cfg: PointPipelineConfig, rng: np.random.Generator,
    train: bool, sort_by_key: bool = False,
):
    """Fixed-shape voxel arrays: (V,P,5), (V,3) zyx, (V,), (V,) valid.

    sort_by_key orders the valid rows by linear (z,y,x) key on the host
    (per-voxel results are order-invariant; the reference keeps arrival
    order, point_cloud_ops.py:130).
    """
    if train:
        points = augment_points(points.copy(), cfg, rng)
    if cfg.shuffle_points and train:
        rng.shuffle(points)
    v, c, n = runtime.points_to_voxel(
        points.astype(np.float32),
        list(cfg.voxel_size),
        list(cfg.pc_range),
        max_points=cfg.max_points_in_voxel,
        max_voxels=cfg.max_voxels,
    )
    if sort_by_key and len(c):
        gy = int(round((cfg.pc_range[4] - cfg.pc_range[1]) / cfg.voxel_size[1]))
        gx = int(round((cfg.pc_range[3] - cfg.pc_range[0]) / cfg.voxel_size[0]))
        key = (c[:, 0].astype(np.int64) * gy + c[:, 1]) * gx + c[:, 2]
        order = np.argsort(key, kind="stable")
        v, c, n = v[order], c[order], n[order]
    V, P = cfg.max_voxels, cfg.max_points_in_voxel
    M = len(c)
    if cfg.voxel_tiers:
        tiers = sorted(set(
            min(int(t), cfg.max_voxels) for t in cfg.voxel_tiers
        ) | {cfg.max_voxels})
        V = next(t for t in tiers if t >= M)
    voxels = np.zeros((V, P, points.shape[1]), np.float32)
    coords = np.zeros((V, 3), np.int32)
    nums = np.zeros((V,), np.int32)
    voxels[:M] = v
    coords[:M] = c
    nums[:M] = n
    valid = np.arange(V) < M
    return voxels, coords, nums, valid


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

@dataclass
class NuScenesTrackDataset:
    """Frame-pair dataset (nuscenes.py:54-411), fixed-shape numpy samples."""

    info_path: str
    det_path: str
    cls_info_path: str
    frame_info_path: str
    labels_path: str | None = None
    det_type: Sequence[str] | None = None
    max_objects: int = 90
    fp_ratio: float = 1.0
    dead_trk_ratio: float = 1.0
    test_mode: bool = False
    pipeline: PointPipelineConfig = field(default_factory=PointPipelineConfig)
    seed: int = 0
    load_points: bool = True

    def __post_init__(self):
        with open(self.info_path, "rb") as f:
            infos = pickle.load(f)
        if isinstance(infos, dict):
            flat = []
            for v in infos.values():
                flat.extend(v)
            infos = flat
        self._infos = infos
        self._token_to_idx = {info["token"]: i for i, info in enumerate(infos)}
        with open(self.frame_info_path) as f:
            self._frame_info = json.load(f)
        self._rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self._infos)

    def _time_diff(self, token: str) -> float:
        fi = self._frame_info[token]
        return 1e-6 * fi["timestamp"] - 1e-6 * fi["prev_timestamp"]

    def __getitem__(self, idx: int) -> dict[str, Any]:
        rng = self._rng
        info = self._infos[idx]
        token = info["token"]
        prev_token = self._frame_info[token]["prev"]
        if prev_token not in self._token_to_idx:
            prev_token = ""

        td = self._time_diff(token)
        out: dict[str, Any] = {"token": token, "prev_token": prev_token}

        if prev_token:
            pb, pcls, prev_keep, n_prev = load_frame_detections(
                self.det_path, self.cls_info_path, prev_token,
                self.det_type, self.max_objects, td, rng,
            )
        else:
            pb = np.zeros((self.max_objects, 11))
            pcls, prev_keep, n_prev = [], list(range(self.max_objects)), 0
        cb, ccls, keep, n_curr = load_frame_detections(
            self.det_path, self.cls_info_path, token,
            self.det_type, self.max_objects, td, rng,
        )
        out.update(
            prev_det_boxes=pb.astype(np.float32),
            det_boxes=cb.astype(np.float32),
            prev_cls_det_boxes=pcls,
            cls_det_boxes=ccls,
            num_prev_det_boxes=n_prev,
            num_det_boxes=n_curr,
        )

        if not self.test_mode:
            labels = np.load(
                os.path.join(self.labels_path, token + ".npz"), allow_pickle=True
            )
            matched = labels["matched"]
            if matched.ndim != 2 or not prev_token:
                matched = None
            gt, n_prev_eff, n_curr_eff = build_gt_matrix(
                matched,
                np.asarray(labels["newborn"]),
                prev_keep,
                keep,
                self.max_objects,
                self.fp_ratio,
                self.dead_trk_ratio,
                rng,
            )
            out["gt"] = gt.astype(np.float32)
            out["num_prev_det_boxes"] = n_prev_eff
            out["num_det_boxes"] = n_curr_eff

        if self.load_points:
            prev_info = (
                self._infos[self._token_to_idx[prev_token]] if prev_token else info
            )
            for prefix, inf in (("", info), ("prev_", prev_info)):
                pts = load_sweep_points(inf, self.pipeline.nsweeps, rng)
                v, c, n, m = voxelize_frame(
                    pts, self.pipeline, rng, train=not self.test_mode,
                    sort_by_key=self.pipeline.sort_voxels,
                )
                out[prefix + "voxels"] = v
                out[prefix + "coordinates"] = c
                out[prefix + "num_points"] = n
                out[prefix + "voxels_valid"] = m
        return out

    def metadata(self) -> list[dict]:
        """Every index's sample without its points, as a read of indices 0,
        1, ... in order makes it, each with the generator state its index
        starts from ("rng_state"): `read_at(i, that state)` then gives index
        i's sample bit for bit as the in-order read does, in any order of
        indices, and a split never has to be held in memory whole. The
        point pipeline's draws are replayed without reading a cloud: in
        test mode they are the sweep choices alone, which depend only on the
        sweep counts. Leaves the generator where the in-order read would."""
        if not self.test_mode:
            raise ValueError("metadata replays the point pipeline of test mode only "
                             "(training's augmentation draws depend on the clouds)")
        load, self.load_points = self.load_points, False
        out = []
        try:
            for i in range(len(self)):
                state = self._rng.bit_generator.state
                sample = self[i]
                if load:  # the frame's and its prev frame's sweep choices
                    prev = sample["prev_token"]
                    info = self._infos[i]
                    for inf in (info, self._infos[self._token_to_idx[prev]] if prev else info):
                        choose_sweeps(inf, self.pipeline.nsweeps, self._rng)
                sample["rng_state"] = state
                out.append(sample)
        finally:
            self.load_points = load
        return out

    def read_at(self, idx: int, rng_state: dict) -> dict[str, Any]:
        """Index idx's sample read from the generator state `rng_state` (one
        of `metadata`'s)."""
        self._rng.bit_generator.state = rng_state
        return self[idx]


ARRAY_KEYS = (
    "det_boxes", "prev_det_boxes", "gt",
    "voxels", "coordinates", "num_points", "voxels_valid",
    "prev_voxels", "prev_coordinates", "prev_num_points", "prev_voxels_valid",
    "feat", "prev_feat",
)


@dataclass
class CachedFeatureDataset:
    """Frame-pair dataset over precomputed BEV descriptors (nuscenes.py:
    412-440 of the JAX package). With the reference's frozen trunk
    (train.py:184-191) a frame's descriptors never change during affinity
    training, so tools/cache_features.py stores them once ({token}.npz, key
    'feat', (max_obj, num_point*C) f32, in either package) and this wrapper
    serves (boxes, gt, feat, prev_feat) samples: the train step then runs
    the affinity head alone (make_train_step(cached=True))."""

    base: NuScenesTrackDataset  # built with load_points=False
    features_path: str

    def __len__(self):
        return len(self.base)

    def _feat(self, token: str) -> np.ndarray:
        with np.load(os.path.join(self.features_path, token + ".npz")) as d:
            return d["feat"].astype(np.float32)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        s = self.base[idx]
        s["feat"] = self._feat(s["token"])
        s["prev_feat"] = (self._feat(s["prev_token"]) if s["prev_token"]
                          else np.zeros_like(s["feat"]))
        return s


def collate(samples: list[dict[str, Any]]) -> dict[str, Any]:
    """Stack fixed-shape samples into a batch; keep metadata as lists.

    Replaces collate_kitti (det3d/torchie/parallel/collate.py:91-175) — the
    per-sample leading-axis layout makes batching a plain stack.
    """
    out: dict[str, Any] = {}
    for k in samples[0]:
        if k in ARRAY_KEYS:
            arrs = [s[k] for s in samples]
            shapes = {a.shape for a in arrs}
            if len(shapes) > 1:
                # occupancy-tiered frames: re-pad every sample to the
                # batch max along the leading (voxel) axis
                V = max(a.shape[0] for a in arrs)
                padded = []
                for a in arrs:
                    if a.shape[0] < V:
                        pad = np.zeros((V - a.shape[0],) + a.shape[1:], a.dtype)
                        a = np.concatenate([a, pad])
                    padded.append(a)
                arrs = padded
            out[k] = np.stack(arrs)
        else:
            out[k] = [s[k] for s in samples]
    return out
