"""Ground-plane removal for Waymo point clouds; the port of
shasta_tpu/preprocessing/waymo_ground.py (numpy float64 on the host: the
side a split puts on the ground follows the sign of the SVD's normal, which
another SVD, torch's or cuSOLVER's, may flip).

Behavioral reference: preprocessing/waymo_data/testset/ground_removal.py
(:28-58 get_ground, :61-83 per-segment npz driver). The algorithm is the
GPF (ground plane fitting) loop: seed from the lowest points, then
iterate {PCA plane fit -> split by signed distance}.

Same constants and comparison semantics as the reference (strict < / >
splits: points exactly on the threshold plane fall out of both sets for
that iteration and out of the final result).
"""
from __future__ import annotations

import os

import numpy as np

TH_SEEDS = 1.2
NUM_LPR = 20
N_ITER = 10
TH_DIST = 0.3


def get_ground(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a point cloud into (ground, non_ground) (:34-58).

    pts: (N, >=3) with xyz in the leading columns. Extra feature columns
    ride along with the split.
    """
    pts = np.asarray(pts)
    order = pts[:, 2].argsort()
    pts_sort = pts[order]
    lpr = np.mean(pts_sort[:NUM_LPR, 2])
    pts_g = pts_sort[pts_sort[:, 2] < lpr + TH_SEEDS]
    pts_n_g = np.zeros((0, pts.shape[1]), pts.dtype)
    for _ in range(N_ITER):
        mean = np.mean(pts_g[:, :3], axis=0)
        d = pts_g[:, :3] - mean
        cov = d.T @ d / len(pts_g)
        U, _, _ = np.linalg.svd(cov)
        normal = U[:, 2]
        th_dist_d = TH_DIST + normal.dot(mean)
        result = pts[:, :3] @ normal
        pts_n_g = pts[result > th_dist_d]
        pts_g = pts[result < th_dist_d]
    return pts_g, pts_n_g


def remove_ground_tree(raw_pc_dir: str, clean_pc_dir: str,
                       ground_pc_dir: str) -> list[str]:
    """Per-segment npz driver (:61-83): raw_pc/{seg}.npz holding
    {str(frame): (N, C) pc} -> clean_pc/ + ground_pc/ npz trees."""
    os.makedirs(clean_pc_dir, exist_ok=True)
    os.makedirs(ground_pc_dir, exist_ok=True)
    written = []
    for fn in sorted(os.listdir(raw_pc_dir)):
        if not fn.endswith(".npz"):
            continue
        raw = np.load(os.path.join(raw_pc_dir, fn), allow_pickle=True)
        clean, ground = {}, {}
        for key in raw.files:
            g, c = get_ground(raw[key])
            clean[key] = c
            ground[key] = g
        np.savez_compressed(os.path.join(clean_pc_dir, fn), **clean)
        np.savez_compressed(os.path.join(ground_pc_dir, fn), **ground)
        written.append(fn)
    return written
