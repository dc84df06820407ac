"""Synthetic fixed-shape batches: a copy of shasta_tpu.data.synthetic.make_batch.

Same seed, same arrays: the parity tests feed one batch to both packages.
`cfg` needs max_obj, grid_shape and num_input_features.
"""
from __future__ import annotations

import numpy as np


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
