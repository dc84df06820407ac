"""Point-cloud voxelization: the port of shasta_tpu/ops/voxelize.py.

Behavioral reference: det3d/ops/point_cloud/point_cloud_ops.py:7-186
(_points_to_voxel_reverse_kernel / points_to_voxel):
- floor((p - range_min) / voxel_size) per axis, out-of-range points dropped
- coords stored reversed as [z, y, x]
- voxels appear in order of first point arrival, capped at max_voxels
  (points of voxels past the cap are dropped)
- at most max_points points kept per voxel, in arrival order

Two implementations:
- `points_to_voxel_np`: the host version (numpy), a copy of the JAX
  package's, with byte-identical outputs.
- `points_to_voxel`: fixed-shape on tensors (the counterpart of
  points_to_voxel_jax). The same voxel set and per-voxel point selection,
  but voxels in grid-key order rather than arrival (a stable sort), and
  the voxel cap keeps the smallest keys.
"""
from __future__ import annotations

import numpy as np
import torch


def grid_size(voxel_size, coors_range) -> np.ndarray:
    vs = np.asarray(voxel_size, np.float64)
    cr = np.asarray(coors_range, np.float64)
    return np.round((cr[3:] - cr[:3]) / vs).astype(np.int32)  # xyz


def points_to_voxel_np(points: np.ndarray, voxel_size, coors_range, max_points: int = 35,
                       max_voxels: int = 20000):
    """Returns (voxels (M,P,C), coords zyx (M,3) int32, num_points (M,))."""
    vs = np.asarray(voxel_size, points.dtype)
    cr = np.asarray(coors_range, points.dtype)
    gs = grid_size(voxel_size, coors_range)  # xyz

    c = np.floor((points[:, :3] - cr[:3]) / vs).astype(np.int64)
    valid = np.all((c >= 0) & (c < gs[None, :]), axis=1)
    idx = np.nonzero(valid)[0]
    c = c[idx]
    # zyx linear key
    key = (c[:, 2] * gs[1] + c[:, 1]) * gs[0] + c[:, 0]

    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")  # voxels in arrival order
    rank_of_sorted = np.empty_like(order)
    rank_of_sorted[order] = np.arange(len(order))
    vrank = rank_of_sorted[inv]  # arrival-rank of each point's voxel

    keep_voxel = vrank < max_voxels
    # position of each point within its voxel (arrival order)
    pos = np.zeros(len(idx), np.int64)
    sort_by_voxel = np.argsort(vrank, kind="stable")
    sv = vrank[sort_by_voxel]
    boundary = np.concatenate([[True], sv[1:] != sv[:-1]])
    grp_start = np.maximum.accumulate(np.where(boundary, np.arange(len(sv)), 0))
    pos[sort_by_voxel] = np.arange(len(sv)) - grp_start

    keep = keep_voxel & (pos < max_points)
    M = int(min(len(uniq), max_voxels))
    voxels = np.zeros((M, max_points, points.shape[1]), points.dtype)
    num_points = np.zeros((M,), np.int32)
    coords = np.zeros((M, 3), np.int32)

    kp = np.nonzero(keep)[0]
    voxels[vrank[kp], pos[kp]] = points[idx[kp]]
    np.add.at(num_points, vrank[kp], 1)
    first_kept = first[order[:M]]
    cz = c[first_kept]
    coords[:, 0] = cz[:, 2]
    coords[:, 1] = cz[:, 1]
    coords[:, 2] = cz[:, 0]
    return voxels, coords, num_points


def points_to_voxel(points: torch.Tensor, voxel_size, coors_range, max_points: int = 10,
                    max_voxels: int = 120000):
    """Fixed-shape voxelizer on the points' device. points (N, C); a row
    outside the range is dropped.

    Returns (voxels (max_voxels, max_points, C), coords zyx (max_voxels, 3)
    int32, num_points (max_voxels,) int32, valid (max_voxels,) bool). Voxels
    are in grid-key order (stable sort), not arrival; per-voxel points keep
    input order."""
    dev = points.device
    vs = torch.as_tensor(voxel_size, dtype=points.dtype, device=dev)
    cr = torch.as_tensor(coors_range, dtype=points.dtype, device=dev)
    gs = torch.round((cr[3:] - cr[:3]) / vs).to(torch.int32)  # xyz

    N, C = points.shape
    c = torch.floor((points[:, :3] - cr[:3]) / vs).to(torch.int32)
    valid = ((c >= 0) & (c < gs)).all(1)
    key = ((c[:, 2] * gs[1] + c[:, 1]) * gs[0] + c[:, 0]).long()
    BIG = torch.iinfo(torch.int32).max
    key = torch.where(valid, key, BIG)

    sk, order = torch.sort(key, stable=True)  # groups points by voxel, stable
    head = (sk != torch.cat([sk.new_full((1,), -1), sk[:-1]])) & (sk != BIG)
    vox_id = torch.cumsum(head, 0) - 1  # voxel index per sorted point
    ar = torch.arange(N, device=dev)
    grp_start = torch.cummax(torch.where(head, ar, 0), 0).values
    pos = ar - grp_start

    keep = (sk != BIG) & (vox_id < max_voxels) & (pos < max_points)
    # dropped points land in a spare voxel row that is cut off
    vi = torch.where(keep, vox_id, max_voxels)
    pi = torch.where(keep, pos, 0)
    voxels = points.new_zeros((max_voxels + 1, max_points, C))
    voxels[vi, pi] = points[order]
    num_points = torch.zeros((max_voxels + 1,), dtype=torch.int32, device=dev)
    num_points.index_add_(0, vi, keep.to(torch.int32))

    head_keep = head & (vox_id < max_voxels)
    coords = torch.zeros((max_voxels + 1, 3), dtype=torch.int32, device=dev)
    coords[torch.where(head_keep, vox_id, max_voxels)] = c[order].flip(1)  # zyx
    vvalid = torch.arange(max_voxels, device=dev) < head_keep.sum()
    return voxels[:max_voxels], coords[:max_voxels], num_points[:max_voxels], vvalid
