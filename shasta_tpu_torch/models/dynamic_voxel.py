"""Dynamic voxel encoder, a per-voxel mean over an uncapped point count:
the port of shasta_tpu/models/dynamic_voxel.py.

Behavioral reference: det3d/models/readers/dynamic_voxel_encoder.py
(voxelization :8-17, voxelization_virtual :19-70). Voxels are compacted
into a static `max_voxels` capacity with a validity mask, in ascending
linear key order (z-major zyx raster, the reference's torch.unique
order); overflow past `max_voxels` is dropped. The range test is
inclusive at both ends; a point that floors to coord == grid size is
dropped, as the JAX module drops it. Keys are int32 with the int32 max
as the sentinel of a dropped point, as there.

Nothing on the path waits for the card: the range and voxel size go to
the device once per device (`_on`), and every shape is fixed by the rows
and `max_voxels`. With `demand=True` `dynamic_voxelize_virtual` also
returns the number of distinct voxels its points fall in, before the
capacity cuts (0-d, on the rows' device).
"""
from __future__ import annotations

import functools

import torch

__all__ = ["dynamic_voxelize", "dynamic_voxelize_virtual"]

_BIG = torch.iinfo(torch.int32).max


@functools.lru_cache(maxsize=None)
def _on(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host numbers as a tensor on `device`, copied there once: later calls
    take it with no copy from the host, which would wait for the card."""
    return torch.tensor(values, dtype=dtype, device=device)


def _keys_and_mask(points, valid, pc_range, voxel_size):
    """Linear z-major voxel key per point + in-range mask + grid size."""
    cr = _on(tuple(map(float, pc_range)), points.dtype, points.device)
    vs = _on(tuple(map(float, voxel_size)), points.dtype, points.device)
    gs = torch.round((cr[3:] - cr[:3]) / vs).to(torch.int32)  # xyz
    keep = valid & ((points[:, :3] >= cr[:3]) & (points[:, :3] <= cr[3:])).all(1)
    c = torch.floor((points[:, :3] - cr[:3]) / vs).to(torch.int32)
    keep = keep & (c < gs[None, :]).all(1) & (c >= 0).all(1)
    key = (c[:, 2] * gs[1] + c[:, 1]) * gs[0] + c[:, 0]
    return torch.where(keep, key, _BIG), gs


def segments(key, max_voxels: int):
    """The points' slots: the unique keys (_BIG: a dropped point) compacted
    into [0, max_voxels) in ascending order (a stable sort). Returns (sk,
    order): the sorted keys and the sort's permutation; head (N,): the
    first point of each distinct key in sorted order; vi (N,): each sorted
    point's slot, max_voxels past the capacity or dropped; in_cap = vi <
    max_voxels."""
    sk, order = torch.sort(key, stable=True)
    prev = torch.cat([sk.new_full((1,), -1), sk[:-1]])
    head = (sk != prev) & (sk != _BIG)
    vox_id = torch.cumsum(head.to(torch.int64), 0) - 1
    in_cap = (sk != _BIG) & (vox_id < max_voxels)
    vi = torch.where(in_cap, vox_id, max_voxels)  # row max_voxels is dropped
    return sk, order, head, vi, in_cap


def _segment_mean(feats, key, max_voxels: int):
    """Compact the unique keys into [0, max_voxels) slots and mean `feats`.
    Returns (mean (max_voxels, C), slot_key (max_voxels,), valid, head
    (N,): the first point of each distinct key in sorted order). Slot
    order is ascending key (a stable sort); overflow past max_voxels is
    dropped (valid.sum() == max_voxels shows it)."""
    sk, order, head, vi, in_cap = segments(key, max_voxels)

    C = feats.shape[1]
    acc = feats.new_zeros((max_voxels + 1, C)).index_add_(
        0, vi, torch.where(in_cap[:, None], feats[order], 0.0))[:max_voxels]
    cnt = torch.zeros(max_voxels + 1, dtype=torch.int32, device=feats.device).index_add_(
        0, vi, in_cap.to(torch.int32))[:max_voxels]
    slot_key = torch.full((max_voxels + 1,), _BIG, dtype=torch.int32, device=feats.device)
    slot_key[torch.where(head & in_cap, vi, max_voxels)] = sk.to(torch.int32)
    valid = cnt > 0
    mean = acc / cnt.clamp_min(1)[:, None].to(feats.dtype)
    return mean, slot_key[:max_voxels], valid, head


def _decode_coords(slot_key, valid, gs):
    k = torch.where(valid, slot_key, 0)
    x = k % gs[0]
    rem = k // gs[0]
    y = rem % gs[1]
    z = rem // gs[1]
    zyx = torch.stack([z, y, x], dim=1).to(torch.int32)
    return torch.where(valid[:, None], zyx, 0)


def dynamic_voxelize(points, valid, pc_range, voxel_size, max_voxels: int):
    """The fixed-shape `voxelization` (:8-17). points: (N, C) padded rows;
    valid: (N,) mask. Returns (voxels (max_voxels, C) per-voxel point
    means, coords zyx (max_voxels, 3) int32, valid (max_voxels,))."""
    key, gs = _keys_and_mask(points, valid, pc_range, voxel_size)
    mean, slot_key, vvalid, _ = _segment_mean(points, key, max_voxels)
    return mean, _decode_coords(slot_key, vvalid, gs), vvalid


def dynamic_voxelize_virtual(points, valid, pc_range, voxel_size, max_voxels: int,
                             demand: bool = False):
    """The fixed-shape `voxelization_virtual` (:19-70).

    Rows carry a type indicator at channel -2 (1 real / 0 painted / -1
    virtual, the MVP convention) and a timestamp at -1. Each point is
    repacked to 22 channels (real points in [0:5) with indicator 1 at
    channel 21; painted and virtual points in [5:20) with their painted
    flag at 20), segment-meaned, and the mixed voxels renormalised so the
    real block averages over real points only and the painted/virtual
    block over the rest (reference :63-69). The per-voxel mean is
    permutation-invariant, so the masked repack equals the reference's
    reordering of points."""
    ptype = points[:, -2]
    real = ptype == 1
    painted = ptype == 0
    pv = painted | (ptype == -1)

    zero = points.new_zeros(())
    real_feats = torch.cat([points[:, :4], points[:, -1:]], dim=1)
    padded = torch.cat([
        torch.where(real[:, None], real_feats, zero),  # 0:5
        torch.where(pv[:, None], points[:, :14], zero),  # 5:19
        torch.where(pv, points[:, -1], zero)[:, None],  # 19: timestamp
        painted.to(points.dtype)[:, None],  # 20
        real.to(points.dtype)[:, None],  # 21
    ], dim=1)

    key, gs = _keys_and_mask(points, valid, pc_range, voxel_size)
    mean, slot_key, vvalid, head = _segment_mean(padded, key, max_voxels)

    indicator = mean[:, 21]  # real-point fraction per voxel
    mix = (indicator > 0) & (indicator < 1)
    vox = mean[:, :21]
    one = mean.new_ones(())
    denom_r = torch.where(mix, indicator, one)[:, None]
    denom_v = torch.where(mix, 1.0 - indicator, one)[:, None]
    vox = torch.cat([vox[:, :5] / denom_r, vox[:, 5:] / denom_v], dim=1)
    out = (vox, _decode_coords(slot_key, vvalid, gs), vvalid)
    return out + (head.sum(),) if demand else out
