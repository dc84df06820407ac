"""The plain reference of CenterPoint-MVP's trunk under ShaSTA's head, in
float32 PyTorch with TF32 off, written from the description of det3d's
DynamicVoxelEncoder(virtual=True) in MVP (Yin, Zhou, Krähenbühl, NeurIPS
2021; tianweiy/MVP det3d/models/readers/dynamic_voxel_encoder.py,
`voxelization_virtual`):

- the rows (16 channels: x, y, z, 11 painted channels, the type at 14 (1
  real, 0 painted, -1 virtual), the time at 15) each in the voxel their
  x, y, z fall in (the floor of the offset from the range's corner over
  the voxel size); the points in the range, bounds included;
- each point repacked to 22 channels: a real point's x, y, z, intensity
  and time in 0:5 and a 1 at 21; a painted or virtual point's first 14
  channels in 5:19, its time at 19 and, painted only, a 1 at 20;
- the voxels: `torch.unique` of the points' keys with `return_inverse`,
  each voxel's mean of its points' 22 channels (`index_add` of the rows
  and of the counts); in a voxel holding both kinds (0 < mean[21] < 1)
  channels 0:5 are divided by mean[21] and 5:22 by 1 - mean[21], so each
  block averages over its own points; the 21 features are channels 0:21;
- then model.py's sparse trunk at trunk_spec(nin=21) on those features
  (each voxel a "voxel" of one point: its mean is itself), the neck, the
  shared conv, box points and sampling as pipelines.Trunk has them.

Departures from MVP: a point whose cell floors to the grid's size (the
range's upper bound) is dropped, where det3d keeps an off-grid voxel for
it. There is no voxel capacity: the reference keeps every voxel, and
`counts` records how many each frame makes, for the comparison with the
program's capacity.
"""
from __future__ import annotations

import numpy as np
import torch

from . import model as rm
from .pipelines import Trunk as _SparseTrunk

TYPE, TIME = 14, 15


def geometry(m: dict) -> tuple[list, list]:
    """det3d's pc_range [x0, y0, z0, x1, y1, z1] and voxel_size [x, y, z] of
    a configuration's model: x and y from the BEV grid's corner, cells and
    voxel size; z its z_range over the grid's nz - 1 cells (the sparse
    shape's nz holds one pad row, SpMiddleResNetFHD's grid_size + [1, 0, 0])."""
    (x0, y0), (vx, vy), (nz, ny, nx) = m["pc_start"], m["voxel_size"], m["grid_shape"]
    z0, z1 = m["z_range"]
    return [x0, y0, z0, x0 + nx * vx, y0 + ny * vy, z1], [vx, vy, (z1 - z0) / (nz - 1)]


def voxelize_virtual(rows: torch.Tensor, pc_range, voxel_size
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """MVP's voxelization of one cloud's rows (N, 16) -> (the voxels' 21
    features (M, 21), their coordinates (M, 3) int64 [z, y, x]) in
    ascending (z, y, x) order."""
    dev = rows.device
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    hi = torch.tensor(pc_range[3:], dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    grid = torch.round((hi - lo) / vs).long()  # x, y, z
    xyz = rows[:, :3]
    cell = torch.floor((xyz - lo) / vs).long()
    inside = (((xyz >= lo) & (xyz <= hi)).all(1)
              & ((cell >= 0) & (cell < grid)).all(1))
    rows, cell = rows[inside], cell[inside]
    key = (cell[:, 2] * grid[1] + cell[:, 1]) * grid[0] + cell[:, 0]
    voxels, inverse = torch.unique(key, return_inverse=True)

    kind = rows[:, TYPE]
    real, painted = kind == 1, kind == 0
    other = painted | (kind == -1)
    packed = rows.new_zeros((len(rows), 22))
    packed[real, :4] = rows[real, :4]
    packed[real, 4] = rows[real, TIME]
    packed[real, 21] = 1.0
    packed[other, 5:19] = rows[other, :14]
    packed[other, 19] = rows[other, TIME]
    packed[painted, 20] = 1.0

    M = len(voxels)
    sums = rows.new_zeros((M, 22)).index_add_(0, inverse, packed)
    counts = rows.new_zeros(M).index_add_(0, inverse, torch.ones_like(kind))
    mean = sums / counts[:, None]
    share = mean[:, 21]
    mixed = (share > 0) & (share < 1)
    mean[mixed, :5] = mean[mixed, :5] / share[mixed, None]
    mean[mixed, 5:] = mean[mixed, 5:] / (1 - share[mixed])[:, None]
    X, Y = grid[0], grid[1]
    zyx = torch.stack([voxels // (X * Y), (voxels // X) % Y, voxels % X], 1)
    return mean[:, :21], zyx


class Trunk(_SparseTrunk):
    """The MVP trunk's weights and geometry, as pipelines.Trunk for the
    sparse one: `bev(frame)` -> (H, W, 64) from the frame's rows `cloud`
    and mask `cloud_valid`, `features(bev, boxes)`, `sets` (per frame the
    size of each stage's active set) and `counts` (per frame its voxels)."""

    def __init__(self, sd: dict, model_cfg: dict, device):
        super().__init__(sd, model_cfg, device)
        self.counts: list = []

    def voxels(self, frame: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The frame's voxels: (features (M, 21), coordinates (M, 3) zyx)."""
        m, d = self.cfg, self.dev
        valid = torch.as_tensor(np.asarray(frame["cloud_valid"]), device=d).bool()
        rows = torch.as_tensor(np.asarray(frame["cloud"]), device=d)[valid]
        return voxelize_virtual(rows, *geometry(m))

    def bev(self, frame: dict) -> torch.Tensor:
        feats, zyx = self.voxels(frame)
        M = len(feats)
        self.counts.append(M)
        dense, sizes = rm.sparse_trunk(
            self.sd, feats[:, None], torch.ones(M, device=self.dev), zyx,
            torch.ones(M, dtype=torch.bool, device=self.dev), self.cfg["grid_shape"],
            self.cfg["num_input_features"])
        self.sets.append(sizes)
        return rm.neck(self.sd, dense)[0]
