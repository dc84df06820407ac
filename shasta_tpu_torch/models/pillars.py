"""PointPillars-style readers: the port of shasta_tpu/models/pillars.py
(CenterPoint-heritage model-zoo components, off the ShaSTA main path).

Behavioral reference: det3d/models/readers/pillar_encoder.py:59
(PillarFeatureNet: per-pillar point features augmented with cluster-mean
and pillar-center offsets -> Linear+BN+ReLU -> max pool) and :166
(PointPillarsScatter: per-pillar features scattered into a dense BEV
canvas). Fixed-shape and masked, as the JAX module is.

Layer names follow the JAX tree: pfn_{i} (Linear, no bias) and bn_{i}
(flax BatchNorm(momentum=0.99, epsilon=1e-3), torch momentum 0.01, eps
1e-3). In train mode the BNs take flax's batch statistics and update
(rpn.batch_norm) over all V*P rows, the masked (zeroed) points included,
as flax's do.

Two readings of `num_filters`:
- the JAX module's (default): every layer at its listed width, and the
  padded point slots masked out of each max (-inf);
- det3d's PFNLayer (`det3d=True`, CenterPoint-PP's reader): every layer
  but the last at half its listed width ([64, 64] is Linear 10 -> 32,
  concatenated with its max to 64, then Linear 64 -> 64), and the padded
  slots zeroed before the first layer and then passed through every
  layer like the points, into each max. A det3d checkpoint's
  reader.pfn_layers.{i}.linear / .norm load into pfn_{i} / bn_{i}
  (train/checkpoint.py).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .rpn import batch_norm


class PillarFeatureNet(nn.Module):
    def __init__(self, num_filters: Sequence[int] = (64,), num_input_features: int = 5,
                 voxel_size: Sequence[float] = (0.2, 0.2),
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 device=None, generator: torch.Generator | None = None,
                 det3d: bool = False, dtype=None):
        """`generator` seeds the Linear weights (flax's Dense default,
        lecun normal: N(0, 1/fan_in) truncated at 2 sigma); BN starts at
        scale 1, bias 0, mean 0, var 1. pc_range: only its x and y minimum
        (the first two entries) are read. det3d: det3d's reading of
        num_filters (the module's docstring). dtype torch.bfloat16: the
        linears take bf16 inputs and weights, the BNs run in f32."""
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.det3d, self.dtype = det3d, dtype
        c_in = num_input_features + 5  # + cluster offset (3) + center offset (2)
        for i, f in enumerate(self.num_filters):
            if det3d and i + 1 < len(self.num_filters):
                f //= 2
            lin = nn.Linear(c_in, f, bias=False)
            std = c_in ** -0.5 / 0.87962566103423978  # truncated normal's std correction
            nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            self.add_module(f"pfn_{i}", lin)
            self.add_module(f"bn_{i}", nn.BatchNorm2d(f, eps=1e-3, momentum=0.01))
            c_in = 2 * f
        self.device = resolve_device(device)
        self.to(self.device)

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """voxels (V, P, C); num_points (V,); coords (V, 3) zyx.
        Returns (V, num_filters[-1])."""
        V, P, _ = voxels.shape
        dt = voxels.dtype
        mask = (torch.arange(P, device=voxels.device)[None, :] < num_points[:, None])[..., None]

        # cluster-mean offset (pillar_encoder.py:100-104)
        denom = num_points.clamp_min(1).to(dt)[:, None, None]
        mean = (voxels[:, :, :3] * mask).sum(1, keepdim=True) / denom
        f_cluster = voxels[:, :, :3] - mean

        # pillar-center offset (pillar_encoder.py:106-110); coords are zyx
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x0, y0 = self.pc_range[0], self.pc_range[1]
        cx = (coords[:, 2].to(dt) * vx + (vx / 2 + x0))[:, None]
        cy = (coords[:, 1].to(dt) * vy + (vy / 2 + y0))[:, None]
        f_center = torch.stack([voxels[:, :, 0] - cx, voxels[:, :, 1] - cy], dim=-1)

        x = torch.cat([voxels, f_cluster, f_center], dim=-1)
        x = torch.where(mask, x, 0.0)
        for i in range(len(self.num_filters)):
            w = getattr(self, f"pfn_{i}").weight
            x = (F.linear(x, w) if self.dtype is None
                 else F.linear(x.to(self.dtype), w.to(self.dtype)).float())
            x = batch_norm(getattr(self, f"bn_{i}"), x.reshape(V * P, -1, 1, 1)).reshape(V, P, -1)
            x = torch.relu(x)
            if not self.det3d:
                x = torch.where(mask, x, -torch.inf)
            pooled = x.max(dim=1).values  # (V, f)
            if i + 1 < len(self.num_filters):
                x = torch.cat([x, pooled[:, None, :].expand_as(x)], dim=-1)
        return pooled if self.det3d else torch.where(torch.isfinite(pooled), pooled, 0.0)


def point_pillars_scatter(pillar_feats: torch.Tensor, coords: torch.Tensor,
                          valid: torch.Tensor, batch_size: int, ny: int,
                          nx: int) -> torch.Tensor:
    """Scatter pillars (V, C) into a dense (B, ny, nx, C) canvas
    (pillar_encoder.py:166-210). coords (V, 4) [b, z, y, x] (z unused).
    As the JAX scatter (mode="drop"), an invalid row goes to batch
    `batch_size` and is dropped, a negative index counts from the end and
    a row with an index out of range is dropped. Where two rows share a
    cell, one of them is written (the JAX scatter does not say which)."""
    C = pillar_feats.shape[1]
    canvas = pillar_feats.new_zeros((batch_size + 1, ny, nx, C))
    b = torch.where(valid, coords[:, 0].long(), batch_size)
    idx, keep = [], torch.ones_like(valid)
    for i, n in ((b, batch_size), (coords[:, 2].long(), ny), (coords[:, 3].long(), nx)):
        i = torch.where(i < 0, i + n, i)
        keep = keep & (i >= 0) & (i < n)
        idx.append(torch.where(keep, i, 0))
    b, y, x = idx
    canvas[torch.where(keep, b, batch_size), y, x] = pillar_feats
    return canvas[:batch_size]
