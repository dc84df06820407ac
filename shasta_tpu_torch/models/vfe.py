"""Voxel-mean VFE: the port of shasta_tpu/models/vfe.py."""
from __future__ import annotations

import torch


def voxel_mean_vfe(features: torch.Tensor, num_points: torch.Tensor,
                   num_input_features: int = 5) -> torch.Tensor:
    """features (V, P, C) padded points, num_points (V,) -> (V, C') means;
    padded voxels (num_points == 0) give zeros."""
    s = features[:, :, :num_input_features].sum(dim=1)
    denom = num_points.clamp(min=1).to(s.dtype)[:, None]
    return s / denom
