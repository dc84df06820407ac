"""Box geometry: the port of shasta_tpu/core/boxes.py:23-72.

Box row convention (11 features): [x, y, z, w, l, h, yaw, vx, vy, dt, score].
"""
from __future__ import annotations

import torch

from ..device import const

# clockwise unit-square corners minus the 0.5 origin (box_torch_ops.corners_nd)
_CORNERS_NORM_2D = ((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5))


def rotation_2d(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """points (..., P, 2), angles (...,): x*cos + y*sin, -x*sin + y*cos."""
    c = torch.cos(angles)[..., None]
    s = torch.sin(angles)[..., None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([x * c + y * s, -x * s + y * c], dim=-1)


def center_to_corner_box2d(centers: torch.Tensor, dims: torch.Tensor,
                           angles: torch.Tensor) -> torch.Tensor:
    """centers, dims (..., N, 2), angles (..., N) -> (..., N, 4, 2)."""
    norm = const(_CORNERS_NORM_2D, dims.device, dims.dtype)
    corners = dims[..., None, :] * norm
    corners = rotation_2d(corners, angles)
    return corners + centers[..., None, :]


def box_points_5(boxes7: torch.Tensor) -> torch.Tensor:
    """(..., N, 7) -> (..., N, 5, 3): center, front, back, left, right."""
    center2d = boxes7[..., :2]
    height = boxes7[..., 2:3]
    dim2d = boxes7[..., 3:5]
    yaw = boxes7[..., 6]
    c = center_to_corner_box2d(center2d, dim2d, yaw)
    front = (c[..., 0, :] + c[..., 1, :]) / 2
    back = (c[..., 2, :] + c[..., 3, :]) / 2
    left = (c[..., 0, :] + c[..., 3, :]) / 2
    right = (c[..., 1, :] + c[..., 2, :]) / 2
    mids = torch.stack([front, back, left, right], dim=-2)
    mids3d = torch.cat(
        [mids, height[..., None, :].expand(mids.shape[:-1] + (1,))], dim=-1)
    center3d = boxes7[..., None, :3]
    return torch.cat([center3d, mids3d], dim=-2)
