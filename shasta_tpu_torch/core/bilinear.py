"""Bilinear BEV sampling: the port of shasta_tpu/core/bilinear.py:15-81.

Indices clamp to the border; the weights use the unclamped neighbours,
as the reference does (center_utils.py:106-119).
"""
from __future__ import annotations

import torch


def bilinear_interpolate(im: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """im (H, W, C) sampled at float x, y (each (...,)) -> (..., C)."""
    H, W = im.shape[0], im.shape[1]
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1 = x0 + 1
    y1 = y0 + 1
    x0c = x0.clamp(0, W - 1).long()
    x1c = x1.clamp(0, W - 1).long()
    y0c = y0.clamp(0, H - 1).long()
    y1c = y1.clamp(0, H - 1).long()
    Ia = im[y0c, x0c]
    Ib = im[y1c, x0c]
    Ic = im[y0c, x1c]
    Id = im[y1c, x1c]
    wa = (x1 - x) * (y1 - y)
    wb = (x1 - x) * (y - y0)
    wc = (x - x0) * (y1 - y)
    wd = (x - x0) * (y - y0)
    return (Ia * wa[..., None] + Ib * wb[..., None] + Ic * wc[..., None]
            + Id * wd[..., None])


def absl_to_relative(xy: torch.Tensor, pc_start, voxel_size, out_stride: int):
    """World xy -> fractional BEV pixel coords (bird_eye_view.py:18-22)."""
    a1 = (xy[..., 0] - pc_start[0]) / voxel_size[0] / out_stride
    a2 = (xy[..., 1] - pc_start[1]) / voxel_size[1] / out_stride
    return a1, a2


def sample_bev_features(bev: torch.Tensor, points: torch.Tensor, pc_start,
                        voxel_size, out_stride: int) -> torch.Tensor:
    """bev (B, H, W, C) channels-last, points (B, N, P, 3) world frame ->
    (B, N, P*C), per-point features concatenated in point order."""
    xs, ys = absl_to_relative(points[..., :2], pc_start, voxel_size, out_stride)
    out = [bilinear_interpolate(bev[b], xs[b], ys[b]) for b in range(bev.shape[0])]
    out = torch.stack(out)  # (B, N, P, C)
    return out.reshape(out.shape[0], out.shape[1], -1)
