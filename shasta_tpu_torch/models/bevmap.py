"""Standalone BEV feature model (reader + backbone + neck): the port of
shasta_tpu/models/bevmap.py.

Behavioral reference: det3d/models/bev/bevmap.py:8-57 (BEVMap). Its
pretrained checkpoint, bev_map.pth (the frozen CenterPoint trunk), is
what Shasta loads non-strictly. The module's state_dict holds backbone.*
and neck.* only (train/checkpoint.TRUNK_PARTS), so a bev_map.pth, det3d's
or one that save_checkpoint wrote, loads strictly through
load_checkpoint. The JAX module's `train` flag is `.train()` here; the
module is built in eval mode (BN frozen) with every parameter frozen.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device, upload
from ..utils.profiler import annotate
from .backbone import SparseBackbone
from .rpn import RPN
from .shasta import VOXEL_KEYS, ShastaConfig, frame_sparse


class BEVMap(nn.Module):
    """VFE + sparse backbone + RPN -> (B, H, W, 512) BEV feature map,
    channels last. No shared conv: ShastaModel's `bev_single` is
    `shared_conv` applied to this map."""

    def __init__(self, cfg: ShastaConfig = ShastaConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = SparseBackbone(
            cfg.num_input_features, dtype=cfg.dtype,
            caps=(cfg.cap_conv2, cfg.cap_conv3, cfg.cap_conv4, cfg.cap_extra),
            bn_sync=cfg.bn_axis_name is not None)
        self.neck = RPN(dtype=cfg.dtype)
        self.device = resolve_device(device)
        self.to(self.device).eval()
        self.requires_grad_(False)

    def forward(self, frame: dict) -> torch.Tensor:
        """frame: `trunk_bev`'s dict (voxels (B, V, P, 5), num_points (B,
        V), coordinates (B, V, 3) [z, y, x], voxels_valid (B, V); at B=1
        optionally the plan_* arrays), numpy arrays or tensors. Without
        plans every index is built on the device (sorted_lookup +
        gather_conv); with them the B=1 route (rulebook_conv +
        keyed_conv)."""
        frame = {k: upload(v, self.device) for k, v in frame.items()
                 if k in VOXEL_KEYS or k.startswith("plan_")}
        st, plans = frame_sparse(self.cfg, frame)
        with annotate("bevmap.sparse_trunk"):
            x = self.backbone(st, plans)
        with annotate("bevmap.neck"):
            x = self.neck(x)
        return x.permute(0, 2, 3, 1)
