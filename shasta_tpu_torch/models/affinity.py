"""ShaSTA affinity head: the port of shasta_tpu/models/affinity.py.

Module names follow det3d (shasta.py:49-106): aug_shape.{i}.{0,2},
aug_dets.{i}.{0,2}, fuse_shape.{0,2,4,6}, fuse_det.{0,2,4},
res_coeff.{0,2,4}, aff.{0,2,...,10}. The pairwise MLPs split their first
layer into prev/curr halves and broadcast-add them (the JAX head's
split-first-layer evaluation), instead of materialising (T*D, 2F) inputs.

With `classes=C` every linear layer holds C stacked weight sets and the
head runs C class heads in one pass over a leading (C,) axis: the JAX
multi-class step's jax.vmap over stacked parameters (infer.py:710-730),
written out as batched matrix products.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class StackedLinear(nn.Module):
    """C linear layers of one shape, weight (C, out, in) and bias (C, out):
    x (C, ..., in) -> (C, ..., out), class c through layer c. The weights
    are allocated uninitialised: they are always loaded."""

    def __init__(self, classes: int, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((classes, out_dim, in_dim)))
        self.bias = nn.Parameter(torch.empty((classes, out_dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C, n_in = x.shape[0], x.shape[-1]
        y = torch.baddbmm(self.bias[:, None, :], x.reshape(C, -1, n_in),
                          self.weight.transpose(1, 2))
        return y.reshape(*x.shape[:-1], y.shape[-1])


def _linear(in_dim: int, out_dim: int, classes: int | None) -> nn.Module:
    return nn.Linear(in_dim, out_dim) if classes is None else StackedLinear(
        classes, in_dim, out_dim)


class MLP(nn.Sequential):
    """Linear layers with ReLU between them (none after the last)."""

    def __init__(self, in_dim: int, features: Sequence[int], classes: int | None = None):
        layers: list[nn.Module] = []
        for i, f in enumerate(features):
            layers.append(_linear(in_dim, f, classes))
            if i + 1 < len(features):
                layers.append(nn.ReLU())
            in_dim = f
        super().__init__(*layers)


class PairwiseMLP(MLP):
    """MLP over concat(prev, curr) pairs: (B, T, F), (B, D, F) -> (B, T, D, out)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 classes: int | None = None):
        super().__init__(2 * in_dim, [*hidden, out_dim], classes)
        self.in_dim = in_dim

    def forward(self, prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
        first = self[0]
        kp, kc = first.weight[..., :self.in_dim], first.weight[..., self.in_dim:]
        hp = prev @ kp.mT
        hc = curr @ kc.mT
        bias = first.bias if first.bias.dim() == 1 else first.bias[:, None, None, :]
        x = hp[:, :, None, :] + hc[:, None, :, :] + bias
        for m in list(self)[1:]:
            x = m(x)
        return x


class AffinityNet(nn.Module):
    """The augmented-affinity head (shasta.py:49-109 parameterisation); with
    `classes=C`, C such heads stacked (their inputs' leading axis is the
    class axis)."""

    def __init__(self, max_obj: int = 90, num_feats: int = 3, num_point: int = 5,
                 share_conv_channel: int = 64, classes: int | None = None):
        super().__init__()
        self.max_obj, self.num_feats = max_obj, num_feats
        F = num_point * share_conv_channel
        in_shape = max_obj * F
        self.aug_shape = nn.ModuleList(
            [MLP(in_shape, [in_shape // 64, F], classes) for _ in range(4)])
        in_det = max_obj * 7
        self.aug_dets = nn.ModuleList(
            [MLP(in_det, [in_det // 32, 7], classes) for _ in range(4)])
        self.fuse_shape = PairwiseMLP(F, [F // 8, F // 16, F // 32], 1, classes)
        self.fuse_det = PairwiseMLP(num_feats, [32, 8], 1, classes)
        self.res_coeff = PairwiseMLP(F + num_feats, [32 + F // 8, 8 + F // 32], 3, classes)
        n = max_obj + 2
        self.aff = MLP(n, [128, 64, 32, 64, 128, n], classes)

    def forward(self, prev_boxes7, curr_boxes7, curr_vel, curr_dt, prev_feat,
                curr_feat, n_real=None):
        """Boxes (B, N, 7), velocity (B, N, 2), dt (B, N, 1), descriptors
        (B, N, F) -> (matched1 (B, N, N+2) row softmax, matched2
        (B, N+2, N) column softmax). n_real emulates a max_obj=n_real head
        (rows/cols [n_real, N) get no softmax mass): an int or a tensor of
        shape () or (B,), one count per class of a stacked head."""
        B, N, _ = prev_feat.shape
        assert N == self.max_obj, (N, self.max_obj)
        curr_flat = curr_feat.reshape(B, -1)
        prev_flat = prev_feat.reshape(B, -1)
        newborn_geom = self.aug_shape[0](curr_flat).abs()[:, None, :]
        fp_geom = self.aug_shape[1](curr_flat).abs()[:, None, :]
        dead_geom = self.aug_shape[2](prev_flat).abs()[:, None, :]
        fn_geom = self.aug_shape[3](prev_flat).abs()[:, None, :]
        feat_d = torch.cat([curr_feat, dead_geom, fn_geom], dim=1)
        feat_t = torch.cat([prev_feat, newborn_geom, fp_geom], dim=1)

        def abs_dims(b):
            return torch.cat([b[..., :3], b[..., 3:6].abs(), b[..., 6:]], -1)

        curr_box_flat = curr_boxes7.reshape(B, -1)
        prev_box_flat = prev_boxes7.reshape(B, -1)
        newborn_box = abs_dims(self.aug_dets[0](curr_box_flat)[:, None, :])
        fp_box = abs_dims(self.aug_dets[1](curr_box_flat)[:, None, :])
        dead_box = abs_dims(self.aug_dets[2](prev_box_flat)[:, None, :])
        fn_box = abs_dims(self.aug_dets[3](prev_box_flat)[:, None, :])

        curr_bp = torch.cat(
            [curr_boxes7[..., :2] - curr_vel * curr_dt, curr_boxes7[..., 2:]], -1)
        boxes_t = torch.cat([prev_boxes7, newborn_box, fp_box], dim=1)
        boxes_d = torch.cat([curr_bp, dead_box, fn_box], dim=1)

        eps = 1e-10
        nf = self.num_feats
        diff = boxes_t[:, :, None, :nf] - boxes_d[:, None, :, :nf]
        residual_dist = (diff * diff).sum(-1)  # (B, T, D)
        if n_real is not None:
            # (1 or B, N) real entity slots; the two anchors stay real
            ent = (torch.arange(N, device=diff.device)
                   < torch.as_tensor(n_real, device=diff.device).reshape(-1, 1))
            row_real = torch.cat([ent, ent.new_ones((ent.shape[0], 2))], 1)
            residual_dist = residual_dist * row_real[:, :, None]
        # F.normalize(p=2, dim=1): per-(b, d) column L2 normalisation
        norm = torch.sqrt((residual_dist**2).sum(1, keepdim=True))
        residual_dist = residual_dist / norm.clamp(min=1e-12)
        residual_dim = (torch.log(boxes_t[:, :, None, 3:6] + eps)
                        - torch.log(boxes_d[:, None, :, 3:6] + eps)).abs().sum(-1)
        dc = torch.cos(boxes_t[:, :, None, 6]) - torch.cos(boxes_d[:, None, :, 6])
        ds = torch.sin(boxes_t[:, :, None, 6]) - torch.sin(boxes_d[:, None, :, 6])
        rot_sq = dc * dc + ds * ds
        # safe sqrt (affinity.py:208-213): the same forward, and a zero grad
        # at equal yaws where d/dx sqrt(0) would make the backward NaN
        residual_rot = torch.where(rot_sq > 0, torch.sqrt(torch.where(rot_sq > 0, rot_sq, 1.0)),
                                   0.0)
        residual_hand = residual_dist + residual_dim + residual_rot

        residual_shape = self.fuse_shape(feat_t, feat_d)[..., 0]
        residual_fused = self.fuse_det(boxes_t[..., :nf], boxes_d[..., :nf])[..., 0]
        coeff = self.res_coeff(torch.cat([feat_t, boxes_t[..., :nf]], -1),
                               torch.cat([feat_d, boxes_d[..., :nf]], -1))
        alpha, beta, omega = coeff[..., 0], coeff[..., 1], coeff[..., 2]
        residual = alpha * residual_fused + beta * residual_hand + omega * residual_shape

        matched = self.aff(residual).float()  # row-wise MLP over D, (B, T, D)
        if n_real is not None:
            pad_ent = ~row_real
            matched = torch.where(pad_ent[:, :, None], -1e9, matched)
            matched = torch.where(pad_ent[:, None, :], -1e9, matched)
        matched1 = torch.softmax(matched[:, :-2, :], dim=2)
        matched2 = torch.softmax(matched[:, :, :-2], dim=1)
        return matched1, matched2
