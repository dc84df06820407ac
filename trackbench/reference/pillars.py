"""The plain reference of CenterPoint-PointPillars' trunk under ShaSTA's
shared conv, in float32 PyTorch with TF32 off, written from det3d's
modules over a flat dict of weights under the port's names (det3d's for
the neck and the shared conv; the reader's `pfn_layers.{i}.linear` /
`.norm` as `reader.pfn_{i}` / `reader.bn_{i}`):

- det3d's PillarFeatureNet (readers/pillar_encoder.py) as written: the
  points' cluster-mean and pillar-centre offsets, the padded point slots
  zeroed, then each PFNLayer (Linear without bias, BN1d with eps 1e-3,
  ReLU, the max over the pillar's slots), every layer but the last at half
  its listed width and concatenated with its max; the padded slots pass
  through every layer and into each max;
- PointPillarsScatter: each pillar's features at its (y, x) cell of a
  zero canvas;
- the RPN (necks/rpn.py): blocks of a ZeroPad2d(1) + strided 3x3 conv and
  layer_nums 3x3 convs, each with BN (eps 1e-3) and ReLU; the deblocks at
  det3d's upsample strides (above 1 a transposed conv of kernel and stride
  s, 1 a 1x1 conv, below 1 a conv of kernel and stride round(1/s)),
  concatenated; then the shared conv (3x3 with bias, BN eps 1e-5, ReLU);
- box points and bilinear sampling as model.py has them.

The convs are model.py's direct convolutions (patches times the weight
matrix). Departures from det3d: none. det3d runs only the filled pillars,
and so does this reference; the program runs every one of the frame's
fixed V slots and drops the empty ones at the scatter.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from . import model as rm
from .pipelines import Trunk as _SparseTrunk


def trunk_spec(m: dict) -> OrderedDict:
    """The trunk's weights (shapes and draws) of a configuration's model
    keys: the pillar reader, the RPN and the shared conv."""
    spec: OrderedDict = OrderedDict()
    filters = list(m["pfn_filters"])
    c_in = m["num_input_features"] + 5
    for i, f in enumerate(filters):
        units = f if i + 1 == len(filters) else f // 2
        spec[f"reader.pfn_{i}.weight"] = ((units, c_in), "weight")
        rm._bn(spec, f"reader.bn_{i}", units)
        c_in = 2 * units
    ins = [m["neck_input_features"], *m["ds_num_filters"][:-1]]
    for i, (n, c) in enumerate(zip(m["layer_nums"], m["ds_num_filters"])):
        p = f"neck.blocks.{i}"
        spec[p + ".1.weight"] = ((c, ins[i], 3, 3), "weight")
        rm._bn(spec, p + ".2", c)
        for j in range(n):
            spec[f"{p}.{4 + 3 * j}.weight"] = ((c, c, 3, 3), "weight")
            rm._bn(spec, f"{p}.{5 + 3 * j}", c)
        s, u = m["us_layer_strides"][i], m["us_num_filters"][i]
        d = f"neck.deblocks.{i}"
        if s > 1:
            spec[d + ".0.weight"] = ((c, u, int(round(s)), int(round(s))), "deconv")
        else:
            k = int(round(1 / s))
            spec[d + ".0.weight"] = ((u, c, k, k), "weight")
        rm._bn(spec, d + ".1", u)
    C = m["share_conv_channel"]
    spec["shared_conv.0.weight"] = ((C, sum(m["us_num_filters"]), 3, 3), "weight")
    spec["shared_conv.0.bias"] = ((C,), "bias")
    rm._bn(spec, "shared_conv.1", C)
    return spec


def _bn1d(x: torch.Tensor, sd: dict, p: str, eps: float = 1e-3) -> torch.Tensor:
    """BatchNorm1d in eval mode over the channels of x (M, C, P)."""
    return torch.nn.functional.batch_norm(
        x, sd[p + ".running_mean"], sd[p + ".running_var"], sd[p + ".weight"],
        sd[p + ".bias"], False, 0.0, eps)


def pfn(sd: dict, features: torch.Tensor, num_voxels: torch.Tensor, coors: torch.Tensor,
        n_layers: int, voxel_size, pc_start) -> torch.Tensor:
    """det3d's PillarFeatureNet.forward over M filled pillars: features (M,
    P, 5) with zeros in the padded slots, num_voxels (M,) >= 1, coors (M,
    3) [z, y, x] -> (M, C)."""
    vx, vy = voxel_size[0], voxel_size[1]
    x_offset, y_offset = vx / 2 + pc_start[0], vy / 2 + pc_start[1]
    dtype = features.dtype
    points_mean = (features[:, :, :3].sum(dim=1, keepdim=True)
                   / num_voxels.type_as(features).view(-1, 1, 1))
    f_cluster = features[:, :, :3] - points_mean
    f_center = torch.zeros_like(features[:, :, :2])
    f_center[:, :, 0] = features[:, :, 0] - (coors[:, 2].to(dtype).unsqueeze(1) * vx + x_offset)
    f_center[:, :, 1] = features[:, :, 1] - (coors[:, 1].to(dtype).unsqueeze(1) * vy + y_offset)
    features = torch.cat([features, f_cluster, f_center], dim=-1)
    P = features.shape[1]
    mask = torch.arange(P, device=features.device)[None, :] < num_voxels[:, None]
    features = features * mask.unsqueeze(-1).type_as(features)
    for i in range(n_layers):
        x = features @ sd[f"reader.pfn_{i}.weight"].t()
        x = _bn1d(x.permute(0, 2, 1).contiguous(), sd, f"reader.bn_{i}").permute(0, 2, 1)
        x = torch.relu(x)
        x_max = torch.max(x, dim=1, keepdim=True)[0]
        if i + 1 == n_layers:
            features = x_max
        else:
            features = torch.cat([x, x_max.repeat(1, P, 1)], dim=2)
    return features.squeeze(1)


def scatter(feats: torch.Tensor, coors: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """PointPillarsScatter of one frame: (M, C) at coors (M, 3) [z, y, x]
    -> (1, C, ny, nx)."""
    canvas = feats.new_zeros((feats.shape[1], ny * nx))
    canvas[:, (coors[:, 1] * nx + coors[:, 2]).long()] = feats.t()
    return canvas.view(1, -1, ny, nx)


def neck(sd: dict, x: torch.Tensor, m: dict) -> torch.Tensor:
    """RPN and shared conv of (1, C, ny, nx) -> (1, H, W, share_conv_channel)."""
    ups = []
    for i, (n, stride) in enumerate(zip(m["layer_nums"], m["ds_layer_strides"])):
        p = f"neck.blocks.{i}"
        x = torch.relu(rm._bn2d(rm.conv2d(x, sd[p + ".1.weight"], stride, 1), sd, p + ".2", 1e-3))
        for j in range(n):
            x = torch.relu(rm._bn2d(rm.conv2d(x, sd[f"{p}.{4 + 3 * j}.weight"], 1, 1), sd,
                                    f"{p}.{5 + 3 * j}", 1e-3))
        d, s = f"neck.deblocks.{i}", m["us_layer_strides"][i]
        w = sd[d + ".0.weight"]
        if s > 1:
            if int(round(s)) != 2:
                raise ValueError(f"the reference's transposed conv is 2x2 at stride 2, not {s}")
            up = rm.deconv2x2(x, w)
        else:
            up = rm.conv2d(x, w, int(round(1 / s)), 0)
        ups.append(torch.relu(rm._bn2d(up, sd, d + ".1", 1e-3)))
    x = torch.cat(ups, 1)
    x = rm.conv2d(x, sd["shared_conv.0.weight"], 1, 1) + sd["shared_conv.0.bias"][:, None, None]
    return torch.relu(rm._bn2d(x, sd, "shared_conv.1", 1e-5)).permute(0, 2, 3, 1)


class Trunk(_SparseTrunk):
    """The pillar trunk's weights and geometry, as pipelines.Trunk for the
    sparse one: `bev(frame)` -> (H, W, 64), `features(bev, boxes)`, and
    `sets`, per frame the number of filled pillars."""

    def bev(self, frame: dict) -> torch.Tensor:
        m, d = self.cfg, self.dev
        valid = torch.as_tensor(np.asarray(frame["voxels_valid"]), device=d).bool()
        voxels = torch.as_tensor(np.asarray(frame["voxels"]), device=d)[valid]
        num = torch.as_tensor(np.asarray(frame["num_points"]), device=d)[valid]
        coors = torch.as_tensor(np.asarray(frame["coordinates"]), device=d)[valid]
        feats = pfn(self.sd, voxels[:, :, :m["num_input_features"]], num, coors,
                    len(m["pfn_filters"]), m["voxel_size"], m["pc_start"])
        self.sets.append([int(valid.sum())])
        return neck(self.sd, scatter(feats, coors, *m["grid_shape"][1:]), m)[0]
