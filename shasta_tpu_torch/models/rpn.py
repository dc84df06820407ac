"""RPN neck + shared conv: the port of shasta_tpu/models/rpn.py, NCHW inside.

Module names follow det3d (necks/rpn.py:67-116, shasta.py:42-47):
neck.blocks.{i} = [ZeroPad2d, Conv2d(stride), BN, ReLU, (Conv2d, BN, ReLU) x n],
neck.deblocks.{i} = [ConvTranspose2d or 1x1 Conv2d, BN, ReLU],
shared_conv = [Conv2d 3x3 with bias, BN, ReLU].
Neck BN eps is 1e-3; the shared conv's BN keeps torch's default 1e-5
(rpn.py:156-166). With `dtype` bf16 the convolutions take bf16 inputs and
weights and the BNs run in f32, as flax's Conv(dtype=bf16) +
BatchNorm(dtype=f32) do in the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _run(seq: nn.Sequential, x: torch.Tensor, dtype) -> torch.Tensor:
    """Apply a conv/BN/ReLU Sequential; convs in `dtype`, BNs in f32."""
    for m in seq:
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and dtype is not None:
            w = m.weight.to(dtype)
            b = None if m.bias is None else m.bias.to(dtype)
            x = x.to(dtype)
            if isinstance(m, nn.ConvTranspose2d):
                x = F.conv_transpose2d(x, w, b, m.stride, m.padding)
            else:
                x = F.conv2d(x, w, b, m.stride, m.padding)
        elif isinstance(m, nn.BatchNorm2d):
            x = m(x.float())
        else:
            x = m(x)
    return x


class RPN(nn.Module):
    """CenterPoint RPN (configs/nusc/car.py:52-61 dims by default)."""

    def __init__(self, layer_nums: Sequence[int] = (5, 5),
                 ds_layer_strides: Sequence[int] = (1, 2),
                 ds_num_filters: Sequence[int] = (128, 256),
                 us_layer_strides: Sequence[int] = (1, 2),
                 us_num_filters: Sequence[int] = (256, 256),
                 num_input_features: int = 256, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.blocks, self.deblocks = nn.ModuleList(), nn.ModuleList()
        in_filters = [num_input_features, *ds_num_filters[:-1]]
        for i, n in enumerate(layer_nums):
            c = ds_num_filters[i]
            seq = [nn.ZeroPad2d(1),
                   nn.Conv2d(in_filters[i], c, 3, stride=ds_layer_strides[i], bias=False),
                   nn.BatchNorm2d(c, eps=1e-3, momentum=0.01), nn.ReLU()]
            for _ in range(n):
                seq += [nn.Conv2d(c, c, 3, padding=1, bias=False),
                        nn.BatchNorm2d(c, eps=1e-3, momentum=0.01), nn.ReLU()]
            self.blocks.append(nn.Sequential(*seq))
            s, u = us_layer_strides[i], us_num_filters[i]
            up = (nn.ConvTranspose2d(c, u, s, stride=s, bias=False) if s > 1
                  else nn.Conv2d(c, u, 1, stride=1, bias=False))
            self.deblocks.append(nn.Sequential(
                up, nn.BatchNorm2d(u, eps=1e-3, momentum=0.01), nn.ReLU()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for blk, de in zip(self.blocks, self.deblocks):
            x = _run(blk, x, self.dtype)
            ups.append(_run(de, x, self.dtype))
        return torch.cat(ups, dim=1)  # (B, 512, H, W)


class SharedConv(nn.Sequential):
    """3x3 conv in -> features, BN (eps 1e-5), ReLU (shasta.py:42-47)."""

    def __init__(self, in_channels: int = 512, features: int = 64, dtype=None):
        super().__init__(nn.Conv2d(in_channels, features, 3, padding=1, bias=True),
                         nn.BatchNorm2d(features), nn.ReLU())
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run(self, x, self.dtype)
