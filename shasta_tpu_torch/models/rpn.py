"""RPN neck + shared conv: the port of shasta_tpu/models/rpn.py, NCHW inside.

Module names follow det3d (necks/rpn.py:67-116, shasta.py:42-47):
neck.blocks.{i} = [ZeroPad2d, Conv2d(stride), BN, ReLU, (Conv2d, BN, ReLU) x n],
neck.deblocks.{i} = [ConvTranspose2d or 1x1 Conv2d, BN, ReLU],
shared_conv = [Conv2d 3x3 with bias, BN, ReLU].
Neck BN eps is 1e-3; the shared conv's BN keeps torch's default 1e-5
(rpn.py:156-166). With `dtype` bf16 the convolutions take bf16 inputs and
weights and the BNs run in f32, as flax's Conv(dtype=bf16) +
BatchNorm(dtype=f32) do in the JAX package. In train mode the BNs take
flax's batch statistics and update (`batch_norm`).

Inference in f32 on the card (`kernel_route`) runs each conv with its BN
and ReLU as one launch of the neck's conv kernel (ops/kernels/dense_conv.py):
15 launches for the VoxelNet neck, 20 for CenterPoint-PP's three blocks,
channels last inside, the deblocks written into their channel ranges of
one map. The RPN returns that map as an NCHW-shaped view of its
NHWC storage, and so does the shared conv. Everything else (bf16, a BN in
train mode, autograd recording) runs `_run`.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def batch_norm(m: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """m in eval mode: its running statistics. In train mode flax's
    BatchNorm (rpn.py:40-45, 160-165): the batch mean and the biased
    variance max(0, E[x^2] - mean^2) over (N, H, W), and the running
    statistics move m.momentum of the way to them (0.01 for the neck, 0.1
    for the shared conv: flax 0.99 and 0.9). torch's BatchNorm2d would move
    the running variance towards the unbiased one instead."""
    if not m.training:
        return m(x)
    mean = x.mean((0, 2, 3))
    var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        m.running_mean.mul_(1 - m.momentum).add_(mean * m.momentum)
        m.running_var.mul_(1 - m.momentum).add_(var * m.momentum)
    inv = torch.rsqrt(var + m.eps) * m.weight
    return (x - mean[:, None, None]) * inv[:, None, None] + m.bias[:, None, None]


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
            x = batch_norm(m, x.float())
        else:
            x = m(x)
    return x


def kernel_route(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether `module` (an RPN or a SharedConv) runs on the neck's conv
    kernel: the input is f32 on the card and `fusable` holds."""
    return x.is_cuda and fusable(module, x)


def fusable(module: nn.Module, x: torch.Tensor) -> bool:
    """The route's condition apart from the device: f32 input and convs,
    autograd not recording for the module (grad mode off, or neither the
    input nor a parameter requires grad), and every BN in eval mode."""
    if x.dtype != torch.float32 or module.dtype not in (None, torch.float32):
        return False
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in module.parameters())):
        return False
    return not any(m.training for m in module.modules() if isinstance(m, nn.BatchNorm2d))


def _conv_bns(seq: nn.Sequential) -> list:
    """[(conv, its BN, the ZeroPad2d's zeros before it)] of a conv/BN/ReLU
    Sequential."""
    out, pad, conv = [], 0, None
    for m in seq:
        if isinstance(m, nn.ZeroPad2d):
            if len(set(m.padding)) != 1:
                raise ValueError(f"the kernel route pads evenly: {m}")
            pad = m.padding[0]
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            conv = m
        elif isinstance(m, nn.BatchNorm2d):
            out.append((conv, m, pad))
            pad = 0
    return out


def _packed(module: nn.Module, groups: list) -> list:
    """dense_conv.pack of each (conv, BN, pad) of each group, made once and
    again only when a parameter or buffer of `module` is replaced or
    updated in place (its storage or its version counter moves)."""
    from ..ops.kernels.dense_conv import pack

    key = tuple((t.data_ptr(), t._version)
                for t in (*module.parameters(), *module.buffers()))
    cached = module.__dict__.get("_dense_packs")
    if cached is None or cached[0] != key:
        cached = (key, [[pack(*cbp) for cbp in g] for g in groups])
        module.__dict__["_dense_packs"] = cached
    return cached[1]


def deblock_conv(c: int, u: int, stride: float) -> nn.Module:
    """A deblock's conv from c to u channels at det3d's upsample stride
    (det3d necks/rpn.py): above 1 a ConvTranspose2d whose kernel is its
    stride, 1 a 1x1 conv, below 1 a Conv2d of kernel and stride
    round(1 / stride) (0.5: 2x2 at stride 2)."""
    if stride > 1:
        s = int(round(stride))
        return nn.ConvTranspose2d(c, u, s, stride=s, bias=False)
    k = int(round(1 / stride))
    return nn.Conv2d(c, u, k, stride=k, bias=False)


class RPN(nn.Module):
    """CenterPoint RPN (configs/nusc/car.py:52-61 dims by default): any
    number of blocks, each deblocked to a common grid; the deblocks' maps
    are concatenated, sum(us_num_filters) channels."""

    def __init__(self, layer_nums: Sequence[int] = (5, 5),
                 ds_layer_strides: Sequence[int] = (1, 2),
                 ds_num_filters: Sequence[int] = (128, 256),
                 us_layer_strides: Sequence[float] = (1, 2),
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
            self.deblocks.append(nn.Sequential(
                deblock_conv(c, us_num_filters[i], us_layer_strides[i]),
                nn.BatchNorm2d(us_num_filters[i], eps=1e-3, momentum=0.01), nn.ReLU()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if kernel_route(self, x):
            return self._forward_kernel(x)
        ups = []
        for blk, de in zip(self.blocks, self.deblocks):
            x = _run(blk, x, self.dtype)
            ups.append(_run(de, x, self.dtype))
        return torch.cat(ups, dim=1)  # (B, sum(us_num_filters), H, W)

    def _forward_kernel(self, x: torch.Tensor) -> torch.Tensor:
        """One dense_conv launch a conv; the deblocks fill their channel
        ranges of one (B, H, W, C) map, returned as a (B, C, H, W) view
        (C = sum(us_num_filters))."""
        from ..ops.kernels.dense_conv import dense_conv, out_grid

        n = len(self.blocks)
        packs = _packed(self, [_conv_bns(s) for s in (*self.blocks, *self.deblocks)])
        h, out, off = x.permute(0, 2, 3, 1).contiguous(), None, 0
        for blk, (de,) in zip(packs[:n], packs[n:]):
            for p in blk:
                h = dense_conv(h, p)
            if out is None:
                Ho, Wo = out_grid(h, de)
                co = sum(d[0].out_channels for d in self.deblocks)
                out = h.new_empty((h.shape[0], Ho * de.up, Wo * de.up, co))
            dense_conv(h, de, out, off)
            off += de.w.shape[0] // (de.up * de.up)
        return out.permute(0, 3, 1, 2)


class SharedConv(nn.Sequential):
    """3x3 conv in -> features, BN (eps 1e-5), ReLU (shasta.py:42-47)."""

    def __init__(self, in_channels: int = 512, features: int = 64, dtype=None):
        super().__init__(nn.Conv2d(in_channels, features, 3, padding=1, bias=True),
                         nn.BatchNorm2d(features), nn.ReLU())
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if kernel_route(self, x):
            from ..ops.kernels.dense_conv import dense_conv

            (p,), = _packed(self, [_conv_bns(self)])
            return dense_conv(x.permute(0, 2, 3, 1).contiguous(), p).permute(0, 3, 1, 2)
        return _run(self, x, self.dtype)
