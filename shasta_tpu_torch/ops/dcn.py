"""Deformable convolution v1/v2 and deformable PS-RoI pooling: the port of
shasta_tpu/ops/dcn.py (model-zoo components, off the ShaSTA path).

Behavioral reference: det3d/ops/dcn/ (the CUDA deform conv and deform
pool kernels and deform_conv.py). The JAX package computes both in plain
XLA (bilinear sampling at the offset taps, then one matmul), so stock
torch ops are their port here: gathers and a matmul, with autograd for
the backward. Feature maps are NHWC, as in the JAX functions.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device


def _bilinear_hw(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C); py/px: (B, ...) float positions -> (B, ..., C),
    zero outside. The corner indices are clamped before the gather (torch
    indexing would wrap a negative index) and the corner masked after."""
    B, H, W, C = x.shape
    flat = x.reshape(B, H * W, C)
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    out = 0.0
    for dy, sy in ((0, 1 - wy), (1, wy)):
        for dx, sx in ((0, 1 - wx), (1, wx)):
            yy = (y0 + dy).long()
            xx = (x0 + dx).long()
            ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
            v = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
            out = out + v.reshape(*idx.shape, C) * (sy * sx * ok)[..., None]
    return out


class DeformConv2d(nn.Module):
    """k x k deformable conv; offsets (and the v2 modulation) come from a
    plain conv that starts at zero. x (B, H, W, C) -> (B, H, W, features).

    Parameters, in the JAX tree's names: offset_conv (Conv2d, 3K or 2K
    outputs: the first 2K are the taps' (dy, dx), the last K the
    modulation's logits), kernel (K*C, features), K-major with the taps
    in meshgrid "ij" order of (dy, dx), and bias (features,)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 modulated: bool = True, device=None,
                 generator: torch.Generator | None = None):
        """`generator` seeds `kernel` (flax's variance_scaling(1, fan_in,
        truncated_normal): std sqrt(1/(K*C)) corrected, cut at 2 std)."""
        super().__init__()
        self.k, self.modulated = kernel, modulated
        K = kernel * kernel
        self.offset_conv = nn.Conv2d(in_channels, (3 if modulated else 2) * K, kernel,
                                     padding=kernel // 2)
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)
        std = (K * in_channels) ** -0.5 / 0.87962566103423978
        self.kernel = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(K * in_channels, features), 0.0, std, -2 * std, 2 * std,
            generator=generator))
        self.bias = nn.Parameter(torch.zeros(features))
        r = torch.arange(kernel) - kernel // 2
        taps = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1).reshape(K, 2)
        self.register_buffer("taps", taps.float(), persistent=False)
        self.device = resolve_device(device)
        self.to(self.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        K = self.k * self.k
        off = self.offset_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        offsets = off[..., :2 * K].reshape(B, H, W, K, 2)
        if self.modulated:
            mod = torch.sigmoid(off[..., 2 * K:]).reshape(B, H, W, K)
        else:
            mod = x.new_ones((B, H, W, K))
        gy = torch.arange(H, device=x.device)[:, None, None] + self.taps[:, 0]
        gx = torch.arange(W, device=x.device)[None, :, None] + self.taps[:, 1]
        py = gy[None] + offsets[..., 0]
        px = gx[None] + offsets[..., 1]
        sampled = _bilinear_hw(x, py, px) * mod[..., None]  # (B, H, W, K, C)
        return sampled.reshape(B, H, W, K * C) @ self.kernel + self.bias


def deform_psroi_pooling(data: torch.Tensor, rois: torch.Tensor, trans: torch.Tensor | None,
                         *, spatial_scale: float, output_dim: int, group_size: int,
                         pooled_size: int, part_size: int | None = None,
                         sample_per_part: int = 4,
                         trans_std: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Deformable position-sensitive RoI pooling, forward; autograd gives
    the backward (through data and trans).

    Behavioral reference: det3d/ops/dcn/src/deform_pool_cuda_kernel.cu
    DeformablePSROIPoolForwardKernel (:53-140).
      data: (B, H, W, C), C == output_dim * group_size**2;
      rois: (N, 5) rows [batch_idx, x1, y1, x2, y2] in input-image coords;
      trans: (N, num_classes*2, part_size, part_size) or None.
    Returns (pooled (N, P, P, output_dim), counts (N, P, P, output_dim)):
    counts is the number of in-bounds samples per bin (the kernel's
    top_count). torch.round rounds half to even, as jnp.round does. Each
    division is by a tensor on the data's device: on the card torch turns
    a division by a host scalar into a product with its reciprocal, whose
    last bit differs, and at map coordinates of ~100 one bit moves a sample
    by ~1e-5."""
    B, H, W, C = data.shape
    assert C == output_dim * group_size * group_size, (C, output_dim, group_size)
    dev, dt = data.device, data.dtype
    N = rois.shape[0]
    P, S, G = pooled_size, sample_per_part, group_size
    part = part_size if part_size is not None else pooled_size
    num_classes = 1 if trans is None else trans.shape[1] // 2
    ch_each = output_dim // num_classes

    def div(a, n):  # a / n, true division on every device
        return a / torch.full((), n, dtype=a.dtype, device=dev)

    b_idx = rois[:, 0].to(torch.int64)
    start_w = torch.round(rois[:, 1]) * spatial_scale - 0.5
    start_h = torch.round(rois[:, 2]) * spatial_scale - 0.5
    end_w = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    end_h = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp_min(end_w - start_w, 0.1)  # (N,)
    roi_h = torch.clamp_min(end_h - start_h, 0.1)
    bin_w, bin_h = div(roi_w, P), div(roi_h, P)
    sub_w, sub_h = div(bin_w, S), div(bin_h, S)

    ph = torch.arange(P, device=dev)
    part_p = torch.floor(div(ph.to(torch.float32), P) * part).to(torch.int64)
    cls_id = torch.arange(output_dim, device=dev) // ch_each  # (D,)

    if trans is None:
        tx = ty = torch.zeros((N, output_dim, P, P), dtype=dt, device=dev)
    else:  # trans[(n, class_id*2 + {0,1}, part_h, part_w)] * trans_std
        tx = trans[:, cls_id * 2][:, :, part_p][:, :, :, part_p] * trans_std
        ty = trans[:, cls_id * 2 + 1][:, :, part_p][:, :, :, part_p] * trans_std

    def per_roi(v):  # (N,) -> (N, 1, 1, 1)
        return v[:, None, None, None]

    # sample positions: (N, D, P, P, S, S) over (n, d, ph, pw, ih, iw)
    s = torch.arange(S, device=dev)
    wstart = (ph[None, None, None, :] * per_roi(bin_w) + per_roi(start_w)
              )[..., None, None] + (tx * per_roi(roi_w))[..., None, None]
    hstart = (ph[None, None, :, None] * per_roi(bin_h) + per_roi(start_h)
              )[..., None, None] + (ty * per_roi(roi_h))[..., None, None]
    sw = wstart + s[None, None, None, None, None, :] * per_roi(sub_w)[..., None, None]
    sh = hstart + s[None, None, None, None, :, None] * per_roi(sub_h)[..., None, None]

    inb = (sw >= -0.5) & (sw <= W - 0.5) & (sh >= -0.5) & (sh <= H - 0.5)
    x = torch.clamp(sw, 0.0, W - 1.0)
    y = torch.clamp(sh, 0.0, H - 1.0)

    # position-sensitive channel per (d, ph, pw): (ctop*G + gh)*G + gw
    g = torch.clamp((ph * G) // P, 0, G - 1)
    chan = ((torch.arange(output_dim, device=dev)[:, None, None] * G + g[None, :, None]) * G
            + g[None, None, :])  # (D, P, P)

    # bilinear over the floor/ceil corners (kernel bilinear_interp, :31-51)
    x1, y1, x2, y2 = torch.floor(x), torch.floor(y), torch.ceil(x), torch.ceil(y)
    dx, dy = x - x1, y - y1
    bb = b_idx[:, None, None, None, None, None]
    cc = chan[None, :, :, :, None, None]

    def at(yi, xi):
        return data[bb, yi.long(), xi.long(), cc]

    val = ((1 - dx) * (1 - dy) * at(y1, x1) + (1 - dx) * dy * at(y2, x1)
           + dx * (1 - dy) * at(y1, x2) + dx * dy * at(y2, x2))
    val = torch.where(inb, val, 0.0)
    cnt = inb.sum((-1, -2))  # (N, D, P, P)
    pooled = val.sum((-1, -2)) / cnt.clamp_min(1)
    pooled = torch.where(cnt > 0, pooled, 0.0)
    return pooled.permute(0, 2, 3, 1), cnt.to(torch.int32).permute(0, 2, 3, 1)
