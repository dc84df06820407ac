"""dense_conv: the f32 neck's convolutions, each one launch with eval-mode
BN, an optional residual and an optional ReLU fused (csrc/dense_conv.cu).

    dense_conv(x (B, H, W, Cin), packed, out=None, co_off=0, relu=True, residual=None)
        -> out (B, Ho * up, Wo * up, ldo) f32, channels last,
    out[..., co_off:co_off + Co] = relu(conv(x, W) * scale + shift + residual)

`pack(conv, bn, pad)` folds a Conv2d (or a ConvTranspose2d whose kernel
equals its stride) and the eval-mode BatchNorm2d after it (or none: scale
1) into a `Packed`: W as (N, ks * ks * Cin), K-major; the BN as a
per-channel scale and shift, the conv's bias in the shift. `residual` has
`out`'s shape and is added before the ReLU (a residual block's second
conv); `relu=False` leaves the ReLU out (its downsample branch, a plain
conv). On the card those two epilogues take N a multiple of 128. A
transposed conv of stride s is one GEMM of K = Cin and N = s * s * Cout,
columns (dy, dx, co), whose store puts each pixel's s x s outputs at their
places (`up` = s). `out` may be a wider buffer: the result goes into its
channels [co_off, co_off + Co), so that two convs fill one map.

It replaces no TPU kernel: the JAX package leaves the neck to XLA. On the
card, cuDNN with TF32 off ran the f32 neck at B=1 by FFT tiling, ~33,000
launches a frame; this is one launch a conv, 15 a neck (the RPN's 12
convs and 2 deblocks, the shared conv; 23 for DSVT-P's residual neck). What bounds it: the products
(2 * M * K * N FLOPs, 145 GFLOP a 180 x 180 frame) at 495/3 TFLOP/s as
three TF32 passes, far above its bytes; the source note says what its
design does about it.

On a CPU tensor the wrapper computes the plain version (F.conv2d with TF32
off, or the transposed conv as the same GEMM, then scale, shift, the
residual and ReLU); on a CUDA tensor it launches the kernel or raises. Each launch counts one
`neck.kernel_convs` on the program's counters (`utils/profiler.count`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ...utils import profiler
from . import refuse_autograd
from .block_conv import _ptr

BK = 32  # the kernel's K slice: Cin must be a multiple of it


class Packed(NamedTuple):
    """One conv + BN, as the kernel takes it."""
    w: torch.Tensor      # (N, ks * ks * Cin) f32
    scale: torch.Tensor  # (N,)
    shift: torch.Tensor  # (N,)
    ks: int              # taps ks x ks (1 for a transposed conv)
    stride: int
    pad: int             # zeros on each side
    up: int              # a transposed conv's stride: up x up outputs a pixel


def pack(conv: nn.Module, bn: nn.BatchNorm2d | None, pad: int = 0) -> Packed:
    """Fold `conv` (after `pad` zeros of a ZeroPad2d) and the eval-mode
    `bn` after it: scale = gamma / sqrt(var + eps), shift = beta + (bias -
    mean) * scale; without a BN scale 1 and shift the conv's bias (or 0)."""
    with torch.no_grad():
        w = conv.weight.float()
        co = w.shape[1] if isinstance(conv, nn.ConvTranspose2d) else w.shape[0]
        bias = (torch.zeros(co, device=w.device) if conv.bias is None else conv.bias.float())
        if bn is None:
            scale, shift = torch.ones_like(bias), bias.clone()
        else:
            scale = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
            shift = bn.bias.float() + (bias - bn.running_mean.float()) * scale
        if isinstance(conv, nn.ConvTranspose2d):
            s = conv.stride[0]
            if (conv.kernel_size != (s, s) or conv.stride != (s, s) or conv.padding != (0, 0)
                    or conv.output_padding != (0, 0) or conv.groups != 1 or pad):
                raise ValueError(f"dense_conv takes a transposed conv whose kernel is its "
                                 f"stride, unpadded: {conv}")
            cin, co = w.shape[:2]
            return Packed(w.permute(2, 3, 1, 0).reshape(s * s * co, cin).contiguous(),
                          scale.repeat(s * s).contiguous(), shift.repeat(s * s).contiguous(),
                          1, 1, 0, s)
        k = conv.kernel_size[0]
        if (conv.kernel_size != (k, k) or len(set(conv.stride)) != 1
                or len(set(conv.padding)) != 1 or conv.dilation != (1, 1) or conv.groups != 1):
            raise ValueError(f"dense_conv takes square, undilated, ungrouped convs: {conv}")
        co, cin = w.shape[:2]
        return Packed(w.permute(0, 2, 3, 1).reshape(co, k * k * cin).contiguous(),
                      scale.contiguous(), shift.contiguous(), k, conv.stride[0],
                      pad + conv.padding[0], 1)


def out_grid(x: torch.Tensor, p: Packed) -> tuple[int, int]:
    """(Ho, Wo): the grid of the GEMM's rows, before the store's upsampling."""
    _, H, W, _ = x.shape
    return ((H + 2 * p.pad - p.ks) // p.stride + 1, (W + 2 * p.pad - p.ks) // p.stride + 1)


def dense_conv_plain(x: torch.Tensor, p: Packed, out: torch.Tensor | None = None,
                     co_off: int = 0, relu: bool = True,
                     residual: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: F.conv2d (TF32 off on the card),
    or a transposed conv as the GEMM x @ W^T with an up x up store; then
    scale, shift, the residual and ReLU, into `out`'s channels from co_off."""
    B, H, W, cin = x.shape
    if p.up == 1:
        w = p.w.reshape(-1, p.ks, p.ks, cin).permute(0, 3, 1, 2)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, None, p.stride, p.pad).permute(0, 2, 3, 1)
    else:
        u = p.up
        y = (x.reshape(-1, cin) @ p.w.t()).reshape(B, H, W, u, u, -1)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, H * u, W * u, -1)
    co = y.shape[-1]
    y = y * p.scale[:co] + p.shift[:co]
    if residual is not None:
        y = y + (residual if out is None else residual[..., co_off:co_off + co])
    if relu:
        y = torch.relu(y)
    if out is None:
        return y.contiguous()
    out[..., co_off:co_off + co] = y
    return out


def _check(x: torch.Tensor, p: Packed, out: torch.Tensor | None, co_off: int, relu: bool,
           residual: torch.Tensor | None) -> None:
    if x.dim() != 4:
        raise ValueError("x must be (B, H, W, Cin), channels last")
    cin, N = x.shape[3], p.w.shape[0]
    if p.w.shape != (N, p.ks * p.ks * cin) or p.scale.shape != (N,) or p.shift.shape != (N,):
        raise ValueError(f"packed weights {tuple(p.w.shape)} do not match Cin={cin}, "
                         f"ks={p.ks}")
    if N % (p.up * p.up):
        raise ValueError(f"N={N} is not a multiple of up^2={p.up * p.up}")
    tensors = (x, p.w, p.scale, p.shift) + tuple(t for t in (out, residual) if t is not None)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"dense_conv takes f32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError("dense_conv's inputs and output must be contiguous")
    Ho, Wo = out_grid(x, p)
    want = (x.shape[0], Ho * p.up, Wo * p.up)
    co = N // (p.up * p.up)
    if out is not None:
        if out.dim() != 4 or tuple(out.shape[:3]) != want or not 0 <= co_off <= out.shape[3] - co:
            raise ValueError(f"out {tuple(out.shape)} cannot take {want} x {co} channels "
                             f"at {co_off}")
    if residual is not None:
        shape = want + (co,) if out is None else tuple(out.shape)
        if tuple(residual.shape) != shape:
            raise ValueError(f"residual {tuple(residual.shape)} is not the output's {shape}")
        if not relu:
            raise ValueError("a residual is added before the ReLU: relu=False takes none")
    if x.is_cuda:
        ldo = co if out is None else out.shape[3]
        if cin % BK or N % 64 or co % 2 or co_off % 2 or ldo % 2:
            raise ValueError(f"the kernel takes Cin % {BK} == 0, N % 64 == 0 and even "
                             f"channel counts and offsets: Cin={cin}, N={N}, co_off={co_off}, "
                             f"ldo={ldo}")
        if (residual is not None or not relu) and N % 128:
            raise ValueError(f"the kernel's residual and ReLU-free epilogues take N % 128 == 0, "
                             f"not N={N}")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


@functools.cache
def _lib():
    from .build import library

    lib = library("dense_conv")
    lib.dense_conv_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 14
                                      + [ctypes.c_void_p])
    lib.dense_conv_launch.restype = ctypes.c_int
    lib.dense_conv_tile_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dense_conv_tile_rows.restype = ctypes.c_int
    return lib


def tile_rows(M: int, N: int) -> int:
    """The output rows of the kernel's tile for M pixels and N columns on
    this card: 128 where that makes a full wave of blocks, else 64."""
    return _lib().dense_conv_tile_rows(M, N)


def dense_conv(x: torch.Tensor, p: Packed, out: torch.Tensor | None = None,
               co_off: int = 0, relu: bool = True,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    refuse_autograd("dense_conv", x, p.w, p.scale, p.shift, residual)
    _check(x, p, out, co_off, relu, residual)
    if not x.is_cuda:
        return dense_conv_plain(x, p, out, co_off, relu, residual)
    B, H, W, cin = x.shape
    Ho, Wo = out_grid(x, p)
    N = p.w.shape[0]
    if out is None:
        out = torch.empty((B, Ho * p.up, Wo * p.up, N // (p.up * p.up)), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    res = None if residual is None else _ptr(residual)
    err = _lib().dense_conv_launch(_ptr(x), _ptr(p.w), _ptr(p.scale), _ptr(p.shift), _ptr(out),
                                   res, int(relu), B, H, W, cin, Ho, Wo, p.ks, p.stride, p.pad,
                                   N, p.up, out.shape[3], co_off, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dense_conv launch failed: CUDA error {err}")
    dense_conv.launches += 1
    profiler.count("neck.kernel_convs", 1)
    return out


dense_conv.launches = 0
