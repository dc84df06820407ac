"""Operations and bytes of a frame's step, from its inputs and the
weights' shapes, and the card's peaks.

- Sparse convs: 2 * hits * Cin * Co FLOPs, hits counted over the active
  sets that the reference builds from the frame's voxels; bytes: each
  input row and each output row once, and the weights, in f32.
- Neck and shared conv: the direct convolutions' FLOPs from their shapes.
- Affinity head: the products of its linear layers (the pairwise MLPs'
  first layer split into its two halves, as the step evaluates it).

Peaks: NVIDIA's data sheet for the H100 SXM at its full 700 W (the port's
shasta_tpu_torch/timing.py): f32-accurate products at three TF32 passes,
495/3 TFLOP/s, and HBM at 3.35 TB/s.
"""
from __future__ import annotations

import math

import torch

from ..reference import model as rm

F32_FLOPS_PER_S = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
# (name, kernel, stride, padding, Cin, Co, residual blocks after it)
STAGES = (("conv2", (3, 3, 3), (2, 2, 2), (1, 1, 1), 16, 32, 2),
          ("conv3", (3, 3, 3), (2, 2, 2), (1, 1, 1), 32, 64, 2),
          ("conv4", (3, 3, 3), (2, 2, 2), (0, 1, 1), 64, 128, 2),
          ("extra_conv", (3, 1, 1), (2, 1, 1), (0, 0, 0), 128, 128, 0))


def _hits(in_set, out_coords, kernel, stride, pad) -> int:
    dev = out_coords.device
    n = 0
    for off in rm._taps(kernel, stride is None):
        off = torch.tensor(off, device=dev)
        src = out_coords + off if stride is None else (
            out_coords * torch.tensor(stride, device=dev) + off - torch.tensor(pad, device=dev))
        n += int((in_set.find(src) >= 0).sum())
    return n


def trunk_convs(coords, valid, grid_shape, nin: int = 5, device="cpu") -> list[dict]:
    """The 21 convs of one frame's trunk: hits, rows in and out, widths.
    coords (V, 3) zyx and valid (V,): the frame's voxel arrays."""
    valid = torch.as_tensor(valid, device=device).bool()
    s = rm._Set(torch.as_tensor(coords, device=device)[valid].long(), grid_shape)
    convs = []

    def subm(s, c, n, name):
        h = _hits(s, s.coords, (3, 3, 3), None, None)
        for j in range(n):
            convs.append(dict(name=f"{name}.{j}", hits=h, m_in=len(s.coords),
                              m_out=len(s.coords), cin=c, cout=c, taps=27))

    h = _hits(s, s.coords, (3, 3, 3), None, None)
    convs.append(dict(name="conv_input", hits=h, m_in=len(s.coords), m_out=len(s.coords),
                      cin=nin, cout=16, taps=27))
    subm(s, 16, 4, "conv1")
    for name, k, st, p, ci, co, nb in STAGES:
        sites, out_shape = rm._strided_sites(s, k, st, p)
        convs.append(dict(name=name, hits=_hits(s, sites, k, st, p), m_in=len(s.coords),
                          m_out=len(sites), cin=ci, cout=co, taps=math.prod(k)))
        s = rm._Set(sites, out_shape)
        subm(s, co, 2 * nb, name + ".blocks")
    return convs


def conv_flops(c: dict) -> float:
    return 2.0 * c["hits"] * c["cin"] * c["cout"]


def conv_bytes(c: dict) -> float:
    return 4.0 * (c["m_in"] * c["cin"] + c["m_out"] * c["cout"] + c["taps"] * c["cin"] * c["cout"])


def conv_least_s(c: dict) -> float:
    """The least time of one conv on the card: its products at the f32 peak
    or its bytes at HBM's rate, whichever is longer."""
    return max(conv_flops(c) / F32_FLOPS_PER_S, conv_bytes(c) / HBM_BYTES_PER_S)


def neck_flops(H: int = 180, W: int = 180, c_in: int = 256, shared: int = 64) -> float:
    """RPN at (H, W) input (two blocks of 1 + 5 3x3 convs, the second at
    stride 2; a 1x1 and a stride-2 2x2 transposed deblock) and the shared
    3x3 conv over the 512 concatenated channels."""
    h2, w2 = H // 2, W // 2
    f = 2 * H * W * 9 * (c_in * 128 + 5 * 128 * 128)
    f += 2 * H * W * 128 * 256
    f += 2 * h2 * w2 * 9 * (128 * 256 + 5 * 256 * 256)
    f += 2 * H * W * 256 * 256  # each output pixel of the deconv takes one tap
    f += 2 * H * W * 9 * 512 * shared
    return float(f)


def dense_flops(model: dict) -> float:
    """The neck's and shared conv's FLOPs at a configuration's BEV size."""
    _, Y, X = model["grid_shape"]
    return neck_flops(Y // model["out_stride"], X // model["out_stride"],
                      shared=model["share_conv_channel"])


def head_flops(n: int, num_feats: int = 3, num_point: int = 5, C: int = 64) -> float:
    """One class's affinity head at max_obj n: the four augmentation MLPs of
    each kind on flattened inputs, and the pairwise MLPs over (n+2)^2 pairs."""
    spec = rm.head_spec(n, num_feats, num_point, C)
    T = n + 2
    f = 0.0
    for name, (shape, kind) in spec.items():
        if not name.endswith(".weight"):
            continue
        out, inp = shape
        if name.startswith(("aug_shape", "aug_dets")):
            f += 2 * out * inp
        elif name.startswith("aff."):
            f += 2 * T * out * inp
        elif name.endswith(".0.weight"):  # a pairwise MLP's first layer, split
            f += 2 * 2 * T * out * inp // 2
        else:
            f += 2 * T * T * out * inp
    return f
