"""block_extract: the port of the TPU kernel `_variant_kernel`
(tools/probe_block_conv.py:43, launched by `_call` :108-129), the
block-extraction conv of the variant probe.

    block_extract(q (Mp, 3G) int32, bases (T, G) int32, sg1, sg2 (NBr, NBWL)
                  int32, k2q (NBP, 8H) f32, f2 (NBP, 128) f32,
                  w (G, 3, 128, Wc) f32, *, H, C, tile, variant) -> (Mp, C) f32

Row m reads bases[m // tile, g]. Per row and group g the function finds the
guard windows j that hold a = q[m, 3g+1] - 1 (sg1[r, j] < a <= sg2[r, j]),
sums the f2 and k2q rows r*GB + j of those windows, and adds a per-variant
product to the row (csrc/block_extract.cu states it in full). The five
variants are the probe's: ohonly, extract, nokeys, noselect, full.

The CUDA kernel computes that directly, with no one-hot matmul: a block
owns 64 rows of one tile (128 for ohonly), stages the tile's guard window
and w[g] slice in shared memory, builds each row's hit words, adds the hit
rows into a shared operand tile and multiplies it by the w slice, each
thread 16 columns of one row in registers. What bounds it on the H100:
the operations (the weight product's FLOPs, the guard compares on the
int32 pipe, the adds per hit, the key compares and selects), not the
bytes.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .block_conv import _ptr

GB = 16  # guard rows per base step (shasta_tpu/ops/pallas/block_conv.py:64)
F = 128  # feature lanes of f2
VARIANTS = ("ohonly", "extract", "nokeys", "noselect", "full")


def window_start(start: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """The start of a `size`-row window of an n-row array as the TPU
    kernel's dynamic slices read it (Pallas interpret mode): a negative
    start counts from the end, then the start is clamped so that the
    window fits."""
    return torch.where(start < 0, start + n, start).clamp(0, n - size)


def block_extract_plain(q, bases, sg1, sg2, k2q, f2, w, *, H: int, C: int,
                        tile: int, variant: str) -> torch.Tensor:
    """The same function in PyTorch: the window find as a mask, the sums of
    the hit rows as one batched product per group over each tile's window."""
    Mp, K = q.shape
    G, T, (NBr, NBWL) = K // 3, Mp // tile, sg1.shape
    H2 = 2 * H
    win = torch.arange(NBWL, device=q.device)
    out = torch.zeros((Mp, C), dtype=torch.float32, device=q.device)
    for g in range(G):
        base = bases[:, g].long()  # (T,)
        r = window_start(base, NBr, 1)  # the guard row
        a = (q[:, 3 * g + 1] - 1).view(T, tile, 1)
        oh = ((a > sg1[r][:, None]) & ~(a > sg2[r][:, None])).float()  # (T, tile, NBWL)
        if variant == "ohonly":
            out += oh.sum(2).reshape(Mp, 1)
            continue
        # the f2/k2q window's start is clamped on its own
        blk = window_start(base * GB, f2.shape[0], NBWL)[:, None] + win  # (T, NBWL)
        afeat = torch.bmm(oh, f2[blk]).reshape(Mp, F)
        if variant == "extract":
            out += afeat @ w[g, 0, :, :C]
            continue
        parts = afeat[:, :H2 * C].reshape(Mp, H2, C)
        if variant != "nokeys":
            akey = torch.bmm(oh, k2q[blk]).reshape(Mp, 4, H2).to(torch.int32)
        rows = []
        for d in range(3):
            qd = q[:, 3 * g + d]
            if variant == "nokeys":
                rows.append(torch.where((qd > 0)[:, None], parts.sum(1), 0.0))
                continue
            quarters = torch.stack([(qd >> (8 * c)) & 255 for c in range(4)], 1)
            eq = (akey == quarters[:, :, None]).all(1)  # (Mp, 2H)
            if variant == "noselect":
                rows.append(afeat[:, :C] * eq[:, :1].float())
            else:
                rows.append(torch.where(eq[:, :, None], parts, 0.0).sum(1))
        out += torch.cat(rows, 1) @ w[g, 2, :3 * C, :C]
    return out


def check_args(q, bases, sg1, sg2, k2q, f2, w, H, C, tile, variant) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    for name, t, dt in (("q", q, torch.int32), ("bases", bases, torch.int32),
                        ("sg1", sg1, torch.int32), ("sg2", sg2, torch.int32),
                        ("k2q", k2q, torch.float32), ("f2", f2, torch.float32),
                        ("w", w, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError("all inputs must lie on one device")
        if q.is_cuda and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    Mp, K = q.shape
    G = K // 3
    NBr, NBWL = sg1.shape
    if K % 3 or tile < 1 or Mp % tile or tuple(bases.shape) != (Mp // tile, G):
        raise ValueError(f"q {tuple(q.shape)} and bases {tuple(bases.shape)} do not "
                         f"fit tile {tile}")
    if tuple(sg2.shape) != (NBr, NBWL) or k2q.shape[0] != f2.shape[0] \
            or f2.shape[0] < (NBr - 1) * GB + NBWL:
        raise ValueError("sg1/sg2/k2q/f2 shapes disagree")
    if tuple(f2.shape[1:]) != (F,) or tuple(k2q.shape[1:]) != (8 * H,) or 8 * H > 32:
        raise ValueError(f"need f2 (NBP, {F}) and k2q (NBP, 8H) with H <= 4")
    if not (1 <= C <= 32 and 2 * H * C <= F) or w.dim() != 4 \
            or tuple(w.shape[:3]) != (G, 3, F) or w.shape[3] < C:
        raise ValueError(f"w {tuple(w.shape)} does not fit G={G}, C={C}, H={H}")


@functools.cache
def _launch_fn():
    from .build import library

    fn = library("block_extract").block_extract_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_extract(q: torch.Tensor, bases: torch.Tensor, sg1: torch.Tensor,
                  sg2: torch.Tensor, k2q: torch.Tensor, f2: torch.Tensor,
                  w: torch.Tensor, *, H: int, C: int, tile: int,
                  variant: str) -> torch.Tensor:
    check_args(q, bases, sg1, sg2, k2q, f2, w, H, C, tile, variant)
    if not q.is_cuda:
        return block_extract_plain(q, bases, sg1, sg2, k2q, f2, w, H=H, C=C,
                                   tile=tile, variant=variant)
    Mp, K = q.shape
    NBr, NBWL = sg1.shape
    if f2.data_ptr() % 16:
        raise ValueError("f2 must be 16-byte aligned")
    out = torch.empty((Mp, C), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launch_fn()(*(_ptr(t) for t in (q, bases, sg1, sg2, k2q, f2, w, out)),
                       Mp, tile, K // 3, NBr, f2.shape[0], NBWL, H, C, w.shape[3],
                       VARIANTS.index(variant), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"block_extract launch failed: CUDA error {err}")
    block_extract.launches += 1
    return out


block_extract.launches = 0
