"""Sparse 3D tensors and their index builders: the port of
shasta_tpu/ops/sparse.py.

A sparse tensor is a fixed-capacity set of rows: features (V, C), coords
(V, 4) int32 [b, z, y, x] and a validity mask. Positions encode to int32
linear keys with a per-frame stride of Z*Y*X+1, so each frame owns one
filler key that real queries never hit (invalid rows map to it).

Neighbours reach the conv kernels in one of two forms:
- `Rulebook`: an (M, K) int32 table of input rows, -1 for a miss, built on
  the host (shasta_tpu_torch/plans.py) for the C_in <= 32 stages;
- `KeyedIndex`: the input rows' sorted keys with their argsort and the
  (M, K) query keys, resolved by binary search inside the conv kernel for
  the C_in >= 64 stages.
Both are exact for any physical row order.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..plans import tap_offsets
from .kernels.block_conv import rulebook_conv
from .kernels.window_conv import SENTINEL, keyed_conv


class SparseTensor(NamedTuple):
    feats: torch.Tensor  # (V, C) float
    coords: torch.Tensor  # (V, 4) int32 [b, z, y, x]
    valid: torch.Tensor  # (V,) bool
    shape: tuple  # (Z, Y, X)
    batch_size: int


class Rulebook(NamedTuple):
    nbr: torch.Tensor  # (M, K) int32 input rows, -1 = miss


class KeyedIndex(NamedTuple):
    sorted_keys: torch.Tensor  # (V,) int32 ascending
    perm: torch.Tensor  # (V,) int32: sorted position -> physical row
    queries: torch.Tensor  # (M, K) int32 keys, SENTINEL = no neighbour


def encode_keys(coords: torch.Tensor, valid: torch.Tensor, shape,
                batch_size: int) -> torch.Tensor:
    """(V,) int32 linear keys; invalid rows take their frame's filler key."""
    Z, Y, X = shape
    cells = Z * Y * X
    stride = cells + 1
    assert (batch_size + 1) * stride < 2**31, "grid too large for int32 keys"
    c = coords.long()
    key = c[:, 0] * stride + (c[:, 1] * Y + c[:, 2]) * X + c[:, 3]
    filler = c[:, 0].clamp(0, batch_size) * stride + cells
    return torch.where(valid, key, filler).to(torch.int32)


def key_table(st: SparseTensor):
    """(sorted keys, perm) of the tensor's rows; the stable sort keeps the
    first physical occurrence of a duplicate key first."""
    keys = encode_keys(st.coords, st.valid, st.shape, st.batch_size)
    perm = torch.argsort(keys, stable=True)
    return keys[perm], perm.to(torch.int32)


def _query_keys(b, zyx, in_range, shape):
    Z, Y, X = shape
    cell = (zyx[..., 0] * Y + zyx[..., 1]) * X + zyx[..., 2]
    key = b[:, None] * (Z * Y * X + 1) + cell
    return torch.where(in_range, key, SENTINEL).to(torch.int32)


def subm_queries(st: SparseTensor, kernel: Sequence[int] = (3, 3, 3)) -> torch.Tensor:
    """(V, K) int32 neighbour keys of a submanifold conv (ops/sparse.py:167-182);
    SENTINEL where the tap leaves the grid or the row is padding."""
    off = torch.as_tensor(tap_offsets(kernel, True), device=st.coords.device)
    c = st.coords.long()
    n = c[:, None, 1:4] + off[None]
    dims = torch.tensor(st.shape, device=n.device)
    in_range = ((n >= 0) & (n < dims)).all(-1) & st.valid[:, None]
    return _query_keys(c[:, 0], n, in_range, st.shape)


def strided_queries(out_coords: torch.Tensor, out_valid: torch.Tensor,
                    in_shape, kernel, stride, padding) -> torch.Tensor:
    """(M, K) int32 input keys of a strided conv at in = o*s + k - p
    (ops/sparse.py:612-624); SENTINEL outside the grid or on padding rows."""
    off = torch.as_tensor(tap_offsets(kernel, False), device=out_coords.device)
    s = torch.tensor(stride, device=off.device)
    p = torch.tensor(padding, device=off.device)
    c = out_coords.long()
    ic = c[:, None, 1:4] * s + off[None] - p
    dims = torch.tensor(in_shape, device=off.device)
    in_range = ((ic >= 0) & (ic < dims)).all(-1) & out_valid[:, None]
    return _query_keys(c[:, 0], ic, in_range, in_shape)


def strided_out_shape(in_shape, kernel, stride, padding):
    return tuple((n + 2 * p - k) // s + 1
                 for n, k, s, p in zip(in_shape, kernel, stride, padding))


def decode_strided_keys(out_keys: torch.Tensor, in_shape, kernel, stride,
                        padding, batch_size: int):
    """(max_out,) ascending keys with SENTINEL pads -> (coords (max_out, 4),
    valid, out_shape); invalid rows get b = batch_size (ops/sparse.py:546-571)."""
    OZ, OY, OX = strided_out_shape(in_shape, kernel, stride, padding)
    s_out = OZ * OY * OX + 1
    valid = out_keys != SENTINEL
    k = torch.where(valid, out_keys, 0).long()
    rem = k % s_out
    ox = rem % OX
    rem = rem // OX
    oy = rem % OY
    oz = rem // OY
    ob = torch.where(valid, k // s_out, batch_size)
    zero = torch.zeros_like(k)
    coords = torch.stack([ob, torch.where(valid, oz, zero),
                          torch.where(valid, oy, zero),
                          torch.where(valid, ox, zero)], dim=1).to(torch.int32)
    return coords, valid, (OZ, OY, OX)


def sparse_conv(feats: torch.Tensor, index, weight: torch.Tensor,
                compute_dtype=None) -> torch.Tensor:
    """One sparse conv, (M, Co) f32: inputs rounded to `compute_dtype`
    (None keeps f32), products accumulated in f32."""
    dt = compute_dtype or feats.dtype
    f = feats.to(dt).contiguous()
    w = weight.to(dt).contiguous()
    if isinstance(index, Rulebook):
        return rulebook_conv(f, index.nbr, w)
    return keyed_conv(index.sorted_keys, index.perm, index.queries, f, w)


def to_dense(st: SparseTensor) -> torch.Tensor:
    """Scatter to dense (B, Z, Y, X, C) (spconv .dense()); invalid rows
    land in a spare row that is cut off."""
    Z, Y, X = st.shape
    B, C = st.batch_size, st.feats.shape[1]
    c = st.coords.long()
    flat = ((c[:, 0] * Z + c[:, 1]) * Y + c[:, 2]) * X + c[:, 3]
    n = B * Z * Y * X
    flat = torch.where(st.valid, flat, n)
    dense = st.feats.new_zeros((n + 1, C))
    dense[flat] = st.feats
    return dense[:n].view(B, Z, Y, X, C)


def masked_batch_norm(feats, valid, scale, bias, mean, var, eps: float = 1e-3):
    """BatchNorm1d inference transform over valid rows (scn.py BN1d)."""
    inv = scale * torch.rsqrt(var + eps)
    out = (feats - mean) * inv + bias
    return torch.where(valid[:, None], out, 0.0)
