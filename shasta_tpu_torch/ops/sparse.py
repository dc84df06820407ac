"""Sparse 3D tensors and their index builders: the port of
shasta_tpu/ops/sparse.py.

A sparse tensor is a fixed-capacity set of rows: features (V, C), coords
(V, 4) int32 [b, z, y, x] and a validity mask. Positions encode to int32
linear keys with a per-frame stride of Z*Y*X+1, so each frame owns one
filler key that real queries never hit (invalid rows map to it).

Neighbours reach the conv kernels in one of three forms:
- `Rulebook`: an (M, K) int32 table of input rows, -1 for a miss, built on
  the host (shasta_tpu_torch/plans.py) for the C_in <= 32 stages of the
  B=1 planned step;
- `KeyedIndex`: the input rows' sorted keys with their argsort and the
  (M, K) query keys, resolved by binary search inside the conv kernel for
  the C_in >= 64 stages of that step;
- `NeighborIndex`: the JAX package's (M, K) int32 gather table, V for a
  miss, built on the device by `build_subm_index` / `build_strided_plan`
  through `sorted_lookup` for every stage of the unplanned (scene-batched)
  step.
All are exact for any physical row order.

The unplanned builders take `plain`: True runs every lookup through the
kernel's plain version (a trunk that trains launches no kernel, the JAX
XLA route); `sparse_conv` takes the plain gather-matmul, which autograd
differentiates, whenever its input or weight requires grad. The kernels
have no backward.

Layout of record at B > 1: global, not per lane. The JAX package's Pallas
path compacts each strided output set into per-lane slot budgets
(shasta_tpu/ops/sparse.py:387-470) only so that each lane's table fits
the TPU's VMEM; a binding budget raises a soft flag and serving replays
the scene through the XLA program, whose global front-packed layout
(lane_slots == 1, :471-484) is the result of record. The port computes
that result directly: one output set per stage for all lanes, truncated
at the stage cap, invalid rows at b = batch_size; one binary search over
the globally ascending key table (frames own disjoint key ranges, so it
equals the JAX lane-split search); one kernel launch per lookup and per
conv for all lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import const
from ..plans import tap_offsets
from .kernels.block_conv import rulebook_conv
from .kernels.gather_conv import gather_conv, gather_conv_plain
from .kernels.lookup import SENTINEL, sorted_lookup, sorted_lookup_plain
from .kernels.window_conv import keyed_conv


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


class NeighborIndex(NamedTuple):
    gather: torch.Tensor  # (M, K) int32 input rows, V = miss


class StridedPlan(NamedTuple):
    """Output position set and conv index of one strided conv."""

    coords: torch.Tensor  # (M, 4) int32
    valid: torch.Tensor  # (M,) bool
    index: tuple  # Rulebook | KeyedIndex | NeighborIndex
    out_shape: tuple


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


def key_table_presorted(st: SparseTensor):
    """Key table of a tensor whose rows are already key-sorted with the
    invalid rows at the tail, as every strided output set is: no argsort
    (ops/sparse.py:120-125)."""
    keys = encode_keys(st.coords, st.valid, st.shape, st.batch_size)
    return keys, torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)


def _query_keys(b, zyx, in_range, shape):
    Z, Y, X = shape
    cell = (zyx[..., 0] * Y + zyx[..., 1]) * X + zyx[..., 2]
    key = b[:, None] * (Z * Y * X + 1) + cell
    return torch.where(in_range, key, SENTINEL).to(torch.int32)


def subm_queries(st: SparseTensor, kernel: Sequence[int] = (3, 3, 3)) -> torch.Tensor:
    """(V, K) int32 neighbour keys of a submanifold conv (ops/sparse.py:167-182);
    SENTINEL where the tap leaves the grid or the row is padding."""
    dev = st.coords.device
    c = st.coords.long()
    n = c[:, None, 1:4] + const(tap_offsets(kernel, True), dev)[None]
    dims = const(st.shape, dev)
    in_range = ((n >= 0) & (n < dims)).all(-1) & st.valid[:, None]
    return _query_keys(c[:, 0], n, in_range, st.shape)


def strided_queries(out_coords: torch.Tensor, out_valid: torch.Tensor,
                    in_shape, kernel, stride, padding) -> torch.Tensor:
    """(M, K) int32 input keys of a strided conv at in = o*s + k - p
    (ops/sparse.py:612-624); SENTINEL outside the grid or on padding rows."""
    dev = out_coords.device
    c = out_coords.long()
    ic = (c[:, None, 1:4] * const(stride, dev) + const(tap_offsets(kernel, False), dev)[None]
          - const(padding, dev))
    dims = const(in_shape, dev)
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


def _dx_triples(queries: torch.Tensor, table, V: int, plain: bool = False) -> torch.Tensor:
    """(M, K) gather rows of query keys whose taps come in unit-spaced dx
    triples (kx = 3): the K/3 centre keys go through one triple-mode
    lookup, then the in-range mask kills a ±1 probe that wrapped into a
    neighbouring row (ops/sparse.py:183-193, :532-539)."""
    sorted_keys, perm = table
    lookup = sorted_lookup_plain if plain else sorted_lookup
    out = lookup(sorted_keys, perm, queries[:, 1::3].contiguous(), "triple")
    return torch.where(queries != SENTINEL, out, V)


def build_subm_index(st: SparseTensor, table, plain: bool = False) -> NeighborIndex:
    """(V, 27) gather rows of a 3x3x3 submanifold conv over `table`, the
    tensor's (sorted keys, perm) (ops/sparse.py:147-195)."""
    return NeighborIndex(_dx_triples(subm_queries(st), table, st.coords.shape[0], plain))


def _strided_candidates(st: SparseTensor, kernel, stride, padding):
    """(V*C,) int32 candidate output keys of a strided conv, SENTINEL where
    masked: per axis only the taps k = (in + p) % s + i*s with i <
    ceil(K_a/s) give an integral output (ops/sparse.py:361-385)."""
    dev = st.coords.device
    out_shape = strided_out_shape(st.shape, kernel, stride, padding)
    counts = [-(-k // s) for k, s in zip(kernel, stride)]
    i_grid = np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"),
                      axis=-1).reshape(-1, 3)
    s, p = const(stride, dev), const(padding, dev)
    c = st.coords.long()
    zyx = c[:, 1:4]
    taps = torch.remainder(zyx + p, s)[:, None, :] + const(i_grid, dev) * s
    # exact where kept, negative before the mask: floor division
    o = torch.div(zyx[:, None, :] + p - taps, s, rounding_mode="floor")
    ok = ((taps < const(kernel, dev)).all(-1) & (o >= 0).all(-1)
          & (o < const(out_shape, dev)).all(-1) & st.valid[:, None])
    OZ, OY, OX = out_shape
    cand = c[:, :1] * (OZ * OY * OX + 1) + (o[..., 0] * OY + o[..., 1]) * OX + o[..., 2]
    return torch.where(ok, cand, SENTINEL).to(torch.int32).reshape(-1), out_shape


def strided_output_set(st: SparseTensor, kernel, stride, padding, max_out: int,
                       plain: bool = False):
    """The exact spconv output set of a strided conv (ops/sparse.py:325-543,
    global layout) -> (coords (max_out, 4), valid, out_shape): candidate
    keys, sort, head flags; slot j takes the first sorted position where
    cumsum(head) == j + 1 (an identity-mode lookup), so the set is
    ascending, deduplicated and truncated to the max_out smallest keys."""
    cand, _ = _strided_candidates(st, kernel, stride, padding)
    s = torch.sort(cand).values
    head = (s != torch.cat([s.new_full((1,), -1), s[:-1]])) & (s != SENTINEL)
    ch = torch.cumsum(head, 0, dtype=torch.int32)
    slots = torch.arange(1, max_out + 1, dtype=torch.int32, device=s.device)[:, None]
    lookup = sorted_lookup_plain if plain else sorted_lookup
    pos = lookup(ch, None, slots, "identity")[:, 0].long()
    VC = s.shape[0]
    out_keys = torch.where(pos < VC, s[pos.clamp(max=VC - 1)], SENTINEL)
    return decode_strided_keys(out_keys, st.shape, kernel, stride, padding, st.batch_size)


def build_strided_plan(st: SparseTensor, kernel, stride, padding, max_out: int,
                       table, plain: bool = False) -> StridedPlan:
    """`strided_output_set` and its gather index over `table`, the input's
    (sorted keys, perm)."""
    coords, valid, out_shape = strided_output_set(st, kernel, stride, padding, max_out,
                                                  plain=plain)
    q = strided_queries(coords, valid, st.shape, kernel, stride, padding)
    if kernel[2] == 3:
        gather = _dx_triples(q, table, st.coords.shape[0], plain)
    else:  # the extra conv's (3, 1, 1) kernel
        gather = (sorted_lookup_plain if plain else sorted_lookup)(*table, q, "plain")
    return StridedPlan(coords, valid, NeighborIndex(gather), out_shape)


def sparse_conv(feats: torch.Tensor, index, weight: torch.Tensor,
                compute_dtype=None) -> torch.Tensor:
    """One sparse conv, (M, Co) f32: inputs rounded to `compute_dtype`
    (None keeps f32), products accumulated in f32. An input that requires
    grad (grad mode on) takes gather_conv's plain version, which autograd
    differentiates (a NeighborIndex only)."""
    dt = compute_dtype or feats.dtype
    f = feats.to(dt).contiguous()
    w = weight.to(dt).contiguous()
    if torch.is_grad_enabled() and (f.requires_grad or w.requires_grad):
        if not isinstance(index, NeighborIndex):
            raise ValueError("the differentiable route takes a NeighborIndex")
        return gather_conv_plain(f, index.gather, w)
    if isinstance(index, Rulebook):
        return rulebook_conv(f, index.nbr, w)
    if isinstance(index, NeighborIndex):
        return gather_conv(f, index.gather, w)
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


def masked_batch_stats(feats: torch.Tensor, valid: torch.Tensor, sync: bool = False):
    """Mean and biased variance, E[x^2] - mean^2, over the valid rows
    (ops/sparse.py:716-730). sync: the count, sum and sum of squares are
    first summed over the default process group (the JAX psum over
    bn_axis_name, apex SyncBN in the reference), through the autograd-aware
    all_reduce."""
    m = valid.to(feats.dtype)[:, None]
    parts = torch.cat([m.sum(0), (feats * m).sum(0), (feats * feats * m).sum(0)])
    if sync:
        from torch.distributed.nn.functional import all_reduce

        parts = all_reduce(parts)
    C = feats.shape[1]
    cnt = parts[0].clamp_min(1.0)
    mean = parts[1:C + 1] / cnt
    return mean, parts[C + 1:] / cnt - mean * mean


def masked_batch_norm(feats, valid, scale, bias, mean, var, eps: float = 1e-3):
    """BatchNorm1d inference transform over valid rows (scn.py BN1d)."""
    inv = scale * torch.rsqrt(var + eps)
    out = (feats - mean) * inv + bias
    return torch.where(valid[:, None], out, 0.0)
