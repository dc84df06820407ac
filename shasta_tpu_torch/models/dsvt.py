"""DSVT-P's trunk up to its BEV canvas: OpenPCDet's DynamicPillarVFE and
one stage of DSVT's rotated-set window attention (Wang et al., "DSVT:
Dynamic Sparse Voxel Transformer with Rotated Sets", CVPR 2023, arXiv
2301.06051; github.com/Haiyang-W/DSVT, pcdet/models/backbones_3d/dsvt.py
and vfe/dynamic_pillar_vfe.py), in stock PyTorch ops. Nothing here has a
JAX counterpart: the JAX package has no DSVT trunk.

- The reader (`DynamicPillarVFE`, USE_NORM, USE_ABSLOTE_XYZ, no distance):
  a point is in pillar floor(((x, y) - pc_start) / voxel_size) when that
  lies on the grid (z is not filtered); pillars are compacted into
  `max_pillars` slots a lane in ascending key y * nx + x (dynamic_voxel's
  `segments`), the rest counted as dropped. Each point gets 11 features:
  its 5 channels, xyz minus its pillar's point mean, xyz minus the
  pillar's centre (z: the middle of z_range). Each PFNLayerV2 is Linear
  (no bias), BN1d (eps 1e-3), ReLU and a scatter-max per pillar; every
  layer but the last at half its listed width, concatenated with its
  pillar's max.
- The partition (`set_partition`, DSVT's get_window_coors and
  get_set_single_shift): for a shift s, coordinate + s gives the window
  (// window) and the in-window coordinate (% window); windows are
  numbered lane, then x, then y, as DSVT's batch_win_inds. A window of n
  pillars gets S = ceil(n / K) sets of K slots; in each of two orders of
  its pillars (partition 0: (y, x) order, slots walk along x, DSVT's
  `set_voxel_inds_sorty`; partition 1: (x, y) order, DSVT's `_sortx`),
  slot k of set j holds the pillar at position floor((K j + k) n / (K S))
  (Eq. 3). Slot k > 0 is masked where it repeats slot k - 1. The sets are
  padded to a static count (`set_cap`: no lane can need more), a padded
  set's slots all on row 0, all but its first masked.
- An encoder layer (DSVT_EncoderLayer around SetAttention, post-norm,
  GELU, dropout 0): X = F[slots], A = MHA(q = k = X + pos[slots], v = X,
  the key mask); each pillar takes A from its first slot in set-major
  order (`first_slots`); G = LN1(F + A), H = LN2(G + FFN(G)), out =
  LN3(H + F).
- Block b runs the partitions of shift b mod 2, partition 0 then 1, and
  partition i takes the position embedding of block b's MLP of shift i
  on shift i's in-window coordinates (x - w/2, y - w/2): DSVT's
  DSVTBlock.forward, whose TODO notes the mismatch; kept as published.
  The block's output is LN_b(block(in) + in).

Every shape is fixed by the lanes, the rows and `max_pillars`, and
nothing waits for the card. With `dtype` bf16 the linear layers take bf16
inputs and weights; norms, softmax and the scatter-max run in f32.
The attention's products are f32 matmuls (TF32 off, device.py), not a
fused attention kernel, so they stay f32-accurate.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .dynamic_voxel import _BIG, _on, segments


def _linear(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    if dtype is None:
        return F.linear(x, lin.weight, lin.bias)
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), b).float()


class PFNLayerV2(nn.Module):
    """Linear (no bias) -> BN1d (eps 1e-3) -> ReLU -> scatter-max per
    pillar; not `last`: at half of `out_channels`, each point's features
    concatenated with its pillar's max."""

    def __init__(self, in_channels: int, out_channels: int, last: bool):
        super().__init__()
        self.last = last
        units = out_channels if last else out_channels // 2
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = nn.BatchNorm1d(units, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor, slot: torch.Tensor, slots: int, dtype) -> torch.Tensor:
        """x (N, C_in) point rows, slot (N,) their pillar (`slots`: none).
        Returns (slots + 1, units) maxima (last) or (N, 2 units)."""
        h = torch.relu(self.norm(_linear(x, self.linear, dtype)))
        # ReLU's outputs are >= 0: a max from zeros is the max over the points
        pooled = h.new_zeros((slots + 1, h.shape[1])).scatter_reduce_(
            0, slot[:, None].expand_as(h), h, "amax")
        return pooled if self.last else torch.cat([h, pooled[slot]], 1)


class DynamicPillarVFE(nn.Module):
    def __init__(self, num_filters: Sequence[int] = (128, 128), num_point_features: int = 5):
        super().__init__()
        widths = [num_point_features + 6, *num_filters]
        self.pfn_layers = nn.ModuleList(
            PFNLayerV2(widths[i], widths[i + 1], last=i + 2 == len(widths))
            for i in range(len(num_filters)))


class PositionEmbeddingLearned(nn.Module):
    """Linear 2 -> d, BN1d (eps 1e-5), ReLU, Linear d -> d."""

    def __init__(self, input_channel: int, num_pos_feats: int):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            nn.Linear(input_channel, num_pos_feats), nn.BatchNorm1d(num_pos_feats), nn.ReLU(),
            nn.Linear(num_pos_feats, num_pos_feats))

    def forward(self, xy: torch.Tensor, dtype) -> torch.Tensor:
        lin0, bn, _, lin1 = self.position_embedding_head
        return _linear(torch.relu(bn(_linear(xy, lin0, dtype))), lin1, dtype)


class SetAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        # the parameters' container (in_proj_*, out_proj.*): the products run in `attend`
        self.self_attn = nn.MultiheadAttention(d_model, nhead, batch_first=True)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)


class DSVTEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.win_attn = SetAttention(d_model, nhead, dim_feedforward)
        self.norm = nn.LayerNorm(d_model)


class DSVTBlock(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.encoder_list = nn.ModuleList(
            DSVTEncoderLayer(d_model, nhead, dim_feedforward) for _ in range(2))


class DSVTInputLayer(nn.Module):
    """The position MLPs: posembed_layers[block][shift]."""

    def __init__(self, blocks: int, d_model: int, shifts: int = 2):
        super().__init__()
        self.posembed_layers = nn.ModuleList(
            nn.ModuleList(PositionEmbeddingLearned(2, d_model) for _ in range(shifts))
            for _ in range(blocks))


class Partition(NamedTuple):
    """One shift's two partitions of every lane's pillars."""
    inds: torch.Tensor   # (2, S, K) int64: each slot's pillar row
    mask: torch.Tensor   # (2, S, K) bool: True where the slot repeats the slot before it
    first: torch.Tensor  # (2, P) int64: each pillar's first slot in set-major order (S * K flat)
    pos: torch.Tensor    # (P, 2) f32: the in-window (x - w/2, y - w/2)
    sets: torch.Tensor   # (lanes,) int64: the sets each lane fills


def windows_per_axis(cells: int, window: int) -> int:
    """DSVT's max_num_win: windows along an axis of `cells`, plus one for the shift."""
    return math.ceil(cells / window) + 1


def set_cap(lanes: int, slots: int, grid: Sequence[int], window: int, set_size: int) -> int:
    """Sets that `lanes` lanes of at most `slots` pillars can fill, at most:
    sum over windows of ceil(n / K) <= ceil(slots / K) + windows."""
    ny, nx = grid
    return lanes * (math.ceil(slots / set_size)
                    + windows_per_axis(nx, window) * windows_per_axis(ny, window))


def first_slots(inds: torch.Tensor, rows: int) -> torch.Tensor:
    """Each of `rows` pillars' first slot in set-major order of inds (S, K)
    (an entry of `rows` or more holds none): the least flat position that
    holds it, 0 for a pillar no slot holds. DSVT's flip-and-scatter leaves
    the choice to the scatter's order; this fixes it."""
    flat = inds.reshape(-1)
    n = flat.numel()
    first = torch.full((rows + 1,), n, dtype=torch.int64, device=flat.device).scatter_reduce_(
        0, flat.clamp_max(rows), torch.arange(n, device=flat.device), "amin")[:rows]
    return torch.where(first < n, first, 0)


def set_partition(yx: torch.Tensor, valid: torch.Tensor, lanes: int, shift: int, window: int,
                  set_size: int, grid: Sequence[int]) -> Partition:
    """DSVT's partition of P = lanes * slots pillar rows (yx (P, 2) [y, x]
    int64, valid (P,); row r in lane r // slots) at one shift: the module's
    docstring."""
    P, dev = yx.shape[0], yx.device
    slots, K, W = P // lanes, set_size, window
    ny, nx = grid
    nwx, nwy = windows_per_axis(nx, W), windows_per_axis(ny, W)
    NW = lanes * nwx * nwy
    sy, sx = yx[:, 0] + shift, yx[:, 1] + shift
    iy, ix = sy % W, sx % W
    lane = torch.arange(P, device=dev) // slots
    win = torch.where(valid, (lane * nwx + sx // W) * nwy + sy // W, NW)
    n = torch.zeros(NW + 1, dtype=torch.int64, device=dev).index_add_(
        0, win, torch.ones_like(win))[:NW]
    S = (n + K - 1) // K
    set_end = torch.cumsum(S, 0)
    set_start, win_start = set_end - S, torch.cumsum(n, 0) - n
    cap = set_cap(lanes, slots, grid, W, K)
    j = torch.arange(cap, device=dev)
    w = torch.searchsorted(set_end, j, right=True).clamp_max(NW - 1)
    real = j < set_end[-1]
    nj, Sj = n[w], S[w].clamp_min(1)
    a = K * (j - set_start[w])[:, None] + torch.arange(K, device=dev)
    pos = (win_start[w][:, None] + (a * nj[:, None]) // (K * Sj[:, None])).clamp_max(P - 1)
    inds, firsts = [], []
    for key in (iy * W + ix, ix * W + iy):  # partition 0: (y, x) order; 1: (x, y)
        order = torch.argsort(win * (W * W) + key)
        held = torch.where(real[:, None], order[pos], P)
        firsts.append(first_slots(held, P))
        inds.append(torch.where(held < P, held, 0))
    inds = torch.stack(inds)
    mask = torch.zeros_like(inds, dtype=torch.bool)
    mask[:, :, 1:] = inds[:, :, 1:] == inds[:, :, :-1]
    xy = torch.stack([ix, iy], 1).to(torch.float32) - W / 2
    return Partition(inds, mask, torch.stack(firsts), xy, S.reshape(lanes, -1).sum(1))


def attend(attn: nn.MultiheadAttention, qk: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, dtype) -> torch.Tensor:
    """nn.MultiheadAttention's arithmetic on sets (S, K, C): in-projections
    with bias, heads of C / h, softmax over the unmasked keys, the
    out-projection. Every set keeps its first key."""
    S, K, C = qk.shape
    h = attn.num_heads
    w, b = attn.in_proj_weight, attn.in_proj_bias

    def proj(x, rows):
        if dtype is None:
            y = F.linear(x, w[rows], b[rows])
        else:
            y = F.linear(x.to(dtype), w[rows].to(dtype), b[rows].to(dtype)).float()
        return y.reshape(S, K, -1, C // h).transpose(1, 2)  # (S, h', K, d)

    q, k = proj(qk, slice(0, 2 * C)).split(h, dim=1)
    vv = proj(v, slice(2 * C, 3 * C))
    scores = torch.matmul(q * (C // h) ** -0.5, k.transpose(-1, -2))
    scores = scores.masked_fill(mask[:, None, None, :], float("-inf"))
    out = torch.matmul(torch.softmax(scores, -1), vv).transpose(1, 2).reshape(S, K, C)
    return _linear(out, attn.out_proj, dtype)


def encoder_layer(layer: DSVTEncoderLayer, x: torch.Tensor, part: Partition, i: int,
                  pos: torch.Tensor, dtype) -> torch.Tensor:
    """One DSVT_EncoderLayer over pillar rows x (P, C) on partition i."""
    sa = layer.win_attn
    inds = part.inds[i]
    X = x[inds]
    A = attend(sa.self_attn, X + pos[inds], X, part.mask[i], dtype)
    A = A.reshape(-1, x.shape[1])[part.first[i]]
    g = sa.norm1(x + A)
    h = sa.norm2(g + _linear(F.gelu(_linear(g, sa.linear1, dtype)), sa.linear2, dtype))
    return layer.norm(h + x)


class DSVT(nn.Module):
    """The reader and the DSVT stage, their weights under OpenPCDet's names
    (vfe.*, input_layer.posembed_layers.*, stage_0.*,
    residual_norm_stage_0.*). Geometry: grid (ny, nx) cells of voxel_size
    from pc_start; z_range the pillars' z extent."""

    def __init__(self, num_filters: Sequence[int] = (128, 128), num_point_features: int = 5,
                 d_model: int = 128, nhead: int = 8, dim_feedforward: int = 256,
                 blocks: int = 4, set_size: int = 90, window: int = 30, shift: int = 15,
                 grid: Sequence[int] = (360, 360), pc_start: Sequence[float] = (-54.0, -54.0),
                 voxel_size: Sequence[float] = (0.3, 0.3),
                 z_range: Sequence[float] = (-5.0, 3.0), max_pillars: int = 26000, dtype=None):
        super().__init__()
        self.vfe = DynamicPillarVFE(num_filters, num_point_features)
        self.input_layer = DSVTInputLayer(blocks, d_model)
        self.stage_0 = nn.ModuleList(DSVTBlock(d_model, nhead, dim_feedforward)
                                     for _ in range(blocks))
        self.residual_norm_stage_0 = nn.ModuleList(nn.LayerNorm(d_model) for _ in range(blocks))
        self.shifts, self.set_size, self.window = (0, shift), set_size, window
        self.grid, self.pc_start = tuple(grid), tuple(map(float, pc_start))
        self.voxel_size, self.z_range = tuple(map(float, voxel_size)), tuple(map(float, z_range))
        self.max_pillars, self.dtype = max_pillars, dtype

    def pillars(self, points: torch.Tensor, valid: torch.Tensor):
        """One lane's rows (N, 5) [x, y, z, intensity, lag] and mask (N,)
        -> (features (max_pillars, C), yx (max_pillars, 2) int64, valid
        (max_pillars,), the rows on the grid, the pillars they fill)."""
        P, (ny, nx), dev = self.max_pillars, self.grid, points.device
        (x0, y0), (vx, vy), (z0, z1) = self.pc_start, self.voxel_size, self.z_range
        c = torch.floor((points[:, :2] - _on((x0, y0), points.dtype, dev))
                        / _on((vx, vy), points.dtype, dev))
        on_grid = valid & (c >= 0).all(1) & (c[:, 0] < nx) & (c[:, 1] < ny)
        c = torch.where(on_grid[:, None], c, 0).to(torch.int64)
        key = torch.where(on_grid, c[:, 1] * nx + c[:, 0], _BIG)
        sk, order, head, slot, in_cap = segments(key, P)
        pts = points[order]
        xyz = pts[:, :3]
        cnt = torch.zeros(P + 1, dtype=points.dtype, device=dev).index_add_(
            0, slot, in_cap.to(points.dtype))
        mean = torch.zeros((P + 1, 3), dtype=points.dtype, device=dev).index_add_(
            0, slot, torch.where(in_cap[:, None], xyz, 0.0)) / cnt.clamp_min(1)[:, None]
        kc = torch.where(in_cap, sk, 0)
        center = torch.stack([(kc % nx).to(points.dtype) * vx + (vx / 2 + x0),
                              (kc // nx).to(points.dtype) * vy + (vy / 2 + y0),
                              torch.full_like(xyz[:, 2], (z1 - z0) / 2 + z0)], 1)
        x = torch.cat([pts[:, :5], xyz - mean[slot], xyz - center], 1)
        x = torch.where(in_cap[:, None], x, 0.0)
        for layer in self.vfe.pfn_layers:
            x = layer(x, slot, P, self.dtype)
        slot_key = torch.full((P + 1,), _BIG, dtype=torch.int64, device=dev)
        slot_key[torch.where(head & in_cap, slot, P)] = sk
        pvalid = cnt[:P] > 0
        k = torch.where(pvalid, slot_key[:P], 0)
        return x[:P], torch.stack([k // nx, k % nx], 1), pvalid, on_grid.sum(), head.sum()

    def partitions(self, yx: torch.Tensor, valid: torch.Tensor, lanes: int) -> list[Partition]:
        return [set_partition(yx, valid, lanes, s, self.window, self.set_size, self.grid)
                for s in self.shifts]

    def encode(self, x: torch.Tensor, parts: list[Partition]) -> torch.Tensor:
        """The blocks over pillar rows x (P, C)."""
        dt = self.dtype
        for b, (blk, norm) in enumerate(zip(self.stage_0, self.residual_norm_stage_0)):
            part, y = parts[b % 2], x
            for i, layer in enumerate(blk.encoder_list):
                pos = self.input_layer.posembed_layers[b][i](parts[i].pos, dt)
                y = encoder_layer(layer, y, part, i, pos, dt)
            x = norm(y + x)
        return x
