"""The plain reference of DSVT-P's trunk under ShaSTA's head, in float32
PyTorch with TF32 off, written from the description of DSVT (Wang et al.,
"DSVT: Dynamic Sparse Voxel Transformer with Rotated Sets", CVPR 2023,
arXiv 2301.06051; github.com/Haiyang-W/DSVT, its nuScenes pillar model
under TransFusion-L) over a flat dict of weights under the port's names
(OpenPCDet's, under dsvt.*, neck.* and shared_conv.*):

- the reader, OpenPCDet's DynamicPillarVFE (USE_NORM, USE_ABSLOTE_XYZ, no
  distance): the rows whose floor(((x, y) - pc_start) / voxel size) lies on
  the grid, each in that pillar (z not filtered); the pillars by
  `torch.unique` of y * nx + x; each point's 11 features (its 5 channels,
  xyz minus its pillar's mean, xyz minus the pillar's centre, whose z is
  the middle of z_range); each PFNLayerV2 a Linear without bias, BN1d
  (eps 1e-3), ReLU and the max over the pillar's points, every layer but
  the last at half its listed width and concatenated with that max;
- the partition, DSVT's get_window_coors and get_set_single_shift at each
  shift (0 and the half window): window = (coordinate + shift) // w, the
  windows in ascending x, then y; in each, its n pillars in two orders
  ((y, x) and (x, y) of the in-window coordinates), S = ceil(n / K) sets,
  slot k of set j the pillar at floor((K j + k) n / (K S)) of the order
  (Eq. 3), window by window; slot k > 0 masked where it repeats slot k - 1;
- each encoder layer: X = F[slots], attention of q = k = X + P[slots], v =
  X, per head softmax((q k^T) / sqrt(d)) over the unmasked keys, in- and
  out-projections with bias; each pillar's attention output from its
  first slot in set-major order (the least flat slot position holding it);
  then LN1(F + A), LN2(G + W2 GELU(W1 G + b1) + b2), LN(H + F);
- block b at shift b mod 2, partition 0 then 1, partition i's position
  embedding from block b's MLP of shift i (Linear, BN1d eps 1e-5, ReLU,
  Linear) on shift i's in-window (x - w/2, y - w/2); LN_b(block(F) + F);
- the canvas: each pillar's features at its (y, x) cell;
- OpenPCDet's BaseBEVResBackbone: per level a BasicBlock with a 1x1
  downsample branch (conv, BN: no ReLU) and layer_nums BasicBlocks
  (conv3x3-BN-ReLU, conv3x3-BN, + identity, ReLU; BN eps 1e-3); deblocks
  with BN and ReLU (upsample stride >= 1: a transposed conv of kernel and
  stride s; below 1: a conv of kernel and stride 1 / s), concatenated;
- TransFusion-L's shared conv: a 3x3 conv without bias, BN or ReLU;
- box points and bilinear sampling as model.py has them.

The convs are model.py's direct convolutions (patches times the weight
matrix). Departures from DSVT's code: the first-slot rule fixes the pillar
whose output DSVT's flip-and-scatter leaves to the scatter's order. There
is no pillar capacity: every pillar is kept, and `counts` records each
frame's pillars for the comparison with the program's capacity.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from . import model as rm
from .pipelines import Trunk as _SparseTrunk


def trunk_spec(m: dict) -> OrderedDict:
    """The trunk's weights (shapes and draws) of a configuration's model
    keys: the reader, the position MLPs, the blocks, the neck, the shared
    conv."""
    spec: OrderedDict = OrderedDict()
    d, ffn = m["dsvt_d_model"], m["dsvt_ffn"]
    widths = [m["num_input_features"] + 6, *m["pfn_filters"]]
    for i in range(len(widths) - 1):
        units = widths[i + 1] if i + 2 == len(widths) else widths[i + 1] // 2
        spec[f"dsvt.vfe.pfn_layers.{i}.linear.weight"] = ((units, widths[i]), "weight")
        rm._bn(spec, f"dsvt.vfe.pfn_layers.{i}.norm", units)
    for b in range(m["dsvt_blocks"]):
        for s in range(2):
            p = f"dsvt.input_layer.posembed_layers.{b}.{s}.position_embedding_head"
            rm._lin(spec, p + ".0", 2, d)
            rm._bn(spec, p + ".1", d)
            rm._lin(spec, p + ".3", d, d)
    for b in range(m["dsvt_blocks"]):
        for i in range(2):
            p = f"dsvt.stage_0.{b}.encoder_list.{i}"
            spec[p + ".win_attn.self_attn.in_proj_weight"] = ((3 * d, d), "weight")
            spec[p + ".win_attn.self_attn.in_proj_bias"] = ((3 * d,), "bias")
            rm._lin(spec, p + ".win_attn.self_attn.out_proj", d, d)
            rm._lin(spec, p + ".win_attn.linear1", d, ffn)
            rm._lin(spec, p + ".win_attn.linear2", ffn, d)
            for n in ("win_attn.norm1", "win_attn.norm2", "norm"):
                _ln(spec, f"{p}.{n}", d)
    for b in range(m["dsvt_blocks"]):
        _ln(spec, f"dsvt.residual_norm_stage_0.{b}", d)
    ins = [m["neck_input_features"], *m["ds_num_filters"][:-1]]
    for i, (n, c) in enumerate(zip(m["layer_nums"], m["ds_num_filters"])):
        for j in range(n + 1):
            p = f"neck.blocks.{i}.{j}"
            ci = ins[i] if j == 0 else c
            spec[p + ".conv1.weight"] = ((c, ci, 3, 3), "weight")
            rm._bn(spec, p + ".bn1", c)
            spec[p + ".conv2.weight"] = ((c, c, 3, 3), "weight")
            rm._bn(spec, p + ".bn2", c)
            if j == 0:
                spec[p + ".downsample_layer.0.weight"] = ((c, ci, 1, 1), "weight")
                rm._bn(spec, p + ".downsample_layer.1", c)
        s, u = m["us_layer_strides"][i], m["us_num_filters"][i]
        if s >= 1:
            spec[f"neck.deblocks.{i}.0.weight"] = ((c, u, int(s), int(s)), "deconv")
        else:
            k = int(round(1 / s))
            spec[f"neck.deblocks.{i}.0.weight"] = ((u, c, k, k), "weight")
        rm._bn(spec, f"neck.deblocks.{i}.1", u)
    spec["shared_conv.0.weight"] = ((m["share_conv_channel"], sum(m["us_num_filters"]), 3, 3),
                                    "weight")
    return spec


def _ln(spec, p, c):
    spec[p + ".weight"] = ((c,), "bn_weight")
    spec[p + ".bias"] = ((c,), "bias")


def _bn1d(x, sd, p, eps):
    return F.batch_norm(x, sd[p + ".running_mean"], sd[p + ".running_var"], sd[p + ".weight"],
                        sd[p + ".bias"], False, 0.0, eps)


def _layer_norm(x, sd, p):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], 1e-5)


def _lin(x, sd, p, bias=True):
    y = x @ sd[p + ".weight"].t()
    return y + sd[p + ".bias"] if bias else y


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def pillars(sd: dict, rows: torch.Tensor, m: dict) -> tuple[torch.Tensor, torch.Tensor, int]:
    """One frame's valid rows (N, 5) -> (each pillar's features (M, C), its
    cell (M, 2) [y, x], the rows on the grid), pillars in ascending y * nx + x."""
    (x0, y0), (vx, vy), (_, ny, nx) = m["pc_start"], m["voxel_size"], m["grid_shape"]
    z0, z1 = m["z_range"]
    dev = rows.device
    lo = torch.tensor([x0, y0], dtype=torch.float32, device=dev)
    vs = torch.tensor([vx, vy], dtype=torch.float32, device=dev)
    cell = torch.floor((rows[:, :2] - lo) / vs)
    on = (cell[:, 0] >= 0) & (cell[:, 1] >= 0) & (cell[:, 0] < nx) & (cell[:, 1] < ny)
    rows, cell = rows[on], cell[on].long()
    key = cell[:, 1] * nx + cell[:, 0]
    keys, inv = torch.unique(key, return_inverse=True)
    M = len(keys)
    count = torch.zeros(M, device=dev).index_add_(0, inv, torch.ones(len(rows), device=dev))
    mean = torch.zeros((M, 3), device=dev).index_add_(0, inv, rows[:, :3]) / count[:, None]
    centre = torch.stack([cell[:, 0].float() * vx + (vx / 2 + x0),
                          cell[:, 1].float() * vy + (vy / 2 + y0),
                          torch.full((len(rows),), (z1 - z0) / 2 + z0, device=dev)], 1)
    x = torch.cat([rows[:, :5], rows[:, :3] - mean[inv], rows[:, :3] - centre], 1)
    n_layers = len(m["pfn_filters"])
    for i in range(n_layers):
        p = f"dsvt.vfe.pfn_layers.{i}"
        h = torch.relu(_bn1d(_lin(x, sd, p + ".linear", False), sd, p + ".norm", 1e-3))
        top = torch.full((M, h.shape[1]), -math.inf, device=dev).scatter_reduce(
            0, inv[:, None].expand_as(h), h, "amax")
        x = top if i + 1 == n_layers else torch.cat([h, top[inv]], 1)
    return x, torch.stack([keys // nx, keys % nx], 1), len(rows)


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------

def partition(yx: torch.Tensor, m: dict, shift: int) -> tuple[list, list, torch.Tensor]:
    """One frame's pillars at one shift -> ([the two orders' slots (S, K)],
    [their key masks (S, K)], the in-window (x - w/2, y - w/2) (M, 2))."""
    W, K = m["dsvt_window"], m["dsvt_set_size"]
    nwy = math.ceil(m["grid_shape"][1] / W) + 1
    sy, sx = yx[:, 0] + shift, yx[:, 1] + shift
    win = (sx // W) * nwy + sy // W
    iy, ix = sy % W, sx % W
    orders = ([], [])
    for w in torch.unique(win).tolist():
        members = torch.nonzero(win == w)[:, 0]
        n = len(members)
        S = -(-n // K)
        at = torch.arange(S * K, device=yx.device)
        for o, key in enumerate((iy * W + ix, ix * W + iy)):
            ordered = members[torch.argsort(key[members])]
            orders[o].append(ordered[(at * n) // (S * K)].view(S, K))
    slots = [torch.cat(o) for o in orders]
    masks = []
    for s in slots:
        mask = torch.zeros_like(s, dtype=torch.bool)
        mask[:, 1:] = s[:, 1:] == s[:, :-1]
        masks.append(mask)
    return slots, masks, torch.stack([ix, iy], 1).float() - W / 2


def first_slots(slots: torch.Tensor, M: int) -> torch.Tensor:
    """Each pillar's first slot, the least flat position of set-major order
    that holds it."""
    flat = slots.reshape(-1)
    at = torch.arange(len(flat), device=flat.device)
    return torch.full((M,), len(flat), dtype=torch.long, device=flat.device).scatter_reduce(
        0, flat, at, "amin")


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def attention(sd: dict, p: str, q_in, v_in, mask, heads: int) -> torch.Tensor:
    """Multi-head attention over sets (S, K, C), masked keys left out."""
    S, K, C = q_in.shape
    d = C // heads
    w, b = sd[p + ".in_proj_weight"], sd[p + ".in_proj_bias"]
    q = (q_in @ w[:C].t() + b[:C]).view(S, K, heads, d)
    k = (q_in @ w[C:2 * C].t() + b[C:2 * C]).view(S, K, heads, d)
    v = (v_in @ w[2 * C:].t() + b[2 * C:]).view(S, K, heads, d)
    logits = torch.einsum("sqhd,skhd->shqk", q, k) / math.sqrt(d)
    logits = logits.masked_fill(mask[:, None, None, :], -math.inf)
    out = torch.einsum("shqk,skhd->sqhd", torch.softmax(logits, -1), v).reshape(S, K, C)
    return _lin(out, sd, p + ".out_proj")


def encoder(sd: dict, p: str, x, slots, mask, pos, heads: int) -> torch.Tensor:
    X = x[slots]
    a = attention(sd, p + ".win_attn.self_attn", X + pos[slots], X, mask, heads)
    a = a.reshape(-1, x.shape[1])[first_slots(slots, len(x))]
    g = _layer_norm(x + a, sd, p + ".win_attn.norm1")
    h = _lin(F.gelu(_lin(g, sd, p + ".win_attn.linear1")), sd, p + ".win_attn.linear2")
    h = _layer_norm(g + h, sd, p + ".win_attn.norm2")
    return _layer_norm(h + x, sd, p + ".norm")


def position(sd: dict, p: str, xy: torch.Tensor) -> torch.Tensor:
    p += ".position_embedding_head"
    h = torch.relu(_bn1d(_lin(xy, sd, p + ".0"), sd, p + ".1", 1e-5))
    return _lin(h, sd, p + ".3")


def blocks(sd: dict, x: torch.Tensor, yx: torch.Tensor, m: dict) -> tuple[torch.Tensor, list]:
    """The DSVT stage over one frame's pillars -> (features, per shift the
    number of sets)."""
    parts = [partition(yx, m, s) for s in (0, m["dsvt_shift"])]
    for b in range(m["dsvt_blocks"]):
        slots, masks, _ = parts[b % 2]
        y = x
        for i in range(2):
            pos = position(sd, f"dsvt.input_layer.posembed_layers.{b}.{i}", parts[i][2])
            y = encoder(sd, f"dsvt.stage_0.{b}.encoder_list.{i}", y, slots[i], masks[i], pos,
                        m["dsvt_heads"])
        x = _layer_norm(y + x, sd, f"dsvt.residual_norm_stage_0.{b}")
    return x, [len(p[0][0]) for p in parts]


# ---------------------------------------------------------------------------
# the neck and the shared conv
# ---------------------------------------------------------------------------

def _conv_bn(x, sd, p, bn, stride=1, pad=1):
    return rm._bn2d(rm.conv2d(x, sd[p + ".weight"], stride, pad), sd, bn, 1e-3)


def neck(sd: dict, x: torch.Tensor, m: dict) -> torch.Tensor:
    """BaseBEVResBackbone and the plain shared conv of (1, C, ny, nx) ->
    (1, H, W, share_conv_channel)."""
    ups = []
    for i, (n, stride) in enumerate(zip(m["layer_nums"], m["ds_layer_strides"])):
        for j in range(n + 1):
            p, s = f"neck.blocks.{i}.{j}", stride if j == 0 else 1
            h = torch.relu(_conv_bn(x, sd, p + ".conv1", p + ".bn1", s))
            h = _conv_bn(h, sd, p + ".conv2", p + ".bn2")
            ident = (_conv_bn(x, sd, p + ".downsample_layer.0", p + ".downsample_layer.1", s, 0)
                     if j == 0 else x)
            x = torch.relu(h + ident)
        d, s = f"neck.deblocks.{i}", m["us_layer_strides"][i]
        w = sd[d + ".0.weight"]
        if s == 1:
            up = torch.einsum("ihw,io->ohw", x[0], w[:, :, 0, 0])[None]
        elif s > 1:
            if int(s) != 2:
                raise ValueError(f"the reference's transposed conv is 2x2 at stride 2, not {s}")
            up = rm.deconv2x2(x, w)
        else:
            up = rm.conv2d(x, w, int(round(1 / s)), 0)
        ups.append(torch.relu(rm._bn2d(up, sd, d + ".1", 1e-3)))
    x = rm.conv2d(torch.cat(ups, 1), sd["shared_conv.0.weight"], 1, 1)
    return x.permute(0, 2, 3, 1)


class Trunk(_SparseTrunk):
    """The DSVT-P trunk's weights and geometry, as pipelines.Trunk for the
    sparse one: `bev(frame)` -> (H, W, C) from the frame's rows `cloud` and
    mask `cloud_valid`, `features(bev, boxes)`; per frame `counts` (its
    pillars) and `sets` (its sets at each shift)."""

    def __init__(self, sd: dict, model_cfg: dict, device):
        super().__init__(sd, model_cfg, device)
        self.counts: list = []

    def pillars(self, frame: dict):
        valid = torch.as_tensor(np.asarray(frame["cloud_valid"]), device=self.dev).bool()
        rows = torch.as_tensor(np.asarray(frame["cloud"]), device=self.dev)[valid]
        return pillars(self.sd, rows, self.cfg)

    def bev(self, frame: dict) -> torch.Tensor:
        m = self.cfg
        feats, yx, _ = self.pillars(frame)
        self.counts.append(len(feats))
        feats, sets = blocks(self.sd, feats, yx, m)
        self.sets.append(sets)
        ny, nx = m["grid_shape"][1:]
        canvas = feats.new_zeros((feats.shape[1], ny * nx))
        canvas[:, yx[:, 0] * nx + yx[:, 1]] = feats.t()
        return neck(self.sd, canvas.view(1, -1, ny, nx), m)[0]
