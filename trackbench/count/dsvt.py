"""Operations and bytes of DSVT-P's trunk a frame (the dynamic pillar
reader, the DSVT stage, the residual neck and TransFusion-L's shared conv
under ShaSTA's head), from the frame's rows and the configuration's model
keys, with work.py's peaks. Products count 2 FLOPs a multiply-add; bytes
are f32 (int64 for slot indices), each read once and written once.

- the reader: each PFN layer's products over the rows on the grid (N
  rows of `in` features to `units`); bytes: the rows' 5 channels in, each
  layer's point features out and in again, the pillars' features out;
- the partition's gathers, per encoder layer: each of the S * K slots
  reads its pillar's row of F and of the position embedding (d wide) by
  an int64 index;
- an encoder layer over S sets of K slots and P pillars (d wide, h heads,
  FFN f): the in-projections 2 S K d 3d, the scores and the weighted sum 2
  * 2 S K K d (the heads split d), the out-projection 2 S K d d, the FFN 2
  * 2 P d f; bytes: the gathers, F in and the layer's output out (P d
  each), its weights;
- a position MLP (8 a frame: a block's two shifts) over P pillars: 2 P (2
  d + d d); bytes: P d out, its weights;
- the neck's convs and the shared conv, each one launch of the program's
  neck kernel, as count/pillars.py counts the RPN's: a 3x3 or 1x1 conv or
  a k x k stride-k deblock is 2 M K N over its M output pixels, K = taps x
  Cin, N = Cout; a stride-s transposed conv one tap an output pixel.
"""
from __future__ import annotations

import math

import numpy as np

from . import work


def frame_pillars(frame: dict, m: dict) -> tuple[int, np.ndarray]:
    """(the valid rows on the grid, each pillar's cell (M, 2) [y, x] in
    ascending y * nx + x) of a frame's rows, as the reader makes them."""
    (x0, y0), (vx, vy), (_, ny, nx) = m["pc_start"], m["voxel_size"], m["grid_shape"]
    rows = np.asarray(frame["cloud"])[np.asarray(frame["cloud_valid"], bool)]
    cell = np.floor((rows[:, :2] - np.float32([x0, y0])) / np.float32([vx, vy]))
    on = (cell[:, 0] >= 0) & (cell[:, 1] >= 0) & (cell[:, 0] < nx) & (cell[:, 1] < ny)
    cell = cell[on].astype(np.int64)
    keys = np.unique(cell[:, 1] * nx + cell[:, 0])
    return int(on.sum()), np.stack([keys // nx, keys % nx], 1)


def sets(yx: np.ndarray, m: dict, shift: int) -> int:
    """The sets of one shift's partition: the sum over windows of ceil(n / K)."""
    W, K = m["dsvt_window"], m["dsvt_set_size"]
    nwy = math.ceil(m["grid_shape"][1] / W) + 1
    win = ((yx[:, 1] + shift) // W) * nwy + (yx[:, 0] + shift) // W
    n = np.bincount(win)
    return int(((n + K - 1) // K).sum())


def reader(points: int, m: dict) -> dict:
    """The PFN layers' products and bytes over `points` rows."""
    widths = [m["num_input_features"] + 6, *m["pfn_filters"]]
    flops, nbytes = 0.0, 4.0 * points * m["num_input_features"]
    for i in range(len(widths) - 1):
        units = widths[i + 1] if i + 2 == len(widths) else widths[i + 1] // 2
        flops += 2.0 * points * widths[i] * units
        nbytes += 4.0 * (points * (widths[i] + units) + widths[i] * units)
    return dict(flops=flops, bytes=nbytes)


def gathers(n_sets: int, m: dict) -> dict:
    """An encoder layer's gathers: each slot's row of F and of the position
    embedding, by an int64 index."""
    slots, d = n_sets * m["dsvt_set_size"], m["dsvt_d_model"]
    return dict(flops=0.0, bytes=slots * (8.0 + 2 * 4.0 * d))


def encoder_layer(n_sets: int, pillars: int, m: dict) -> dict:
    """One encoder layer's products and bytes (its gathers included)."""
    K, d, f = m["dsvt_set_size"], m["dsvt_d_model"], m["dsvt_ffn"]
    slots = n_sets * K
    flops = (2.0 * slots * d * 3 * d + 2 * 2.0 * n_sets * K * K * d + 2.0 * slots * d * d
             + 2 * 2.0 * pillars * d * f)
    weights = 4 * d * d + 4 * d + 2 * d * f + f + d + 6 * d
    return dict(flops=flops, bytes=gathers(n_sets, m)["bytes"]
                + 4.0 * (2 * pillars * d + weights))


def position_mlp(pillars: int, m: dict) -> dict:
    d = m["dsvt_d_model"]
    return dict(flops=2.0 * pillars * (2 * d + d * d),
                bytes=4.0 * (pillars * (2 + d) + 2 * d + d * d + 6 * d))


def dsvt_parts(pillars: int, n_sets: list, m: dict) -> list[dict]:
    """DSVT's parts a frame: each block's two position MLPs and its two
    encoder layers on the partitions of shift b mod 2 (n_sets: the sets of
    each shift)."""
    out = []
    for b in range(m["dsvt_blocks"]):
        for i in range(2):
            out.append(dict(name=f"block{b}.pos{i}", **position_mlp(pillars, m)))
        for i in range(2):
            out.append(dict(name=f"block{b}.layer{i}",
                            **encoder_layer(n_sets[b % 2], pillars, m)))
    return out


def least_s(parts: list[dict]) -> float:
    """The least time of parts, each its products at the f32 peak or its
    bytes at HBM's rate, whichever is longer."""
    return sum(max(p["flops"] / work.F32_FLOPS_PER_S, p["bytes"] / work.HBM_BYTES_PER_S)
               for p in parts)


def neck_convs(m: dict) -> list[dict]:
    """The residual neck's convs in launch order (each BasicBlock's 1x1
    downsample branch, if any, its two 3x3 convs; each level's deblock)
    and the shared conv: name, output pixels m_out, input pixels m_in,
    cin, cout, taps, FLOPs."""
    H, W = m["grid_shape"][1:]
    cin, out = m["neck_input_features"], []

    def conv(name, h_in, w_in, ci, co, k, s, pad):
        h, w = (h_in + 2 * pad - k) // s + 1, (w_in + 2 * pad - k) // s + 1
        out.append(dict(name=name, m_in=h_in * w_in, m_out=h * w, cin=ci, cout=co, taps=k * k,
                        flops=2.0 * h * w * k * k * ci * co))
        return h, w

    for i, (n, s, c) in enumerate(zip(m["layer_nums"], m["ds_layer_strides"],
                                      m["ds_num_filters"])):
        for j in range(n + 1):
            st = s if j == 0 else 1
            if j == 0:
                conv(f"level{i}.block0.downsample", H, W, cin, c, 1, st, 0)
            h, w = conv(f"level{i}.block{j}.conv1", H, W, cin if j == 0 else c, c, 3, st, 1)
            conv(f"level{i}.block{j}.conv2", h, w, c, c, 3, 1, 1)
            H, W = h, w
        cin = c
        us, u = m["us_layer_strides"][i], m["us_num_filters"][i]
        if us > 1:
            k = int(round(us))
            out.append(dict(name=f"deblock{i}", m_in=H * W, m_out=H * W * k * k, cin=c, cout=u,
                            taps=k * k, flops=2.0 * H * W * k * k * c * u))
            Ho, Wo = H * k, W * k
        else:
            k = int(round(1 / us))
            Ho, Wo = conv(f"deblock{i}", H, W, c, u, k, k, 0)
    conv("shared", Ho, Wo, sum(m["us_num_filters"]), m["share_conv_channel"], 3, 1, 1)
    return out


def frame_work(frame: dict, m: dict) -> dict:
    """A frame's trunk up to the canvas: its rows on the grid, pillars, sets
    per shift, the reader's and DSVT's FLOPs, and DSVT's least time."""
    points, yx = frame_pillars(frame, m)
    n_sets = [sets(yx, m, s) for s in (0, m["dsvt_shift"])]
    parts = dsvt_parts(len(yx), n_sets, m)
    return dict(points=points, pillars=len(yx), sets=n_sets,
                flops=reader(points, m)["flops"] + sum(p["flops"] for p in parts),
                dsvt_least_s=least_s(parts))
