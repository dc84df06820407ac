"""Host-side sparse-conv planner (numpy): the port of shasta_tpu/plans.py.

Every index the narrow stages of the trunk need is an integer function of
the voxel coordinates, which the host holds before upload. The JAX
package packs these indices into PosWords, a 16-bit encoding of the TPU's
128-lane pair-block windows (shasta_tpu/ops/pallas/block_conv.py:22-47).
A Hopper kernel gathers rows by index, so this planner emits the plain
rulebook instead: an (M, 27) int32 table of input rows in (dz, dy, dx)
tap raster order, -1 for a miss. Rows are physical rows for any upload
order (left searchsorted into the sorted keys, mapped back through the
stable argsort), so no window-fit flag exists.

`frame_plans` builds what the backbone reads per frame (the JAX
frame_plans, plans.py:297-360): rulebooks for s0, d1, d1s and d2, and the
strided output keys d1/d2/d3/ex (exact spconv output sets, ascending,
SENTINEL-padded, truncated to the stage caps).
"""
from __future__ import annotations

import numpy as np

from .utils import profiler

SENTINEL = np.int64(np.iinfo(np.int32).max)
_MASK = np.int64(2**62)  # host-internal "no query" marker (int64 domain)


def encode_keys_np(coords: np.ndarray, valid: np.ndarray, shape,
                   batch_size: int) -> np.ndarray:
    """int64 mirror of ops.sparse.encode_keys."""
    Z, Y, X = shape
    cells = Z * Y * X
    stride = cells + 1
    b = coords[:, 0].astype(np.int64)
    cell = ((coords[:, 1].astype(np.int64) * Y + coords[:, 2]) * X
            + coords[:, 3])
    key = b * stride + cell
    filler = np.clip(b, 0, batch_size) * stride + cells
    return np.where(valid, key, filler)


def count_cap(stage: str, demand, kept, max_out: int) -> None:
    """Counts one strided stage's output set against its cap while a
    profiler records: per lane, `trunk.cap.<stage>.demand` (the distinct
    output keys the stage's input makes) and `.kept` (the rows the cap
    keeps, the smallest keys), and `.slots` (the cap, max_out). What the cap
    cut is demand - kept; kept / slots is the share of slots that hold a
    row."""
    profiler.count(f"trunk.cap.{stage}.demand", demand)
    profiler.count(f"trunk.cap.{stage}.kept", kept)
    profiler.count(f"trunk.cap.{stage}.slots", max_out)


def strided_output_keys(coords: np.ndarray, valid: np.ndarray, kernel,
                        stride, padding, max_out: int, in_shape,
                        batch_size: int, stage: str | None = None):
    """Exact spconv output set, ascending by key with SENTINEL padding: the
    parity-restricted candidate enumeration + sorted dedup + smallest-keys
    truncation of ops.sparse.build_strided_plan, bit for bit. A named
    `stage` counts its set against the cap (`count_cap`).

    Returns (out_keys (max_out,) int64 incl. SENTINEL pads, out_shape)."""
    kz, ky, kx = kernel
    sz, sy, sx = stride
    pz, py, px = padding
    Z, Y, X = in_shape
    OZ = (Z + 2 * pz - kz) // sz + 1
    OY = (Y + 2 * py - ky) // sy + 1
    OX = (X + 2 * px - kx) // sx + 1

    b = coords[:, 0].astype(np.int64)
    zyx = coords[:, 1:4].astype(np.int64)
    strides = np.array([sz, sy, sx], np.int64)
    pads = np.array([pz, py, px], np.int64)
    kdims = np.array([kz, ky, kx], np.int64)
    out_dims = np.array([OZ, OY, OX], np.int64)
    counts = [int(np.ceil(k / s)) for k, s in ((kz, sz), (ky, sy), (kx, sx))]
    i_grid = np.stack(
        np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), axis=-1
    ).reshape(-1, 3).astype(np.int64)
    r = (zyx + pads) % strides
    taps = r[:, None, :] + i_grid[None] * strides
    o = (zyx[:, None, :] + pads - taps) // strides
    okm = (np.all(taps < kdims, axis=-1) & np.all(o >= 0, axis=-1)
           & np.all(o < out_dims, axis=-1) & valid[:, None])
    s_out = OZ * OY * OX + 1
    cell_out = (o[..., 0] * OY + o[..., 1]) * OX + o[..., 2]
    cand = b[:, None] * s_out + cell_out
    u = np.unique(cand[okm])
    if stage is not None and profiler.recording():
        lane = u // s_out
        count_cap(stage, np.bincount(lane, minlength=batch_size),
                  np.bincount(lane[:max_out], minlength=batch_size), max_out)
    u = u[:max_out]
    out = np.full((max_out,), SENTINEL, np.int64)
    out[: u.shape[0]] = u
    return out, (OZ, OY, OX)


def decode_out_coords(out_keys: np.ndarray, out_shape, batch_size: int):
    """Key -> coord decode of the strided output set: invalid rows get
    b = batch_size, zyx = 0."""
    OZ, OY, OX = out_shape
    s_out = OZ * OY * OX + 1
    valid = out_keys != SENTINEL
    k = np.where(valid, out_keys, 0)
    rem = k % s_out
    ox = rem % OX
    rem = rem // OX
    oy = rem % OY
    oz = rem // OY
    ob = np.where(valid, k // s_out, batch_size)
    coords = np.stack(
        [ob, np.where(valid, oz, 0), np.where(valid, oy, 0),
         np.where(valid, ox, 0)], axis=1,
    ).astype(np.int32)
    return coords, valid


def tap_offsets(kernel, centered: bool) -> np.ndarray:
    """(K, 3) tap offsets in (dz, dy, dx) raster order."""
    axes = [np.arange(k) - (k // 2 if centered else 0) for k in kernel]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)


def subm_query_keys(coords, valid, shape, batch_size: int) -> np.ndarray:
    """(V, 27) int64 neighbour keys of a 3x3x3 submanifold conv, _MASK
    where the tap leaves the grid or the row is padding."""
    Z, Y, X = shape
    n = coords[:, None, 1:4].astype(np.int64) + tap_offsets((3, 3, 3), True)
    ok = np.all((n >= 0) & (n < np.array(shape)), axis=-1) & valid[:, None]
    key = (coords[:, :1].astype(np.int64) * (Z * Y * X + 1)
           + (n[..., 0] * Y + n[..., 1]) * X + n[..., 2])
    return np.where(ok, key, _MASK)


def strided_query_keys(out_coords, out_valid, kernel, stride, padding,
                       in_shape) -> np.ndarray:
    """(M, K) int64 input keys at in = o*s + k - p, _MASK off-grid/padding."""
    Z, Y, X = in_shape
    ic = (out_coords[:, None, 1:4].astype(np.int64) * np.array(stride)
          + tap_offsets(kernel, False) - np.array(padding))
    ok = np.all((ic >= 0) & (ic < np.array(in_shape)), axis=-1) & out_valid[:, None]
    key = (out_coords[:, :1].astype(np.int64) * (Z * Y * X + 1)
           + (ic[..., 0] * Y + ic[..., 1]) * X + ic[..., 2])
    return np.where(ok, key, _MASK)


def rulebook(keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """(M, K) int32 physical input rows of `queries` in the table whose
    physical row keys are `keys`; -1 for a miss. Left searchsorted over the
    stable-sorted keys: the first physical occurrence of a key wins."""
    perm = np.argsort(keys, kind="stable")
    skeys = keys[perm]
    V = keys.shape[0]
    pos = np.searchsorted(skeys, queries, side="left")
    posc = np.minimum(pos, V - 1)
    hit = (pos < V) & (skeys[posc] == queries) & (queries < _MASK)
    return np.where(hit, perm[posc], -1).astype(np.int32)


def frame_plans(coords3: np.ndarray, valid: np.ndarray, cfg) -> dict:
    """Plans for one B=1 frame. coords3 (V, 3) int [z, y, x] in upload
    order, valid (V,) bool, cfg with grid_shape and the stage caps.
    Returns the arrays the backbone reads, keyed without the "plan_"
    prefix that `attach_plans` adds. `frame_plans.calls` counts the calls
    (no serving step makes one: a frame without plans runs the unplanned
    trunk)."""
    frame_plans.calls += 1
    V = coords3.shape[0]
    coords = np.concatenate(
        [np.zeros((V, 1), np.int32), coords3.astype(np.int32)], axis=1)
    valid = np.asarray(valid, bool)
    shape0 = tuple(cfg.grid_shape)
    keys0 = encode_keys_np(coords, valid, shape0, 1)
    out: dict = {}
    out["s0_rb"] = rulebook(keys0, subm_query_keys(coords, valid, shape0, 1))

    down = ((3, 3, 3), (2, 2, 2), (1, 1, 1))
    d1_keys, d1_shape = strided_output_keys(coords, valid, *down,
                                            cfg.cap_conv2, shape0, 1, "conv2")
    c1, v1 = decode_out_coords(d1_keys, d1_shape, 1)
    out["d1_keys"] = d1_keys.astype(np.int32)
    out["d1_rb"] = rulebook(keys0, strided_query_keys(c1, v1, *down, shape0))
    keys1 = encode_keys_np(c1, v1, d1_shape, 1)
    out["d1s_rb"] = rulebook(keys1, subm_query_keys(c1, v1, d1_shape, 1))

    d2_keys, d2_shape = strided_output_keys(c1, v1, *down, cfg.cap_conv3,
                                            d1_shape, 1, "conv3")
    c2, v2 = decode_out_coords(d2_keys, d2_shape, 1)
    out["d2_keys"] = d2_keys.astype(np.int32)
    out["d2_rb"] = rulebook(keys1, strided_query_keys(c2, v2, *down, d1_shape))

    # C_in >= 64 stages: only the output sets come from the host; their
    # neighbours are found by key inside keyed_conv
    d3_keys, d3_shape = strided_output_keys(
        c2, v2, (3, 3, 3), (2, 2, 2), (0, 1, 1), cfg.cap_conv4, d2_shape, 1, "conv4")
    c3, v3 = decode_out_coords(d3_keys, d3_shape, 1)
    out["d3_keys"] = d3_keys.astype(np.int32)
    ex_keys, _ = strided_output_keys(
        c3, v3, (3, 1, 1), (2, 1, 1), (0, 0, 0), cfg.cap_extra, d3_shape, 1, "extra")
    out["ex_keys"] = ex_keys.astype(np.int32)
    return out


frame_plans.calls = 0


def attach_plans(frame: dict, plans: dict) -> dict:
    """A copy of `frame` with the plan arrays under plan_* keys."""
    out = dict(frame)
    for k, v in plans.items():
        out["plan_" + k] = v
    return out
