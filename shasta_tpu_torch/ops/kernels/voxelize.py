"""voxelize_lanes: many point clouds into fixed-shape voxel grids on the
card, byte for byte what the host voxelizer gives. It replaces no TPU
kernel (the JAX package voxelizes on the host, through the C++ of
`runtime.points_to_voxel`); the scene-batched eval hands it the raw points
of every lane of a step instead of shipping a 24 MB grid a lane.

    voxelize_lanes(points (N, C5) f32, offsets (C + 1,) int on the host,
                   voxel_size, pc_range, max_points, max_voxels,
                   sort_by_key=False, lanes=None (L,) int on the host)
      -> voxels (L, V, P, C5) f32, coords (L, V, 3) int32 zyx,
         num_points (L, V) int32, valid (L, V) bool,  V = max_voxels

Cloud c is points[offsets[c]:offsets[c + 1]] (no padding to the longest
cloud); output lane l holds cloud lanes[l]'s voxels (default: lane c holds
cloud c), so lanes that repeat a cloud share its points and its sort. Each
lane equals `runtime.points_to_voxel` of its cloud followed by
`data.nuscenes.voxelize_frame`'s key sort (where sort_by_key) and zero
padding to max_voxels:
- per axis floor((double)(p - range_min) / (double)voxel_size), the
  subtraction in f32 and the division in f64, the point kept only inside
  the grid on all three axes;
- a voxel keeps its first max_points points in arrival order;
- the cap keeps the max_voxels voxels whose first point arrived earliest
  (unlike `ops.voxelize.points_to_voxel`, which keeps the smallest keys);
- rows in that arrival order, or in ascending zyx key where sort_by_key.

The CUDA kernel (csrc/voxelize.cu) sorts (cloud * G + key, point index)
with a stable LSD radix sort of its own (decoupled look-back), flags each
voxel's first point, ranks the voxels by arrival with a scan in point
order and writes every output byte in one last pass; what bounds it is
bytes (the grids it writes).
`voxelize_lanes_plain` is the same algorithm in PyTorch: a stable
torch.sort, integer scans, f64 division. On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or
raises. Each call counts its clouds under "voxelize.clouds"
(`utils.profiler.count`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ...device import upload
from ...utils.profiler import count
from . import refuse_autograd


def grid_cells(voxel_size, pc_range) -> tuple[int, int, int]:
    """The grid's (x, y, z) cells as the host voxelizer computes them:
    round((range_max - range_min) / voxel_size), the extent in f32, the
    division in f64, halves away from zero."""
    vs = np.asarray(voxel_size, np.float32).astype(np.float64)
    cr = np.asarray(pc_range, np.float32)
    ext = (cr[3:] - cr[:3]).astype(np.float64) / vs
    return tuple(int(math.copysign(math.floor(abs(x) + 0.5), x)) for x in ext)


def _grid(voxel_size, pc_range, n_clouds: int) -> tuple[tuple[int, int, int], int]:
    g = grid_cells(voxel_size, pc_range)
    G = g[0] * g[1] * g[2]
    if min(g) < 1:
        raise ValueError(f"voxel grid {g} has no cells")
    if n_clouds * G >= 2**63:
        raise ValueError(f"{n_clouds} clouds of {G} cells do not fit a 64-bit key")
    return g, G


def _host_index(t, name: str) -> np.ndarray:
    a = np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t).reshape(-1)
    if a.dtype.kind not in "iu":
        raise TypeError(f"{name} must be integers, got {a.dtype}")
    return a.astype(np.int64)


def _check(points, offsets, lanes, max_points, max_voxels):
    """offsets and lanes as host int64 arrays (lanes None: one lane a
    cloud), their values checked."""
    if points.dim() != 2 or points.shape[1] < 3 or points.dtype != torch.float32:
        raise ValueError(f"points must be (N, >=3) float32, got {points.dtype} "
                         f"{tuple(points.shape)}")
    if max_points < 1 or max_voxels < 1:
        raise ValueError("max_points and max_voxels must be positive")
    if not (points.is_cuda or points.device.type == "cpu"):
        raise ValueError(f"unsupported device {points.device}")
    offsets = _host_index(offsets, "offsets")
    if (len(offsets) < 2 or offsets[0] != 0 or offsets[-1] != points.shape[0]
            or np.any(np.diff(offsets) < 0)):
        raise ValueError("offsets must rise from 0 to the number of points")
    C = len(offsets) - 1
    lanes = np.arange(C) if lanes is None else _host_index(lanes, "lanes")
    if len(lanes) and (lanes.min() < 0 or lanes.max() >= C):
        raise ValueError(f"lanes must name clouds 0..{C - 1}")
    return offsets, lanes, C


def voxelize_lanes_plain(points: torch.Tensor, offsets, voxel_size, pc_range,
                         max_points: int, max_voxels: int, sort_by_key: bool = False,
                         lanes=None):
    """The kernel's algorithm in PyTorch, on the points' device."""
    offsets, lanes, C = _check(points, offsets, lanes, max_points, max_voxels)
    dev = points.device
    N, nc = points.shape
    P, V = max_points, max_voxels
    (gx, gy, gz), G = _grid(voxel_size, pc_range, C)
    off = torch.as_tensor(offsets, device=dev)
    lane_cloud = torch.as_tensor(lanes, device=dev)
    L = lane_cloud.shape[0]
    if N == 0:
        return (points.new_zeros((L, V, P, nc)),
                torch.zeros((L, V, 3), dtype=torch.int32, device=dev),
                torch.zeros((L, V), dtype=torch.int32, device=dev),
                torch.zeros((L, V), dtype=torch.bool, device=dev))
    idx = torch.arange(N, device=dev)
    cloud = torch.searchsorted(off[1:], idx, right=True)
    rmin = torch.as_tensor(np.asarray(pc_range[:3], np.float32), device=dev)
    vs = torch.as_tensor(np.asarray(voxel_size, np.float32), device=dev).double()
    d = (points[:, :3] - rmin).double() / vs
    cells = torch.tensor([gx, gy, gz], dtype=torch.float64, device=dev)
    inside = ((d >= 0) & (d < cells)).all(1)
    ijk = torch.floor(torch.where(inside[:, None], d, 0.0)).long()
    invalid = C * G
    key = torch.where(inside, cloud * G + (ijk[:, 2] * gy + ijk[:, 1]) * gx + ijk[:, 0], invalid)
    sk, order = torch.sort(key, stable=True)
    # each voxel's head: the first sorted key of its run, at its earliest point
    head = (sk < invalid) & torch.cat([sk.new_ones(1, dtype=torch.bool), sk[1:] != sk[:-1]])
    first = torch.zeros(N + 1, dtype=torch.long, device=dev)
    first[1:][order[head]] = 1
    heads_before = torch.cumsum(first, 0)  # [i]: heads among points < i
    arrival = heads_before[:-1] - heads_before[off[cloud]]  # a head's rank in its cloud
    nkept = (heads_before[off[1:]] - heads_before[off[:-1]]).clamp(max=V)
    hs = torch.nonzero(head).squeeze(1)  # heads in sorted order
    hc, hr = sk[hs] // G, arrival[order[hs]]
    keep = hr < V
    hs, hc, hr = hs[keep], hc[keep], hr[keep]
    if sort_by_key:  # the kept heads' place in key order within their cloud
        kbase = torch.cumsum(nkept, 0) - nkept
        hr = torch.arange(hs.shape[0], device=dev) - kbase[hc]
    row_head = torch.zeros((C, V), dtype=torch.long, device=dev)
    row_head[hc, hr] = hs
    n_rows = nkept[lane_cloud]  # (L,)
    row_ok = torch.arange(V, device=dev) < n_rows[:, None]  # (L, V)
    h = torch.where(row_ok, row_head[lane_cloud], 0)
    slot = h[..., None] + torch.arange(P, device=dev)  # (L, V, P)
    in_run = row_ok[..., None] & (slot < N)
    slot = torch.where(in_run, slot, 0)
    in_run &= sk[slot] == sk[h][..., None]
    voxels = torch.where(in_run[..., None], points[order[slot]], 0.0)
    ck = sk[h] - lane_cloud[:, None] * G
    coords = torch.stack([ck // (gx * gy), (ck // gx) % gy, ck % gx], -1)
    coords = torch.where(row_ok[..., None], coords, 0).to(torch.int32)
    return voxels, coords, in_run.sum(-1, dtype=torch.int32), row_ok


@functools.cache
def _fns():
    from .build import library

    lib = library("voxelize")
    scratch = lib.voxelize_lanes_scratch
    scratch.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    scratch.restype = ctypes.c_longlong
    launch = lib.voxelize_lanes_launch
    launch.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
    launch.restype = ctypes.c_int
    return scratch, launch


def voxelize_lanes(points: torch.Tensor, offsets, voxel_size, pc_range, max_points: int,
                   max_voxels: int, sort_by_key: bool = False, lanes=None):
    refuse_autograd("voxelize_lanes", points)
    offsets, lanes, C = _check(points, offsets, lanes, max_points, max_voxels)
    count("voxelize.clouds", C)
    if not points.is_cuda:
        return voxelize_lanes_plain(points, offsets, voxel_size, pc_range, max_points,
                                    max_voxels, sort_by_key, lanes)
    (gx, gy, gz), G = _grid(voxel_size, pc_range, C)
    dev = points.device
    N, nc = points.shape
    if N >= 2**30 or max_points * nc > 256:
        raise ValueError("the kernel takes fewer than 2**30 points and max_points * channels "
                         "of at most 256")
    off, lanes = (upload(a.astype(np.int32), dev) for a in (offsets, lanes))
    L, P, V = lanes.shape[0], max_points, max_voxels
    points = points.contiguous()
    scratch_fn, launch_fn = _fns()
    nbytes = scratch_fn(N, C, V, G)
    if nbytes < 0:
        raise ValueError(f"{C} clouds of {G} cells do not fit the kernel's keys")
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    voxels = torch.empty((L, V, P, nc), dtype=torch.float32, device=dev)
    coords = torch.empty((L, V, 3), dtype=torch.int32, device=dev)
    num = torch.empty((L, V), dtype=torch.int32, device=dev)
    valid = torch.empty((L, V), dtype=torch.bool, device=dev)
    f3 = ctypes.c_float * 3
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch_fn(points.data_ptr(), N, nc, off.data_ptr(), C, lanes.data_ptr(), L,
                    f3(*np.asarray(pc_range[:3], np.float32).tolist()),
                    f3(*np.asarray(voxel_size, np.float32).tolist()),
                    (ctypes.c_int * 3)(gx, gy, gz), P, V, int(bool(sort_by_key)),
                    scratch.data_ptr(), voxels.data_ptr(), coords.data_ptr(), num.data_ptr(),
                    valid.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"voxelize_lanes launch failed: CUDA error {err}")
    voxelize_lanes.launches += 1
    return voxels, coords, num, valid


voxelize_lanes.launches = 0
