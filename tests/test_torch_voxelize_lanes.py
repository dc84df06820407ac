"""voxelize_lanes' plain version against the host voxelizer, byte for byte.

The host route is the dataset's: `runtime.points_to_voxel` (the C++ of
host_ops.cpp) and `voxelize_frame`'s key sort and zero padding to
max_voxels. The card test (tests/test_torch_gpu.py) holds the CUDA kernel to
this plain version on the same clouds.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from shasta_tpu_torch.data.nuscenes import PointPipelineConfig, voxelize_frame
from shasta_tpu_torch.ops.kernels.voxelize import (grid_cells, voxelize_lanes,
                                                   voxelize_lanes_plain)
from shasta_tpu_torch.utils import profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PP = PointPipelineConfig(voxel_size=(0.3, 0.3, 0.2), pc_range=(-12.0, -12.0, -5.0, 12.0, 12.0, 3.0),
                         max_points_in_voxel=4, max_voxels=60, nsweeps=1, voxel_tiers=None)


def edge_cloud(rng, n=400) -> np.ndarray:
    """Points on voxel faces and on the range's faces, just inside and just
    outside them, -0.0, and points beyond the range."""
    lo, hi = np.float32([-12, -12, -5]), np.float32([12, 12, 3])
    vs = np.float32([0.3, 0.3, 0.2])
    k = rng.integers(0, 41, size=(n, 3)).astype(np.float32)
    faces = lo + k * vs  # multiples of the voxel size in f32, some past the range
    pts = np.where(rng.random((n, 3)) < 0.5, faces, rng.uniform(lo - 1, hi + 1, (n, 3)))
    pts = pts.astype(np.float32)
    near = rng.random((n, 3))
    pts = np.where(near < 0.15, np.nextafter(pts, np.float32(-np.inf)), pts)
    pts = np.where(near > 0.85, np.nextafter(pts, np.float32(np.inf)), pts)
    special = np.float32([[-12, -12, -5], [12, 12, 3], [-0.0, -0.0, -0.0],
                          [np.nextafter(np.float32(12), np.float32(0)), 0, 0],
                          [np.nextafter(np.float32(-12), np.float32(-13)), 0, 0]])
    xyz = np.concatenate([pts, special]).astype(np.float32)
    feats = rng.standard_normal((len(xyz), 2)).astype(np.float32)
    return np.concatenate([xyz, feats], 1)


def dense_cloud(rng, n=300) -> np.ndarray:
    """A few voxels holding many more points than max_points each."""
    centres = np.float32([[0.15, 0.15, 0.1], [3.0, -2.1, 1.1], [-7.95, 5.05, -4.9]])
    xyz = centres[rng.integers(0, 3, n)] + rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    return np.concatenate([xyz, rng.standard_normal((n, 2))], 1).astype(np.float32)


def capped_cloud(rng, n=900) -> np.ndarray:
    """Several times more voxels than the cap, in no order of key, so the
    arrival-order cap keeps others than the smallest keys would."""
    xyz = rng.uniform([-12, -12, -5], [12, 12, 3], (n, 3)).astype(np.float32)
    xyz = np.concatenate([xyz, xyz[rng.integers(0, n, n // 3)]])  # revisits
    return np.concatenate([xyz, rng.standard_normal((len(xyz), 2))], 1).astype(np.float32)


CLOUDS = {"edges": edge_cloud, "dense": dense_cloud, "capped": capped_cloud}


def host(points: np.ndarray, sort_by_key: bool):
    return voxelize_frame(points, PP, np.random.default_rng(0), train=False,
                          sort_by_key=sort_by_key)


def lanes_of(clouds):
    flat = np.concatenate(clouds) if clouds else np.zeros((0, 5), np.float32)
    return torch.from_numpy(flat), np.cumsum([0] + [len(c) for c in clouds])


def assert_same_bytes(got, want, label):
    for g, w, name in zip(got, want, ("voxels", "coords", "num_points", "valid")):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name, g.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), (label, name)


@pytest.mark.parametrize("sort_by_key", [False, True])
@pytest.mark.parametrize("case", sorted(CLOUDS))
def test_plain_is_the_host_voxelizer_byte_for_byte(case, sort_by_key):
    """Each case's cloud alone and beside an empty cloud and a cloud of
    another length: every lane the host's bytes."""
    rng = np.random.default_rng(7)
    cloud = CLOUDS[case](rng)
    other = edge_cloud(rng, n=57)
    clouds = [cloud, np.zeros((0, 5), np.float32), other]
    points, offsets = lanes_of(clouds)
    out = voxelize_lanes_plain(points, offsets, PP.voxel_size, PP.pc_range,
                               PP.max_points_in_voxel, PP.max_voxels, sort_by_key)
    for li, c in enumerate(clouds):
        assert_same_bytes([a[li] for a in out], host(c, sort_by_key), (case, li))
    if case == "dense":
        assert out[2][0].max() == PP.max_points_in_voxel  # a voxel held more points
    if case == "capped":
        assert out[3][0].all()  # the cap holds
        # the arrival-order cap keeps voxels the smallest keys would not
        keys = out[1][0].long() @ torch.tensor([80 * 80, 80, 1])
        whole = dataclasses.replace(PP, max_voxels=10**4)
        _, every, _, ok = voxelize_frame(cloud, whole, None, train=False, sort_by_key=True)
        smallest = np.sort(every[ok].astype(np.int64) @ [6400, 80, 1])
        assert not np.array_equal(np.sort(keys.numpy()), smallest[:PP.max_voxels])
        assert torch.equal(keys, torch.sort(keys)[0]) == sort_by_key


def test_lanes_share_clouds_and_empty_input():
    """Output lanes that repeat a cloud hold its rows; no points at all
    gives zero grids."""
    rng = np.random.default_rng(3)
    a, b = dense_cloud(rng, 50), capped_cloud(rng, 200)
    points, offsets = lanes_of([a, b])
    args = (PP.voxel_size, PP.pc_range, PP.max_points_in_voxel, PP.max_voxels, True)
    out = voxelize_lanes_plain(points, offsets, *args, lanes=[1, 0, 1])
    for li, c in enumerate([b, a, b]):
        assert_same_bytes([x[li] for x in out], host(c, True), li)
    empty = voxelize_lanes_plain(torch.zeros((0, 5)), [0, 0], *args, lanes=[0, 0])
    assert empty[0].shape == (2, PP.max_voxels, PP.max_points_in_voxel, 5)
    assert not empty[0].any() and not empty[3].any() and not empty[1].any()


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_clouds():
    """On CPU tensors the wrapper is the plain version; a profiled call
    counts its clouds; malformed offsets and lanes raise."""
    rng = np.random.default_rng(5)
    points, offsets = lanes_of([edge_cloud(rng, 30), edge_cloud(rng, 20)])
    args = (PP.voxel_size, PP.pc_range, PP.max_points_in_voxel, PP.max_voxels)
    profiler.reset_counters()
    with torch.profiler.profile():  # counters count while a profiler records
        got = voxelize_lanes(points, offsets, *args, lanes=[0, 1, 1])
    assert profiler.counters()["voxelize.clouds"] == 2
    profiler.reset_counters()
    want = voxelize_lanes_plain(points, offsets, *args, lanes=[0, 1, 1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="offsets"):
        voxelize_lanes(points, [0, 10, 40], *args)
    with pytest.raises(ValueError, match="lanes"):
        voxelize_lanes(points, offsets, *args, lanes=[2])
    assert voxelize_lanes.launches == 0  # no kernel on the CPU


def test_grid_cells_are_the_host_grid():
    """The grid of the car config, a grid whose extent rounds, and one
    whose f32 extent differs from the f64 one."""
    assert grid_cells((0.075, 0.075, 0.2), (-54, -54, -5, 54, 54, 3)) == (1440, 1440, 40)
    assert grid_cells((0.3, 0.3, 0.2), (-12, -12, -5, 12, 12, 3)) == (80, 80, 40)
    assert grid_cells((0.2, 0.2, 8), (-51.2, -51.2, -5, 51.2, 51.2, 3)) == (512, 512, 1)


def _same_on_card(got, want, label):
    torch.cuda.synchronize()
    assert_same_bytes([g.cpu() for g in got], [w.numpy() for w in want], label)


@pytest.mark.gpu
@pytest.mark.parametrize("sort_by_key", [False, True])
def test_kernel_is_the_plain_version_on_the_card(sort_by_key):
    """The CUDA kernel against the plain version on the cases above, all in
    one call beside an empty cloud, with lanes that repeat clouds; and on a
    1 cm grid, whose keys take 35 bits and an odd number of radix passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from shasta_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    rng = np.random.default_rng(11)
    clouds = [CLOUDS[c](rng) for c in sorted(CLOUDS)] + [np.zeros((0, 5), np.float32),
                                                         edge_cloud(rng, 57)]
    points, offsets = lanes_of(clouds)
    launches = voxelize_lanes.launches
    for voxel_size in (PP.voxel_size, (0.01, 0.01, 0.01)):
        args = (voxel_size, PP.pc_range, PP.max_points_in_voxel, PP.max_voxels, sort_by_key)
        for lanes in (None, [4, 0, 3, 4, 1, 2, 0]):
            want = voxelize_lanes_plain(points, offsets, *args, lanes=lanes)
            _same_on_card(voxelize_lanes(points.to(dev), offsets, *args, lanes=lanes), want,
                          (voxel_size, lanes))
    assert voxelize_lanes.launches == launches + 4


@pytest.mark.gpu
def test_kernel_on_an_eval8_row_on_the_card(tmp_path):
    """One row of the benchmark's car.eval8 (8 clouds of ~220k points, the
    car config's grid and caps) and a ninth cloud of 400k points spread
    over ~390k voxels, past the 120,000 cap: the kernel against the plain
    version and against the host voxelizer, both row orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import json

    from shasta_tpu_torch import resolve_device
    from shasta_tpu_torch.data.nuscenes import NuScenesTrackDataset
    from trackbench.gen.scenes import write_split

    dev = resolve_device("cuda")
    with open(os.path.join(REPO, "trackbench", "traffic", "eval8.json")) as f:
        mix = dict(json.load(f), scenes=8, frames=1)
    with open(os.path.join(REPO, "trackbench", "configs", "shasta-car.json")) as f:
        pp = json.load(f)["point_pipeline"]
    split = write_split(str(tmp_path), 1234567, mix, pp, {"car": 90})
    pipe = PointPipelineConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in pp.items()})
    ds = NuScenesTrackDataset(**split["kwargs"], det_type=["car"], max_objects=90, pipeline=pipe)
    meta = ds.metadata()
    clouds = [ds.read_points_at(i, meta[i]["rng_state"])["points"] for i in range(8)]
    rng = np.random.default_rng(2)
    xyz = rng.uniform(pipe.pc_range[:3], pipe.pc_range[3:], (400000, 3))
    clouds.append(np.concatenate([xyz, rng.standard_normal((400000, 2))], 1).astype(np.float32))
    assert all(len(c) > 200000 for c in clouds)
    points, offsets = lanes_of(clouds)
    for sort_by_key in (False, True):
        args = (pipe.voxel_size, pipe.pc_range, pipe.max_points_in_voxel, pipe.max_voxels,
                sort_by_key)
        got = voxelize_lanes(points.to(dev), offsets, *args)
        torch.cuda.synchronize()
        got = [g.cpu() for g in got]
        for li, c in enumerate(clouds):
            assert_same_bytes([g[li] for g in got], voxelize_frame(c, pipe, None, False,
                                                                   sort_by_key), li)
        assert got[3][8].all() and not got[3][0].all()  # lane 8 capped, lane 0 not
        want = voxelize_lanes_plain(points, offsets, *args)
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == w.numpy().tobytes()
