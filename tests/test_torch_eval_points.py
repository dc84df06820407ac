"""The batched eval's points route: `read_points_at` against `read_at`, and
`run_affinity_eval_batched` (clouds voxelized by `voxelize_lanes` on the
model's device) against the route of host-built voxel grids through the
same `EvalLanes` step, on a small synthetic split with voxel tiers.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from shasta_tpu_torch import runtime
from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.nuscenes import collate, voxelize_frame
from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
from shasta_tpu_torch.infer import FRAME_KEYS
from shasta_tpu_torch.tools.common import build_dataset, build_model
from shasta_tpu_torch.tracker import runner
from shasta_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 3
SMALL = dict(
    max_objects=10,
    model=dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-12.0, -12.0), voxel_size=(0.3, 0.3),
               cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500),
    point_pipeline=dict(voxel_size=(0.3, 0.3, 0.2), pc_range=(-12.0, -12.0, -5.0, 12.0, 12.0, 3.0),
                        max_voxels=3000, nsweeps=3, voxel_tiers=(2700, 2800, 2900)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread per worker (the plain CPU path's many small parallel
    regions crawl when the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """4 scenes of 3, 3, 3 and 2 frames (the last frame left out of the
    infos: 5 rows of 3 lanes, one refill, idle lanes, and at chunk 2 an idle
    tail row), a random model whose last layer is scaled so that its
    decisions fire."""
    root = tmp_path_factory.mktemp("points")
    base = write_split_config(os.path.join(REPO, "configs", "nusc", "car.py"), {},
                              str(root / "base.py"), **SMALL)
    sp = write_track_split(str(root / "data"), Config.fromfile(base), n_scenes=4, n_frames=3,
                           seed=21, n_objects=16, n_points=4000, n_spots=1000)
    with open(sp["val"]["info_path"], "rb") as f:
        infos = pickle.load(f)
    with open(sp["val"]["info_path"], "wb") as f:
        pickle.dump(infos[:-1], f)
    cfg = Config.fromfile(write_split_config(base, sp["val"], str(root / "split.py")))
    model = build_model(cfg, "cpu")
    load_jax_variables(model, random_jax_variables(model, seed=22))
    sd = model.state_dict()
    sd["aff.10.weight"] *= 10.0
    sd["aff.10.bias"][-2:] += 5.0
    model.load_state_dict(sd)
    return cfg, model


def voxel_route(model, ds, batch, chunk):
    """The batched loop on host-built grids (`read_at`, `collate`: each
    call padded to its widest voxel tier) through EvalLanes.step_chunk."""
    meta = ds.metadata()
    scenes = []
    for i, m in enumerate(meta):
        if not m["prev_token"] or not scenes:
            scenes.append([])
        scenes[-1].append(i)
    sched = runner.lane_schedule([len(s) for s in scenes], batch)
    sched += [[None] * batch] * ((-len(sched)) % chunk)
    lanes = runner.EvalLanes(model, batch)
    annos, dead, frames = {"results": {}, "meta": None}, {}, None
    for t0 in range(0, len(sched), chunk):
        rows, lane_frames, resets, n_currs = [], [], [], []
        for row in sched[t0:t0 + chunk]:
            samples = [None if e is None else ds.read_at(scenes[e[0]][e[1]],
                                                         meta[scenes[e[0]][e[1]]]["rng_state"])
                       for e in row]
            if any(s is not None for s in samples):
                template = next(s for s in samples if s is not None)
                frames = [{k: (template if s is None else s)[k] for k in FRAME_KEYS}
                          for s in samples]
            rows.append(samples)
            lane_frames += frames
            resets.append([e is None or e[1] == 0 for e in row])
            n_currs.append([0 if s is None else len(s["cls_det_boxes"]) for s in samples])
        staged = {k: v.reshape((len(rows), batch) + v.shape[1:])
                  for k, v in collate(lane_frames).items()}
        arr = lanes.step_chunk(staged, resets, n_currs).array()
        for t, samples in enumerate(rows):
            for li, s in enumerate(samples):
                if s is not None:
                    runner._assemble_frame_annos(s, runner._unpack(arr[t, li]), annos, dead)
    return runner._finalize_annos(annos, dead)


def test_read_points_at_reads_read_at_s_frame(split):
    """Every index: the same detections and metadata as read_at, no voxel
    array and no prev_ cloud, and a cloud that voxelizes to read_at's
    frame arrays; an index read in another order reads the same."""
    cfg, _ = split
    ds = build_dataset(cfg, "val")
    meta = ds.metadata()
    for i in reversed(range(len(meta))):
        want = ds.read_at(i, meta[i]["rng_state"])
        got = ds.read_points_at(i, meta[i]["rng_state"])
        assert not any(k.endswith(("voxels", "coordinates", "num_points", "voxels_valid"))
                       for k in got)
        assert set(got) == {k for k in want if not k.endswith(
            ("voxels", "coordinates", "num_points", "voxels_valid"))} | {"points"}
        for k, v in got.items():
            if k == "points":
                assert v.dtype == np.float32 and v.shape[1] == 5
            elif isinstance(v, np.ndarray):
                assert np.array_equal(v, want[k]), (i, k)
            else:
                assert v == want[k], (i, k)
        arrays = voxelize_frame(got["points"], ds.pipeline, None, train=False,
                                sort_by_key=ds.pipeline.sort_voxels)
        for k, a in zip(("voxels", "coordinates", "num_points", "voxels_valid"), arrays):
            assert a.tobytes() == want[k].tobytes(), (i, k)
    with pytest.raises(ValueError, match="test mode"):
        ds.test_mode = False
        ds.read_points_at(0, meta[0]["rng_state"])


def dataset(cfg, sort_voxels):
    ds = build_dataset(cfg, "val")
    ds.pipeline = dataclasses.replace(ds.pipeline, sort_voxels=sort_voxels)
    return ds


@pytest.mark.parametrize("chunk,sort_voxels", [(1, False), (2, False), (1, True)])
def test_points_route_gives_the_voxel_route_s_annotations(split, chunk, sort_voxels,
                                                          monkeypatch):
    """The batched eval's annotations equal the voxel route's exactly, with
    voxel tiers (the points route pads to max_voxels, the voxel route to
    each call's widest tier), chunk 2's idle tail row and either row order;
    the loop never voxelizes on the host and voxelizes one cloud a frame."""
    cfg, model = split
    want = voxel_route(model, dataset(cfg, sort_voxels), LANES, chunk)

    def host_voxelizer(*a, **k):
        raise AssertionError("the batched eval voxelized on the host")

    monkeypatch.setattr(runtime, "points_to_voxel", host_voxelizer)
    clouds = []
    real = runner.voxelize_lanes
    monkeypatch.setattr(runner, "voxelize_lanes",
                        lambda points, offsets, *a, **k: clouds.append(len(offsets) - 1)
                        or real(points, offsets, *a, **k))
    ds = dataset(cfg, sort_voxels)
    assert ds.pipeline.voxel_tiers
    got = runner.run_affinity_eval_batched(model, ds, batch=LANES, chunk=chunk)
    assert got == want
    assert len(got["results"]) == 11 and sum(map(len, got["results"].values())) > 20
    assert sum(clouds) == 11  # one cloud a frame: idle lanes share their template's
