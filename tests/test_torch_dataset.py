"""The port's dataset path against the JAX package's (CPU): the nuScenes
dataset reader, the host runtime, the config loader and the box helpers.

Samples of shasta_tpu_torch.data.nuscenes.NuScenesTrackDataset must equal
those of shasta_tpu.data.nuscenes.NuScenesTrackDataset exactly, for the
same seed: on the micro tree that the JAX preprocessing chain writes
(tests/fixtures_nusc.py), and on a split of the port's write_track_split.
The port's C++ runtime must give the JAX runtime's results (IoUs at atol
1e-6, everything else exact) and build under a lock that holds across
processes.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from fixtures_nusc import build_micro_nusc
from shasta_tpu import runtime as jruntime
from shasta_tpu.core.boxes import quaternion_yaw as jquaternion_yaw
from shasta_tpu.data import nuscenes as jnusc
from shasta_tpu.preprocessing.nuscenes_chain import run_chain
from shasta_tpu.utils import Config as JConfig

from shasta_tpu_torch import runtime
from shasta_tpu_torch.core.boxes import quaternion_yaw, yaw_to_quaternion
from shasta_tpu_torch.data import nuscenes as nusc
from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
from shasta_tpu_torch.ops.voxelize import points_to_voxel_np
from shasta_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MICRO_PIPELINE = dict(voxel_size=(0.075, 0.075, 0.05), pc_range=(-3.0, -3.0, -1.0, 3.0, 3.0, 1.0),
                      max_voxels=4000, nsweeps=1)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("micro")
    fx = build_micro_nusc(tmp)
    out = tmp / "prep"
    run_chain(dataroot=str(fx["root"]), version="v1.0-mini", results_json=str(fx["results"]),
              out_dir=str(out), split="val", scene_names=None)
    split = out / "val_2hz"
    return dict(
        info_path=str(fx["infos"]),
        det_path=str(split / "detections" / "cp" / "sensor_individual_frames"),
        cls_info_path=str(split / "detections" / "cp" / "cls_individual_frames"),
        frame_info_path=str(out / "val_frame_info.json"),
        labels_path=str(split / "gt_shasta" / "cp" / "individual_frames"),
    )


def _assert_same_samples(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds)
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert got.keys() == want.keys()
        for k, w in want.items():
            g = got[k]
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and g.shape == w.shape, k
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                assert g == w, k


def _both(kwargs, **pipeline):
    """The port's and the JAX dataset over the same files and settings."""
    return (nusc.NuScenesTrackDataset(**kwargs, pipeline=nusc.PointPipelineConfig(**pipeline)),
            jnusc.NuScenesTrackDataset(**kwargs, pipeline=jnusc.PointPipelineConfig(**pipeline)))


@pytest.mark.parametrize("mode", ["sorted", "unsorted", "tiers", "train"])
def test_dataset_matches_jax_on_micro_tree(micro, mode):
    """Serving samples (test_mode, points in file order) with the voxel
    rows key-sorted or in arrival order, with occupancy tiers, and training
    samples (GT matrices with their random subsampling, point augmentation
    and shuffling, all drawn from the seeded generator)."""
    kw = dict(micro, det_type=["car"], max_objects=6, seed=3)
    pp = dict(MICRO_PIPELINE, shuffle_points=False, sort_voxels=mode != "unsorted")
    if mode == "tiers":
        pp["voxel_tiers"] = (500, 1000, 2000)
    if mode == "train":
        kw.update(fp_ratio=1 / 3, dead_trk_ratio=1 / 3)
        pp["shuffle_points"] = True
    else:
        kw["test_mode"] = True
        kw.pop("labels_path")
    port_ds, jax_ds = _both(kw, **pp)
    _assert_same_samples(port_ds, jax_ds)
    s = port_ds[1]
    assert s["prev_token"] == "samp0" and s["voxels_valid"].sum() > 0
    if mode == "tiers":
        assert s["voxels"].shape[0] in (500, 1000, 2000, 4000)
    if mode == "train":
        assert s["gt"].shape == (8, 8)


def test_collate_matches_jax_across_tiers(micro):
    kw = dict(micro, det_type=["car"], max_objects=6, test_mode=True)
    kw.pop("labels_path")
    pp = dict(MICRO_PIPELINE, shuffle_points=False, voxel_tiers=(200, 1000))
    port_ds, jax_ds = _both(kw, **pp)
    samples = [port_ds[i] for i in range(len(port_ds))]
    got = nusc.collate(samples)
    want = jnusc.collate(samples)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]


SPLIT_CFG = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {configs!r})
    from _base import *  # noqa

    det_type = ["car"]
    max_objects = 6
    model = dict(model, max_obj=6, grid_shape=(41, 80, 80), pc_start=(-12.0, -12.0),
                 voxel_size=(0.3, 0.3), cap_conv2=2000, cap_conv3=1000, cap_conv4=500,
                 cap_extra=500)
    point_pipeline = dict(point_pipeline, voxel_size=(0.3, 0.3, 0.2),
                          pc_range=(-12.0, -12.0, -5.0, 12.0, 12.0, 3.0),
                          max_voxels=3000, nsweeps=3)
""")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A 2-scene x 3-frame write_track_split tree at a small geometry, with
    four sweeps listed per frame (two are drawn per sample, at random)."""
    tmp = tmp_path_factory.mktemp("split")
    base = tmp / "small_car.py"
    base.write_text(SPLIT_CFG.format(configs=os.path.join(REPO, "configs", "nusc")))
    sp = write_track_split(tmp / "data", Config.fromfile(str(base)), n_scenes=2, n_frames=3,
                           seed=5, n_objects=12, n_points=3000, n_spots=800,
                           sweeps_per_frame=4)
    return dict(sp, config=write_split_config(str(base), sp["val"], str(tmp / "cfg.py")))


def test_write_track_split_reads_the_same_in_both_packages(split):
    cfg = Config.fromfile(split["config"])
    kw = dict(**dict(cfg.data.val), det_type=list(cfg.det_type), max_objects=cfg.max_objects,
              seed=7)
    pp = dict(cfg.point_pipeline, shuffle_points=False)
    port_ds, jax_ds = _both(kw, **pp)
    _assert_same_samples(port_ds, jax_ds)
    assert [port_ds[i]["token"] for i in range(len(port_ds))] == split["tokens"]
    firsts = [i for i in range(len(port_ds)) if not port_ds[i]["prev_token"]]
    assert firsts == [0, 3]
    s = port_ds[1]
    assert s["num_det_boxes"] == 6 and s["voxels_valid"].sum() > 500
    # more car detections than max_objects: the samples drew their subsets
    with open(os.path.join(cfg.data.val.cls_info_path, split["tokens"][1] + ".json")) as f:
        assert sum(c["detection_name"] == "car" for c in json.load(f)) > cfg.max_objects
    # the split's sweeps are read: more points than the key frame alone
    info = port_ds._infos[1]
    assert len(info["sweeps"]) == 4
    key = nusc.read_nusc_points(info["lidar_path"])
    assert len(nusc.load_sweep_points(info, 3, np.random.default_rng(0))) > len(key)
    with open(os.path.join(split["gt_info_dir"], split["tokens"][0] + ".json")) as f:
        gt = json.load(f)
    assert len(gt["frame_ids"]) == len(gt["frame_types"]) == len(gt["frame_bboxes"]) == 12


def test_config_fromfile_matches_jax():
    path = os.path.join(REPO, "configs", "nusc", "car.py")
    got, want = Config.fromfile(path), JConfig.fromfile(path)
    assert dict(got) == dict(want)
    assert got.model.max_obj == 90 and got.point_pipeline.max_voxels == 120000


def test_box_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    for yaw in rng.uniform(-np.pi, np.pi, 16):
        q = yaw_to_quaternion(yaw)
        assert quaternion_yaw(q) == jquaternion_yaw(q)
        assert abs(quaternion_yaw(q) - yaw) < 1e-9
    for q in rng.normal(size=(16, 4)):
        assert quaternion_yaw(q) == jquaternion_yaw(q)


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-8, 8, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("op", ["points_to_voxel", "iou_bev", "iou_3d", "rotate_nms",
                                "pc_in_box", "crc32c"])
def test_runtime_matches_jax_runtime(op):
    assert runtime.available() and jruntime.available()
    rng = np.random.default_rng(11)
    if op == "points_to_voxel":
        pts = np.concatenate([rng.uniform(-3.5, 3.5, (20000, 3)),
                              rng.uniform(0, 1, (20000, 2))], 1).astype(np.float32)
        for cap in (100000, 1500):  # one cap the cloud stays under, one it outgrows
            got = runtime.points_to_voxel(pts, [0.1, 0.1, 0.2], [-3, -3, -1, 3, 3, 1], 10, cap)
            want = jruntime.points_to_voxel(pts, [0.1, 0.1, 0.2], [-3, -3, -1, 3, 3, 1], 10, cap)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            for g, w in zip(got, points_to_voxel_np(pts, [0.1, 0.1, 0.2],
                                                    [-3, -3, -1, 3, 3, 1], 10, cap)):
                np.testing.assert_array_equal(g, w)
    elif op in ("iou_bev", "iou_3d"):
        a, b = _boxes(rng, 40), _boxes(rng, 30)
        np.testing.assert_allclose(getattr(runtime, op)(a, b), getattr(jruntime, op)(a, b),
                                   atol=1e-6, rtol=0)
    elif op == "rotate_nms":
        b = _boxes(rng, 200)
        s = rng.uniform(0, 1, 200).astype(np.float32)
        for thr in (0.1, 0.5):
            np.testing.assert_array_equal(runtime.rotate_nms(b, s, thr),
                                          jruntime.rotate_nms(b, s, thr))
    elif op == "pc_in_box":
        pc = rng.uniform(-4, 4, (5000, 4)).astype(np.float32)
        for box in rng.uniform(0.5, 3, (8, 7)):
            box[3] = rng.uniform(-np.pi, np.pi)
            np.testing.assert_array_equal(runtime.pc_in_box(box, pc, 1.5),
                                          jruntime.pc_in_box(box, pc, 1.5))
    else:
        for n in (0, 1, 7, 1000):
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            assert runtime.crc32c(data) == jruntime.crc32c(data)
            assert runtime.crc32c(data, 12345) == jruntime.crc32c(data, 12345)


BUILD_ONE = """
import ctypes, sys
from pathlib import Path
from shasta_tpu_torch import runtime
runtime.BUILD = Path(sys.argv[1])
path = runtime.build()
ctypes.CDLL(str(path)).crc32c  # a half-written file fails to load
print(path)
"""


def test_runtime_builds_once_across_processes(tmp_path):
    """Four processes building into one empty directory at once all load
    the same finished library; no temporary file is left behind."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == sorted([os.path.basename(paths.pop()),
                                                   "libshasta_host.lock"])


def test_runtime_build_failure_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises."""
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "SRC", bad)
    monkeypatch.setattr(runtime, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime.build()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_port_copy_of_host_ops_is_byte_identical():
    with open(os.path.join(REPO, "shasta_tpu", "runtime", "src", "host_ops.cpp"), "rb") as f:
        want = f.read()
    assert runtime.SRC.read_bytes() == want
