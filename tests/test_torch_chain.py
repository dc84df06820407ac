"""The port's nuScenes offline chain against the JAX package's (CPU, numpy).

On the micro tree of tests/fixtures_nusc.py (one scene, three key frames
with two non-key sweeps between each pair) and on a small world of
build_synthetic_world (2 scenes x 6 frames), the same dataroot goes through
shasta_tpu.preprocessing and through shasta_tpu_torch.preprocessing. The
artifacts must be the same files with the same keys and exactly equal
arrays, tokens and JSON: both sides run the same numpy code in the same
order, so no float may differ by a bit. Artifacts are compared by content,
not bytes (np.savez_compressed zips carry timestamps). Also: the 20 Hz
mode's rules (tests/test_token_20hz.py mirrored), create_nuscenes_infos,
the det tools, the submission writer, the covariance estimator, the
port's dataroot writers against the fixture's, and the port's dataset
reading what the port's chain wrote.
"""
import json
import os
import pickle

import numpy as np
import pytest

import fixtures_nusc
from shasta_tpu.core.transforms import quat_slerp as jquat_slerp
from shasta_tpu.data import nuscenes as jnusc
from shasta_tpu.data.submission import sensor_dets_to_global_annos as jsensor_dets_to_global_annos
from shasta_tpu.data.submission import write_detection_submission as jwrite_detection_submission
from shasta_tpu.preprocessing import det_tools as jdet_tools
from shasta_tpu.preprocessing import nuscenes_chain as jchain
from shasta_tpu.preprocessing.infos import create_nuscenes_infos as jcreate_nuscenes_infos
from shasta_tpu.preprocessing.nusc_db import NuscDB as JNuscDB
from shasta_tpu.preprocessing.stats import estimate_covariances as jestimate_covariances

from shasta_tpu_torch.core.boxes import yaw_to_quaternion
from shasta_tpu_torch.core.transforms import quat_slerp
from shasta_tpu_torch.data import nuscenes as nusc
from shasta_tpu_torch.data import synthetic
from shasta_tpu_torch.data.submission import (sensor_dets_to_global_annos,
                                              write_detection_submission)
from shasta_tpu_torch.preprocessing import det_tools
from shasta_tpu_torch.preprocessing import nuscenes_chain as chain
from shasta_tpu_torch.preprocessing.infos import create_nuscenes_infos
from shasta_tpu_torch.preprocessing.nusc_db import NuscDB
from shasta_tpu_torch.preprocessing.stats import estimate_covariances

WORLD = dict(n_scenes=2, n_frames=6)


def same_value(a, b, where="") -> None:
    """a == b exactly: numpy arrays by dtype, shape and value (object arrays
    element by element, NaN equal to NaN), dicts by keys, lists by items."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.reshape(-1), b.reshape(-1))):
                same_value(x, y, f"{where}[{i}]")
        else:
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, list(a), list(b))
        for k in a:
            same_value(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same_value(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def read_artifact(path: str):
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=True) as z:
            return {k: z[k] for k in z.files}
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return pickle.load(f)
    raise ValueError(path)


def same_tree(a: str, b: str) -> int:
    """The two trees hold the same relative files with equal contents;
    returns the file count."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    fa, fb = files(a), files(b)
    assert fa == fb
    for rel in fa:
        same_value(read_artifact(os.path.join(a, rel)), read_artifact(os.path.join(b, rel)), rel)
    return len(fa)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    return fixtures_nusc.build_micro_nusc(tmp_path_factory.mktemp("micro"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return fixtures_nusc.build_synthetic_world(tmp_path_factory.mktemp("world"), **WORLD)


@pytest.fixture(scope="module")
def world_trees(world, tmp_path_factory):
    """The world's 2 Hz val trees of the JAX chain and of the port's."""
    out = {}
    for side, run in (("jax", jchain.run_chain), ("port", chain.run_chain)):
        d = str(tmp_path_factory.mktemp(f"world_{side}"))
        run(dataroot=str(world["root"]), version="v1.0-mini", results_json=str(world["results"]),
            out_dir=d, split="val")
        out[side] = d
    return out


def test_dataroot_writers_equal_the_fixture(tmp_path):
    """data.synthetic's builders write the fixture's JSON tables, .bin
    clouds, results JSON and infos pickle for the same seed and arguments
    (paths inside the infos differ by the root only); the PNGs hold the
    same pixels, read back with PIL."""
    from PIL import Image

    for name, kw in (("build_micro_nusc", {}), ("build_synthetic_world", dict(WORLD, seed=3))):
        want = getattr(fixtures_nusc, name)(tmp_path / f"{name}_jax", **kw)
        got = getattr(synthetic, name)(tmp_path / f"{name}_port", **kw)
        assert set(got) == set(want)
        for k in set(want) - {"root", "results", "infos"}:
            assert got[k] == want[k]
        ra, rb = str(want["root"]), str(got["root"])
        fa = sorted(os.path.relpath(os.path.join(d, f), ra) for d, _, fs in os.walk(ra) for f in fs)
        fb = sorted(os.path.relpath(os.path.join(d, f), rb) for d, _, fs in os.walk(rb) for f in fs)
        assert fa == fb
        for rel in fa:
            pa, pb = os.path.join(ra, rel), os.path.join(rb, rel)
            if rel.endswith(".json"):
                same_value(read_artifact(pb), read_artifact(pa), rel)
            elif rel.endswith(".bin"):
                assert np.array_equal(np.fromfile(pb, np.float32), np.fromfile(pa, np.float32)), rel
            elif rel.endswith(".png"):
                assert np.array_equal(np.asarray(Image.open(pb)), np.asarray(Image.open(pa))), rel
            else:
                infos = [dict(i, lidar_path=i["lidar_path"].replace(rb, ra))
                         for i in read_artifact(pb)]
                same_value(infos, read_artifact(pa), rel)


@pytest.mark.parametrize("mode", ["2hz", "20hz"])
def test_chain_equals_jax_on_the_micro_tree(micro, mode, tmp_path):
    """run_chain, port against JAX on the micro tree: every artifact of the
    split directory and the frame info equal (the 20 Hz mode walks the
    sweep chain and interpolates GT between key frames)."""
    for side, run in (("jax", jchain.run_chain), ("port", chain.run_chain)):
        run(dataroot=str(micro["root"]), version="v1.0-mini", results_json=str(micro["results"]),
            out_dir=str(tmp_path / side), split="val", mode=mode)
    n = same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    # per token: det, class and sensor det jsons and labels (2 Hz: and GT);
    # token, ego, GT and det files; the frame info
    assert n == (20 if mode == "2hz" else 17)


def test_chain_equals_jax_on_the_world(world_trees):
    # per token: GT, det, class and sensor det jsons and labels; per scene:
    # token, ego, GT and det files; the frame info
    assert same_tree(world_trees["jax"], world_trees["port"]) == 12 * 5 + 2 * 4 + 1


def test_chain_keeps_table_order(world_trees):
    """Scenes and samples in table order through the next chains: the
    frame info lists the tokens scene by scene, frame by frame."""
    with open(os.path.join(world_trees["port"], "val_frame_info.json")) as f:
        tokens = list(json.load(f))
    assert tokens == [f"s{s}f{i}" for s in range(WORLD["n_scenes"])
                      for i in range(WORLD["n_frames"])]


def test_select_20hz_counter_reset():
    # key frames always selected + reset; non-key selected at even offsets
    entries = [("a", True, "s0"), ("b", False, "s1"), ("c", False, "s1"),
               ("d", False, "s1"), ("e", True, "s1"), ("f", False, "s2")]
    sel = [row[3] for row in chain._select_20hz(entries)]
    assert sel == [True, False, True, False, True, False]
    assert chain._select_20hz(entries) == jchain._select_20hz(entries)


def test_20hz_stages(micro, tmp_path):
    """tests/test_token_20hz.py on the port: the sweep chain's tokens and
    selection, one ego pose per sweep and GT interpolated between key
    frames."""
    db = NuscDB(str(micro["root"]), "v1.0-mini")
    out = str(tmp_path / "val_20hz")
    chain.write_token_info(db, None, out, mode="20hz")
    chain.write_ego_info(db, None, out, mode="20hz")
    chain.write_gt_info(db, None, out, mode="20hz")
    rows = read_artifact(os.path.join(out, "token_info", "scene-0001.json"))
    assert [r[0] for r in rows] == ["sd0", "sd0m0", "sd0m1", "sd1", "sd1m0", "sd1m1", "sd2"]
    assert [r[1] for r in rows] == [True, False, False, True, False, False, True]
    assert [r[2] for r in rows] == ["samp0", "samp1", "samp1", "samp1", "samp2", "samp2", "samp2"]
    # counter resets at keys; first intermediate (counter 1) dropped,
    # second (counter 2) kept
    assert [r[3] for r in rows] == [True, False, True, True, False, True, True]
    ego = read_artifact(os.path.join(out, "ego_info", "scene-0001.npz"))
    assert len(ego) == 7 and len(ego["0"]) == 7
    d = read_artifact(os.path.join(out, "gt_info", "scene-0001.npz"))
    ids, bboxes = d["ids"], d["bboxes"]
    assert len(ids) == 7
    key0 = {i: np.asarray(b, float) for i, b in zip(ids[0], bboxes[0])}
    assert abs(key0["inst_a"][0] - 10.0) < 1e-9
    # sd0m0 at ~t0 + 1/3 of the gap: x = 10 + ~2/3 (timestamps are integer
    # microseconds, so the fraction is truncated slightly)
    mid = {i: np.asarray(b, float) for i, b in zip(ids[1], bboxes[1])}
    np.testing.assert_allclose(mid["inst_a"][0], 10.0 + 2.0 / 3.0, atol=1e-4)
    np.testing.assert_allclose(mid["inst_b"][0], 20.0 + 2.0 / 3.0, atol=1e-4)
    np.testing.assert_allclose(mid["inst_a"][3:6], [2.0, 4.5, 1.6], atol=1e-9)
    np.testing.assert_allclose(mid["inst_a"][6:10], key0["inst_a"][6:10], atol=1e-9)
    out2 = str(tmp_path / "val_2hz")
    chain.write_token_info(db, None, out2, mode="2hz")
    assert read_artifact(os.path.join(out2, "token_info", "scene-0001.json")) == [
        "samp0", "samp1", "samp2"]


def test_quat_slerp_and_box_velocity(micro):
    """quat_slerp's end points, midpoint and shortest arc equal the JAX
    copy's; box_velocity from the neighbouring annotations, and NaN when
    they lie more than max_time_diff apart or there are none."""
    q0, q1 = yaw_to_quaternion(0.0), yaw_to_quaternion(1.0)
    for t in (0.0, 0.3, 0.5, 1.0):
        assert quat_slerp(q0, q1, t).tobytes() == jquat_slerp(q0, q1, t).tobytes()
    np.testing.assert_allclose(quat_slerp(q0, q1, 0.5), yaw_to_quaternion(0.5), atol=1e-9)
    np.testing.assert_allclose(np.abs(quat_slerp(q0, -np.asarray(q1), 1.0)), np.abs(q1), atol=1e-9)
    db, jdb = NuscDB(str(micro["root"]), "v1.0-mini"), JNuscDB(str(micro["root"]), "v1.0-mini")
    for tok in ("ann0_0", "ann1_0", "ann2_1"):
        for max_dt in (1.5, 0.6, 0.4):
            got = chain.box_velocity(db, tok, max_dt)
            assert got.tobytes() == jchain.box_velocity(jdb, tok, max_dt).tobytes()
        # the cars move +x at 4 m/s; frames are 0.5 s apart
        np.testing.assert_allclose(chain.box_velocity(db, tok)[:2], [4.0, 0.0], atol=1e-9)
    # the middle frame's neighbours lie 1 s apart, the end frames' 0.5 s
    assert np.isnan(chain.box_velocity(db, "ann1_0", 0.9)).all()
    assert not np.isnan(chain.box_velocity(db, "ann0_0", 0.9)).any()


def test_nusc_db_boxes_at_sample_data(micro):
    """Key and interpolated sweep boxes equal the JAX reader's."""
    db, jdb = NuscDB(str(micro["root"]), "v1.0-mini"), JNuscDB(str(micro["root"]), "v1.0-mini")
    scene = db.scene[0]
    chain_sd = db.lidar_sd_chain(scene)
    assert [sd["token"] for sd in chain_sd] == [sd["token"] for sd in jdb.lidar_sd_chain(scene)]
    for sd in chain_sd:
        same_value(db.boxes_at_sample_data(sd), jdb.boxes_at_sample_data(sd), sd["token"])
    for s in db.scene_samples(scene):
        same_value(db.sample_lidar_data(s), jdb.sample_lidar_data(s))
        same_value(db.annotations_for_sample(s["token"]), jdb.annotations_for_sample(s["token"]))


@pytest.mark.parametrize("tree", ["micro", "world"])
@pytest.mark.parametrize("with_gt", [True, False])
def test_create_nuscenes_infos(tree, with_gt, request, tmp_path):
    """The infos pickle equals the JAX one: the micro tree's key frames list
    their non-key sweeps (prev chain), the world's its earlier key frames."""
    fx = request.getfixturevalue(tree)
    got = create_nuscenes_infos(str(fx["root"]), "v1.0-mini", 10, None, with_gt,
                                out_path=str(tmp_path / "port.pkl"))
    want = jcreate_nuscenes_infos(str(fx["root"]), "v1.0-mini", 10, None, with_gt,
                                  out_path=str(tmp_path / "jax.pkl"))
    same_value(got, want)
    same_value(read_artifact(str(tmp_path / "port.pkl")), want)
    assert len(got) == (3 if tree == "micro" else 12)
    # the micro tree's last key frame: 2 x (key + 2 sweeps) before it
    assert len(got[-1]["sweeps"]) == (6 if tree == "micro" else 5)


def test_dataset_reads_the_chain_tree(world, world_trees, tmp_path):
    """The port's dataset over the port's chain tree and create_data infos
    (the world has no sweeps between key frames: earlier key frames fill
    nsweeps - 1 = 9 slots) equals the JAX dataset over the JAX ones, sample
    by sample, in train mode with the gt_shasta labels."""
    pp = dict(voxel_size=(0.3, 0.3, 0.2), pc_range=(-24.0, -24.0, -3.0, 24.0, 24.0, 3.0),
              max_voxels=3000, nsweeps=10)
    ds = {}
    for side, create, mod in (("jax", jcreate_nuscenes_infos, jnusc),
                              ("port", create_nuscenes_infos, nusc)):
        split = os.path.join(world_trees[side], "val_2hz")
        info = str(tmp_path / f"{side}.pkl")
        create(str(world["root"]), "v1.0-mini", 10, None, True, out_path=info)
        ds[side] = mod.NuScenesTrackDataset(
            info_path=info, det_path=os.path.join(split, "detections/cp/sensor_individual_frames"),
            cls_info_path=os.path.join(split, "detections/cp/cls_individual_frames"),
            frame_info_path=os.path.join(world_trees[side], "val_frame_info.json"),
            labels_path=os.path.join(split, "gt_shasta/cp/individual_frames"),
            det_type=["car"], max_objects=12, test_mode=False, seed=5,
            pipeline=mod.PointPipelineConfig(**pp))
    assert len(ds["port"]) == len(ds["jax"]) == 12
    for i in (0, 1, 7, 11):
        got, want = ds["port"][i], ds["jax"][i]
        assert sorted(got) == sorted(want)
        for k in want:
            same_value(got[k], want[k], k)
    assert int(ds["port"][11]["voxels_valid"].sum()) > 0


def test_det_tools_equal_jax(world_trees, tmp_path):
    """nms_detections_npz and remove_fp_npz over the chain's per-scene det
    npz files, and filter_track_types, equal the JAX tools' outputs."""
    split = os.path.join(world_trees["port"], "val_2hz")
    # two frames of one scene: the JAX NMS runs its geometry eagerly, op by op
    det_dir, gt_dir = str(tmp_path / "dets"), os.path.join(split, "gt_info")
    os.makedirs(det_dir)
    full = read_artifact(os.path.join(split, "detections", "cp", "dets", "scene-0000.npz"))
    np.savez_compressed(os.path.join(det_dir, "scene-0000.npz"),
                        **{k: full[k][:2] for k in ("bboxes", "types")})
    for side, mod in (("jax", jdet_tools), ("port", det_tools)):
        mod.nms_detections_npz(det_dir, str(tmp_path / side / "nms"))
        mod.remove_fp_npz(det_dir, gt_dir, str(tmp_path / side / "tp"))
        mod.filter_track_types(_mixed_results(tmp_path),
                               str(tmp_path / side / "filtered" / "r.json"))
    assert same_tree(str(tmp_path / "jax"), str(tmp_path / "port")) == 3
    kept = read_artifact(str(tmp_path / "port" / "tp" / "scene-0000.npz"))["bboxes"]
    assert 0 < sum(map(len, kept)) < sum(map(len, full["bboxes"][:2]))


def _mixed_results(tmp_path) -> str:
    path = str(tmp_path / "raw.json")
    with open(path, "w") as f:
        json.dump({"results": {"t": [{"detection_name": n} for n in
                                     ("car", "barrier", "pedestrian", "traffic_cone", "bus")]},
                   "meta": {}}, f)
    return path


def test_nms_detections_npz_suppresses_overlap(tmp_path):
    """tests/test_misc_components.py::test_nms_detections_npz on the port."""
    det_dir = tmp_path / "dets"
    det_dir.mkdir()
    rows = [
        [0, 0, 0, 2, 4, 1.5, 1, 0, 0, 0, 0.9],
        [0.1, 0, 0, 2, 4, 1.5, 1, 0, 0, 0, 0.5],
        [30, 0, 0, 2, 4, 1.5, 1, 0, 0, 0, 0.8],
    ]
    np.savez_compressed(det_dir / "scene-1.npz",
                        bboxes=np.asarray([rows], dtype=object),
                        types=np.asarray([["car", "car", "car"]], dtype=object),
                        allow_pickle=True)
    det_tools.nms_detections_npz(str(det_dir), str(tmp_path / "out"))
    d = read_artifact(str(tmp_path / "out" / "scene-1.npz"))
    assert len(d["bboxes"][0]) == 2  # overlap suppressed
    filtered = tmp_path / "filtered.json"
    det_tools.filter_track_types(_mixed_results(tmp_path), str(filtered))
    names = [a["detection_name"] for a in read_artifact(str(filtered))["results"]["t"]]
    assert names == ["car", "pedestrian", "bus"]


def test_submission_equals_jax(micro, tmp_path):
    """sensor_dets_to_global_annos and write_detection_submission equal the
    JAX functions (attribute rules included), and the round trip of
    tests/test_submission_validity.py holds."""
    db, jdb = NuscDB(str(micro["root"]), "v1.0-mini"), JNuscDB(str(micro["root"]), "v1.0-mini")
    tok = micro["tokens"][0]
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(-20, 20, (8, 3)), rng.uniform(0.5, 5, (8, 3)),
                            rng.uniform(-3, 3, (8, 1)), rng.normal(0, 1, (8, 2))], 1)
    names = ["car", "bus", "pedestrian", "bicycle", "truck", "trailer", "motorcycle", "barrier"]
    scores = rng.uniform(0, 1, 8)
    same_value(sensor_dets_to_global_annos(db, tok, boxes, scores, names),
               jsensor_dets_to_global_annos(jdb, tok, boxes, scores, names))
    dets = {t: (boxes[i:i + 3], scores[i:i + 3], names[i:i + 3])
            for i, t in enumerate(micro["tokens"])}
    write_detection_submission(db, dets, str(tmp_path / "port.json"))
    jwrite_detection_submission(jdb, dets, str(tmp_path / "jax.json"))
    same_value(read_artifact(str(tmp_path / "port.json")), read_artifact(str(tmp_path / "jax.json")))
    # ego at origin, sensor at (0.9, 0, 1.8): sensor det at x=9.2 -> global 10.1
    annos = sensor_dets_to_global_annos(
        db, tok, np.array([[9.2, -0.05, 0.5 - 1.8, 2.0, 4.5, 1.6, 0.0, 4.0, 0.0]]), [0.9], ["car"])
    np.testing.assert_allclose(annos[0]["translation"][:2], [10.1, -0.05], atol=1e-6)
    assert annos[0]["attribute_name"] == "vehicle.moving"  # |v| > 0.2
    a2 = sensor_dets_to_global_annos(
        db, tok, np.array([[1.0, 0.0, 0.0, 0.6, 0.6, 1.7, 0.0, 0.0, 0.0]]), [0.8], ["pedestrian"])
    assert a2[0]["attribute_name"] == "pedestrian.standing"


def test_stats_estimator():
    """estimate_covariances equals the JAX estimator and recovers the
    measurement noise (tests/test_misc_components.py)."""
    rng = np.random.default_rng(0)
    frames = []
    x, v = np.zeros(2), np.array([2.0, 0.0])
    for _ in range(60):
        x = x + v * 0.5
        gt = np.zeros((2, 8))
        gt[:, :2] = x, x + 10
        gt[:, 4:7] = [4, 2, 1.5]
        det = gt.copy()
        det[:, :2] += rng.normal(0, 0.3, (2, 2))  # measurement noise std 0.3
        det[:, 3] = rng.normal(0, 0.1, 2)
        det[:, 7] = 0.9
        frames.append(dict(dets=det, det_types=["car", "bus"], gts=gt, gt_types=["car", "bus"],
                           gt_ids=["a", "b"]))
    P, Q, R = estimate_covariances([{"frames": frames, "dt": 0.5}])
    same_value((P, Q, R), jestimate_covariances([{"frames": frames, "dt": 0.5}]))
    assert 0.04 < R["car"][0] < 0.2  # ~0.09 variance
    assert len(P["car"]) == 11 and len(Q["car"]) == 11 and len(R["car"]) == 7

