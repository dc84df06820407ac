"""The port's renderers against the JAX package's (CPU, matplotlib Agg).

tests/test_scene_renderer.py mirrored on the port, on the micro dataroot of
tests/fixtures_nusc.py and a tracking result made from its detections: the
geometry (box_corners_3d, the flat-ego transform, the camera projection)
agrees within 1e-12; the multi-sweep cloud and the map patch are equal;
every PNG that shasta_tpu_torch.viz writes (SceneRenderer's lidar BEV and
camera images, render_scene's tree, the visualize_scene CLI's,
render_scene_tracks') decodes to exactly the pixels of the JAX renderer's
PNG for the same inputs. PNGs are compared as decoded pixels, not bytes:
matplotlib writes its version into the file's metadata.
"""
import json
import os

import numpy as np
import pytest
from PIL import Image

from fixtures_nusc import CAM_INTRINSIC, CAM_TRANS, build_micro_nusc
from test_torch_chain_cli import run_jax
from shasta_tpu.core import transforms as jtransforms
from shasta_tpu.preprocessing.nusc_db import NuscDB as JNuscDB
from shasta_tpu.viz import scene_renderer as jrenderer
from shasta_tpu.viz import visualizer2d as jvisualizer2d

from shasta_tpu_torch.core import transforms
from shasta_tpu_torch.core.boxes import yaw_to_quaternion
from shasta_tpu_torch.preprocessing.nusc_db import NuscDB
from shasta_tpu_torch.tools import visualize_scene
from shasta_tpu_torch.viz import scene_renderer as renderer
from shasta_tpu_torch.viz import visualizer2d


def pixels(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def same_pixels(a, b) -> None:
    pa, pb = pixels(a), pixels(b)
    assert pa.shape == pb.shape and np.array_equal(pa, pb), (a, b)
    assert len(np.unique(pa.reshape(-1, 4), axis=0)) > 2  # not a blank canvas


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viz")
    fx = build_micro_nusc(tmp)
    with open(fx["results"]) as f:
        results = json.load(f)["results"]
    tr = {tok: [{"sample_token": tok, "translation": d["translation"], "size": d["size"],
                 "rotation": d["rotation"], "velocity": d["velocity"],
                 "tracking_id": str(k + 1), "tracking_name": d["detection_name"],
                 "tracking_score": d["detection_score"]} for k, d in enumerate(dets)]
          for tok, dets in results.items()}
    tr_path = tmp / "tracking_result.json"
    with open(tr_path, "w") as f:
        json.dump({"results": tr, "meta": {}}, f)
    root = str(fx["root"])
    return dict(db=NuscDB(root, "v1.0-mini"), jdb=JNuscDB(root, "v1.0-mini"),
                tr_path=str(tr_path), tmp=tmp, root=root)


# -- geometry -----------------------------------------------------------------

@pytest.mark.parametrize("yaw", [0.0, np.pi / 2, -2.3, 0.7])
def test_box_corners_equal_jax(yaw):
    rng = np.random.default_rng(int(abs(yaw) * 10))
    center, size = rng.normal(0.0, 20.0, 3), rng.uniform(0.5, 5.0, 3)
    q = yaw_to_quaternion(yaw)
    got = renderer.box_corners_3d(center, size, q)
    np.testing.assert_allclose(got, jrenderer.box_corners_3d(center, size, q), rtol=0, atol=1e-12)
    assert got.shape == (8, 3)
    w, l, h = size
    local = (got - center) @ transforms.quat_to_rotmat(q)
    np.testing.assert_allclose(np.abs(local).max(axis=0), [l / 2, w / 2, h / 2], atol=1e-12)


def _project(mod, tmod, corners, pose, cs):
    """The renderer's global -> ego -> camera -> image arithmetic."""
    ego_r_inv = tmod.quat_inverse(np.asarray(pose["rotation"], np.float64))
    cam_r_inv = tmod.quat_inverse(np.asarray(cs["rotation"], np.float64))
    c = (corners - np.asarray(pose["translation"])) @ tmod.quat_to_rotmat(ego_r_inv).T
    c = (c - np.asarray(cs["translation"])) @ tmod.quat_to_rotmat(cam_r_inv).T
    uv = c @ np.asarray(cs["camera_intrinsic"], np.float64).T
    return uv[:, :2] / uv[:, 2:3]


def test_camera_projection_equals_jax(setup):
    """The fixture's tracks of samp0 projected into CAM_FRONT: within 1e-12
    of the JAX arithmetic; a box 10 m ahead lands below the principal point
    by the analytic amount (tests/test_scene_renderer.py)."""
    db, jdb = setup["db"], setup["jdb"]
    sample = db.get("sample", "samp0")
    sd = renderer.SceneRenderer(db)._sample_data_for_channel(sample, "CAM_FRONT")
    assert sd == jrenderer.SceneRenderer(jdb)._sample_data_for_channel(
        jdb.get("sample", "samp0"), "CAM_FRONT")
    pose = db.get("ego_pose", sd["ego_pose_token"])
    cs = db.get("calibrated_sensor", sd["calibrated_sensor_token"])
    tracks = renderer.load_tracks(setup["tr_path"])["samp0"]
    assert tracks == jrenderer.load_tracks(setup["tr_path"])["samp0"]
    boxes = [(t["translation"], t["size"], t["rotation"]) for t in tracks]
    boxes.append(([10.0, 0.0, 0.5], [2.0, 4.0, 1.5], yaw_to_quaternion(0.0)))
    for box in boxes:
        got = _project(renderer, transforms, renderer.box_corners_3d(*box), pose, cs)
        want = _project(jrenderer, jtransforms, jrenderer.box_corners_3d(*box), pose, cs)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    K = np.asarray(CAM_INTRINSIC)
    assert cs["camera_intrinsic"] == CAM_INTRINSIC and cs["translation"] == CAM_TRANS
    assert abs(got[:, 1].mean() - (K[1, 2] + 400.0 * 1.0 / 8.5)) < 25


def test_flat_ego_sweeps_and_map_patch_equal_jax(setup):
    db, jdb = setup["db"], setup["jdb"]
    r, jr = renderer.SceneRenderer(db), jrenderer.SceneRenderer(jdb)
    pts = np.random.default_rng(2).normal(0.0, 30.0, (50, 3))
    for tok in ("samp0", "samp1", "samp2"):
        sample, jsample = db.get("sample", tok), jdb.get("sample", tok)
        pose = db.get("ego_pose", db.sample_lidar_data(sample)["ego_pose_token"])
        np.testing.assert_allclose(renderer._flat_ego_transform(pose)(pts),
                                   jrenderer._flat_ego_transform(pose)(pts), rtol=0, atol=1e-12)
        for nsweeps in (1, 10):
            got = r._load_lidar_sweeps(sample, nsweeps)
            assert np.array_equal(got, jr._load_lidar_sweeps(jsample, nsweeps)) and len(got)
        patch = r._map_patch(sample, 40.0)
        assert patch is not None and np.array_equal(patch, jr._map_patch(jsample, 40.0))
        assert set(np.unique(patch)) <= {125, 255}


# -- renders: decoded pixels equal ---------------------------------------------

@pytest.mark.parametrize("kw", [dict(nsweeps=10, underlay_map=True),
                                dict(nsweeps=1, underlay_map=False, gt_class=None,
                                     with_ids=False)])
def test_render_lidar_bev_pixels_equal_jax(kw, setup, tmp_path):
    tracks = renderer.load_tracks(setup["tr_path"])["samp1"]
    got = renderer.SceneRenderer(setup["db"]).render_lidar_bev(
        "samp1", tracks, str(tmp_path / "port" / "bev.png"), **kw)
    want = jrenderer.SceneRenderer(setup["jdb"]).render_lidar_bev(
        "samp1", tracks, str(tmp_path / "jax" / "bev.png"), **kw)
    same_pixels(got, want)


def test_render_camera_pixels_equal_jax(setup, tmp_path):
    tracks = renderer.load_tracks(setup["tr_path"])["samp0"]
    r, jr = renderer.SceneRenderer(setup["db"]), jrenderer.SceneRenderer(setup["jdb"])
    got = r.render_camera("samp0", tracks, str(tmp_path / "port.png"), channel="CAM_FRONT")
    want = jr.render_camera("samp0", tracks, str(tmp_path / "jax.png"), channel="CAM_FRONT")
    same_pixels(got, want)
    assert r.render_camera("samp0", tracks, str(tmp_path / "x.png"), channel="CAM_BACK") is None
    assert not os.path.exists(tmp_path / "x.png")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_visualize_scene_equals_jax(setup, tmp_path, monkeypatch, capsys):
    """The CLI (render_scene: 3 key frames x LIDAR_TOP + CAM_FRONT) writes
    the JAX tool's files, line and pixels."""
    base = ["--dataroot", setup["root"], "--version", "v1.0-mini", "--scene_name", "scene-0001",
            "--render_class", "car", "--track_result_path", setup["tr_path"], "--nsweeps", "2"]
    capsys.readouterr()
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    written = visualize_scene.main(base + ["--save_path", port])
    out = capsys.readouterr().out
    assert out == f"wrote 6 frames under {port}\n"
    assert run_jax("visualize_scene", base + ["--save_path", jax], monkeypatch) == 0
    assert capsys.readouterr().out == f"wrote 6 frames under {jax}\n"
    rel = _files(port)
    assert rel == _files(jax) == sorted(os.path.relpath(w, port) for w in written)
    assert sum("lidar/" in f for f in rel) == sum("front-camera/" in f for f in rel) == 3
    for f in rel:
        same_pixels(os.path.join(port, f), os.path.join(jax, f))


def test_render_scene_all_classes_no_map_equals_jax(setup, tmp_path):
    kw = dict(render_class=None, channels=("LIDAR_TOP",), nsweeps=1, underlay_map=False)
    got = renderer.render_scene(setup["db"], "scene-0001", setup["tr_path"],
                                str(tmp_path / "port"), **kw)
    want = jrenderer.render_scene(setup["jdb"], "scene-0001", setup["tr_path"],
                                  str(tmp_path / "jax"), **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == [
        os.path.relpath(p, tmp_path / "jax") for p in want]
    assert len(got) == 3
    for a, b in zip(got, want):
        same_pixels(a, b)


@pytest.mark.parametrize("max_frames", [None, 2])
def test_render_scene_tracks_pixels_equal_jax(max_frames, setup, tmp_path):
    results = renderer.load_tracks(setup["tr_path"])
    results["samp2"] = results["samp2"] + [dict(results["samp2"][0], tracking_id="t-x")]
    got = visualizer2d.render_scene_tracks(results, str(tmp_path / "port.png"), max_frames)
    want = jvisualizer2d.render_scene_tracks(results, str(tmp_path / "jax.png"), max_frames)
    assert got == str(tmp_path / "port.png")
    same_pixels(got, want)


def test_visualizer2d_handlers_pixels_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    pc = rng.normal(0.0, 10.0, (300, 3))
    boxes = np.concatenate([rng.normal(0.0, 10.0, (3, 3)), rng.uniform(-3, 3, (3, 1)),
                            rng.uniform(1.0, 5.0, (3, 3)), rng.random((3, 1))], axis=1)
    for mod, name in ((visualizer2d, "port"), (jvisualizer2d, "jax")):
        viz = mod.Visualizer2D(name="frame", figsize=(4, 4))
        viz.handler_pc(pc)
        viz.handler_box(boxes[0], message="7", color="blue", linestyle="dashed")
        viz.handler_tracks({3: list(boxes), 25: [boxes[1]]})
        viz.save(str(tmp_path / f"{name}.png"))
        viz.close()
    same_pixels(tmp_path / "port.png", tmp_path / "jax.png")
