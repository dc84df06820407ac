"""The port's Waymo readers and extraction against the JAX package's (CPU).

tests/test_waymo*.py mirrored on the port: the same numpy-seeded inputs go
through shasta_tpu.data.{tfrecord,waymo_protos,waymo_decode,waymo},
shasta_tpu.preprocessing.waymo_ground and tools/extract_waymo.py /
tools/create_data.py --waymo, and through their ports. Both sides run the
same float64 numpy, so arrays must be exactly equal; TFRecord and Objects
.bin files carry no timestamps and must be byte-equal; npz and pkl
artifacts are compared by content (np.savez_compressed zips carry
timestamps). The runtime's crc32c equals its plain version and the JAX
function. create_pd_detection draws uuid4 ids for tracks: every other
field is equal, and the ids are 32 hex characters that group objects as
the JAX file's do. The raw segments come from the port's
data.synthetic.build_synthetic_waymo at small widths; MOTModel over a
Waymo scene runs on the CPU against the JAX MOTModel (its geometry jitted
as in tests/test_torch_mot.py): ids and summaries exactly equal.
"""
import os
import pickle
import re
import warnings
import zlib

import numpy as np
import pytest

from test_torch_chain import read_artifact, same_tree, same_value
from test_torch_chain_cli import run_jax
from test_torch_mot import padded_jit_geometry
from shasta_tpu.data import tfrecord as jtfrecord
from shasta_tpu.data import waymo as jwaymo
from shasta_tpu.data import waymo_decode as jdecode
from shasta_tpu.data import waymo_protos as jwp
from shasta_tpu.mot import MOTModel as JMOTModel
from shasta_tpu.mot import association as jassociation
from shasta_tpu.mot import redundancy as jredundancy
from shasta_tpu.preprocessing import waymo_ground as jground

from shasta_tpu_torch.data import tfrecord, waymo, waymo_decode
from shasta_tpu_torch.data import waymo_protos as wp
from shasta_tpu_torch.data.synthetic import build_synthetic_waymo, write_waymo_pkl_tree
from shasta_tpu_torch.mot import MOTModel
from shasta_tpu_torch.preprocessing import waymo_ground
from shasta_tpu_torch.tools import create_data, extract_waymo

SMALL = dict(n_segments=2, n_frames=4, top_hw=(8, 64), side_hw=(4, 32), n_objects=8,
             dets_per_frame=14)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Two small synthetic segments (records, gt.bin, dets.bin)."""
    return build_synthetic_waymo(tmp_path_factory.mktemp("waymo_raw"), **SMALL)


def fields(pb):
    """A decoded message (either package's PB) as plain nested values."""
    if hasattr(pb, "_fields"):
        return {"msg": pb._msg_name, **{k: fields(v) for k, v in pb._fields.items()}}
    if isinstance(pb, list):
        return [fields(v) for v in pb]
    return pb


def _rt(yaw, t):
    m = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = t
    return m


# -- TFRecord framing -------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 9, 1000, 65537])
def test_crc32c_equals_plain_and_jax(n):
    data = b"123456789" if n == 9 else np.random.default_rng(n).bytes(n)
    for seed in (0, 0x1234ABCD):
        got = tfrecord.crc32c(data, seed)
        assert got == tfrecord._crc32c_py(data, seed) == jtfrecord.crc32c(data, seed)
    if n == 9:  # RFC 3720's test vector
        assert tfrecord.crc32c(data) == 0xE3069283
    assert tfrecord.masked_crc(data) == jtfrecord.masked_crc(data)


def test_tfrecord_bytes_equal_jax(tmp_path):
    payloads = [b"hello", b"", np.random.default_rng(0).bytes(1000)]
    tfrecord.write_tfrecord(str(tmp_path / "port.tfrecord"), payloads)
    jtfrecord.write_tfrecord(str(tmp_path / "jax.tfrecord"), payloads)
    port = (tmp_path / "port.tfrecord").read_bytes()
    assert port == (tmp_path / "jax.tfrecord").read_bytes()
    assert list(tfrecord.read_tfrecord(str(tmp_path / "jax.tfrecord"), verify_crc=True)) == payloads
    raw = bytearray(port)
    raw[13] ^= 0xFF  # a payload byte
    (tmp_path / "bad.tfrecord").write_bytes(bytes(raw))
    with pytest.raises(IOError, match="payload CRC mismatch"):
        list(tfrecord.read_tfrecord(str(tmp_path / "bad.tfrecord"), verify_crc=True))
    assert len(list(tfrecord.read_tfrecord(str(tmp_path / "bad.tfrecord")))) == 3


# -- the proto codec --------------------------------------------------------

def _label(x, y, lid, typ=1, num_points=10):
    return {"box": {"center_x": float(x), "center_y": float(y), "center_z": 0.5,
                    "heading": 0.1, "length": 4.5, "width": 2.0, "height": 1.6},
            "type": typ, "id": lid, "num_lidar_points_in_box": num_points,
            "metadata": {"speed_x": 1.0, "speed_y": 0.0}}


CODEC_CASES = {
    "objects": ("Objects", {"objects": [
        {"object": {"box": {"center_x": 1.5, "center_y": -2.25, "center_z": 0.5, "length": 4.2,
                            "width": 1.8, "height": 1.6, "heading": -0.3},
                    "type": 1, "id": "trk-7", "num_lidar_points_in_box": 42,
                    "metadata": {"speed_x": 1.0, "speed_y": -0.5}},
         "score": 0.875, "frame_timestamp_micros": 1550083467346370,
         "context_name": "segment-123"},
        {"object": {"box": {"center_x": 0.0}, "type": 4}, "score": 0.25,
         "frame_timestamp_micros": 1550083467446370, "context_name": "segment-123"}]}),
    "negative varint": ("Objects", {"objects": [
        {"frame_timestamp_micros": -5, "score": 0.0, "context_name": "s"}]}),
    "frame": ("Frame", {
        "context": {"name": "ctx-1", "stats": {"location": "location_sf", "time_of_day": "Day"},
                    "laser_calibrations": [{"name": 1, "beam_inclinations": [-0.3, -0.1, 0.05],
                                            "beam_inclination_min": -0.3,
                                            "extrinsic": {"transform": list(range(16))}}]},
        "timestamp_micros": 1550083467346370,
        "pose": {"transform": [float(v) for v in np.arange(16)]},
        "lasers": [{"name": 1, "ri_return1": {"range_image_compressed": b"RI",
                                              "range_image_pose_compressed": b"POSE"}}],
        "laser_labels": [_label(10, 0, "a"), _label(20, 5, "b", 2, 0)]}),
    "label": ("Label", dict(_label(1, 2, "obj-1"), detection_difficulty_level=2,
                            tracking_difficulty_level=1)),
    "matrix float": ("MatrixFloat", {"data": [0.5, -1.25, 3.0, 1e-3],
                                     "shape": {"dims": [2, 2]}}),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_equals_jax(case):
    name, value = CODEC_CASES[case]
    data = wp.encode(name, value)
    assert data == jwp.encode(name, value)
    assert fields(wp.decode(name, data)) == fields(jwp.decode(name, data))
    if name == "Objects":
        assert wp.encode_objects(value["objects"]) == jwp.encode_objects(value["objects"])
        assert fields(wp.parse_objects(data)) == fields(jwp.parse_objects(data))
    if name == "Frame":
        assert wp.encode_frame(value) == jwp.encode_frame(value)
        got, want = wp.parse_frame(data), jwp.parse_frame(data)
        assert fields(got) == fields(want)
        # proto defaults of absent fields
        assert (got.lasers[0].ri_return2.range_image_compressed, got.laser_labels[0].type,
                got.context.stats.weather, got.laser_labels[1].tracking_difficulty_level) == (
            want.lasers[0].ri_return2.range_image_compressed, want.laser_labels[0].type,
            want.context.stats.weather, want.laser_labels[1].tracking_difficulty_level) == (
            b"", 1, "", 0)


@pytest.mark.parametrize("shape", [(8, 64, 4), (4, 16, 6), (3,)])
def test_matrix_float_decode_equals_jax(shape):
    """decode_matrix_float equals the JAX module's per-value decode, on the
    packed form encode_matrix_float writes and on the one-tag-per-value form
    of `encode`; the JAX decoder reads the packed form too."""
    values = np.random.default_rng(len(shape)).normal(0.0, 10.0, shape).astype(np.float32)
    packed = wp.encode_matrix_float(values)
    per_value = jwp.encode("MatrixFloat", {"data": [float(v) for v in values.reshape(-1)],
                                           "shape": {"dims": list(shape)}})
    for data in (packed, per_value):
        want = jdecode._matrix_float(jwp.decode("MatrixFloat", data))
        got = wp.decode_matrix_float(data)
        assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
        assert np.array_equal(got, values.astype(np.float64))


# -- range images, objects, poses --------------------------------------------

@pytest.mark.parametrize("pixel_pose", [False, True])
def test_range_image_to_points_equals_jax(pixel_pose):
    rng = np.random.default_rng(3)
    H, W = 8, 64
    ri = np.zeros((H, W, 4))
    ri[..., 0] = rng.uniform(1.0, 50.0, (H, W))
    ri[..., 1:] = rng.normal(size=(H, W, 3))
    ri[rng.random((H, W)) < 0.2, 0] = -1.0
    incl = np.linspace(0.3, -0.3, H)
    ext = _rt(0.7, [1.2, -0.5, 2.0])
    kw = {}
    if pixel_pose:
        fp = _rt(0.4, [100.0, 50.0, 1.0])
        pp = np.broadcast_to(fp, (H, W, 4, 4)).copy()
        pp[..., :3, 3] += rng.normal(0.0, 0.3, (H, W, 3))
        kw = dict(pixel_pose=pp, frame_pose=fp)
    got = waymo_decode.range_image_to_points(ri, ext, incl, **kw)
    want = jdecode.range_image_to_points(ri, ext, incl, **kw)
    assert got[0].shape == (int((ri[..., 0] > 0).sum()), 6)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="frame_pose"):
        waymo_decode.range_image_to_points(ri, ext, incl, pixel_pose=np.zeros((H, W, 4, 4)))


def test_pose_helpers_equal_jax():
    rng = np.random.default_rng(4)
    assert np.array_equal(waymo_decode.compute_inclination((-0.5, 0.5), 7),
                          jdecode.compute_inclination((-0.5, 0.5), 7))
    R = _rt(0.6, [0, 0, 0])[:3, :3]
    assert waymo_decode.global_vel_to_ref([2.0, 1.0], R) == jdecode.global_vel_to_ref([2.0, 1.0], R)
    pose = _rt(1.1, [5, -3, 2])
    for a, b in zip(waymo_decode.veh_pos_to_transform(pose), jdecode.veh_pos_to_transform(pose)):
        assert np.array_equal(a, b)
    angles = rng.uniform(-np.pi, np.pi, (3, 4, 5))
    assert np.array_equal(waymo_decode._rotation_matrix(*angles), jdecode._rotation_matrix(*angles))
    names = ["seq_1_frame_10.pkl", "seq_0_frame_2.pkl", "seq_1_frame_9.pkl", "seq_0_frame_11.pkl"]
    assert waymo_decode.sort_frame(names) == jdecode.sort_frame(names)


def _frames(raw):
    """The parsed frames of both segments, by each package."""
    out = []
    for rec in sorted(os.listdir(raw["records"])):
        for payload in tfrecord.read_tfrecord(os.path.join(raw["records"], rec)):
            out.append((wp.parse_frame(payload), jwp.parse_frame(payload)))
    return out


def test_decode_frame_and_annos_equal_jax(raw):
    """Every frame of the synthetic segments: five lasers, two returns, the
    TOP lidar's pixel pose, side lasers with an inclination range alone."""
    frames = _frames(raw)
    assert len(frames) == SMALL["n_segments"] * SMALL["n_frames"]
    for i, (frame, jframe) in enumerate(frames):
        assert fields(frame) == fields(jframe)
        assert waymo_decode.frame_name(frame) == jdecode.frame_name(jframe)
        got, want = waymo_decode.decode_frame(frame, i), jdecode.decode_frame(jframe, i)
        same_value(got, want)
        assert len(got["lidars"]["points_xyz"]) > 0.8 * 8 * 64
        same_value(waymo_decode.decode_annos(frame, i), jdecode.decode_annos(jframe, i))
    objs = waymo_decode.extract_objects(frame.laser_labels, np.eye(3))
    same_value(objs, jdecode.extract_objects(jframe.laser_labels, np.eye(3)))
    assert {o["combined_difficulty_level"] for o in objs} <= {1, 2}


def test_zero_point_frame_warns_as_jax():
    """Every return empty: both warn (RuntimeWarning) and return empty clouds."""
    frame = {"context": {"name": "seg-0", "laser_calibrations": [
        {"name": 2, "beam_inclination_min": -0.1, "beam_inclination_max": 0.1,
         "extrinsic": {"transform": [float(v) for v in np.eye(4).reshape(-1)]}}]},
        "pose": {"transform": [float(v) for v in np.eye(4).reshape(-1)]},
        "lasers": [{"name": 2, "ri_return1": {}, "ri_return2": {}}]}
    data = wp.encode_frame(frame)
    outs = []
    for mod, proto in ((waymo_decode, wp), (jdecode, jwp)):
        with pytest.warns(RuntimeWarning, match="zero points"):
            outs.append(mod.extract_points(*(lambda f: (f.lasers, f.context.laser_calibrations,
                                                        f.pose))(proto.parse_frame(data))))
    same_value(outs[0], outs[1])
    assert outs[0]["points_xyz"].shape == (0, 3)


# -- GPF ground removal -------------------------------------------------------

def test_get_ground_equals_jax(raw):
    rng = np.random.default_rng(1)
    floor = np.concatenate([rng.uniform(-20, 20, (500, 2)), rng.normal(0, 0.02, (500, 1))], 1)
    box = np.concatenate([rng.uniform(-2, 2, (100, 2)), rng.uniform(1.0, 2.0, (100, 1))], 1)
    frame, _ = _frames(raw)[0]
    cloud = waymo_decode.decode_frame(frame, 0)["lidars"]["points_xyz"]
    for pts in (np.concatenate([floor, box]), cloud, np.concatenate([cloud, cloud[:, :2]], 1)):
        got, want = waymo_ground.get_ground(pts), jground.get_ground(pts)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(got[0]) > 0 and len(got[1]) > 0


# -- the extraction tree and its CLI -------------------------------------------

@pytest.mark.parametrize("flags, n_files", [
    ([], 2 * 3),  # ts_info, ego_info, gt_info (in-record labels)
    (["--gt_bin", "{gt}", "--det_bin", "{det}", "--det_name", "pp"], 2 * 4),
    (["--no_frame_gt", "--det_bin", "{det}", "--raw_pc", "--ground_removal"], 2 * 6),
])
def test_extract_waymo_equals_jax(flags, n_files, raw, tmp_path, monkeypatch, capsys):
    base = ["--data_folder", str(raw["records"])] + [
        f.format(gt=raw["gt_bin"], det=raw["det_bin"]) for f in flags]
    capsys.readouterr()
    segs = extract_waymo.main(base + ["--output_folder", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    assert run_jax("extract_waymo", base + ["--output_folder", str(tmp_path / "jax")],
                   monkeypatch) == 0
    assert capsys.readouterr().out == port_out
    assert segs == sorted(f.split(".")[0] for f in os.listdir(raw["records"]))
    assert same_tree(str(tmp_path / "jax"), str(tmp_path / "port")) == n_files


def test_objects_bins_equal_jax(raw, tmp_path):
    """write_objects_bin's bytes, decode_objects_bin's trees (GT and dets
    with velocities) and the bins decoded back."""
    out = str(tmp_path / "mot")
    segs = [waymo.extract_waymo_segment(os.path.join(raw["records"], f), out, with_gt=False)
            for f in sorted(os.listdir(raw["records"]))]
    for sub, bin_path, velo in (("gt_info", raw["gt_bin"], False),
                                ("dets", raw["det_bin"], True)):
        got = waymo.decode_objects_bin(str(bin_path), out, f"port_{sub}", with_velocity=velo)
        want = jwaymo.decode_objects_bin(str(bin_path), out, f"jax_{sub}", with_velocity=velo)
        assert got == want == segs
        assert same_tree(os.path.join(out, f"jax_{sub}"), os.path.join(out, f"port_{sub}")) == 2
    rng = np.random.default_rng(5)
    segments = {seg: {"timestamps": ts, "frames": [
        [{"bbox": rng.normal(size=8).tolist(), "type": int(t), "id": None if k % 3 else f"t{k}"}
         for k, t in enumerate(rng.choice([1, 2, 4], 5))] for _ in ts]}
        for seg, ts in zip(segs, raw["timestamps"])}
    n = waymo.write_objects_bin(segments, str(tmp_path / "port.bin"))
    assert n == jwaymo.write_objects_bin(segments, str(tmp_path / "jax.bin")) == 2 * 4 * 5
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    waymo.decode_objects_bin(str(tmp_path / "port.bin"), out, "back")
    back = read_artifact(os.path.join(out, "back", segs[0] + ".npz"))
    np.testing.assert_allclose(np.asarray(back["bboxes"][1], float)[:, :7],
                               np.asarray([d["bbox"][:7] for d in segments[segs[0]]["frames"][1]]))
    with pytest.raises(FileNotFoundError):
        waymo.extract_waymo_segment(str(tmp_path / "missing.tfrecord"), out)


@pytest.fixture(scope="module")
def mot_tree(raw, tmp_path_factory):
    """The segments extracted with the GT and detection bins."""
    out = str(tmp_path_factory.mktemp("waymo_mot"))
    extract_waymo.main(["--data_folder", str(raw["records"]), "--output_folder", out,
                        "--gt_bin", str(raw["gt_bin"]), "--det_bin", str(raw["det_bin"])])
    return out


def _track(model_cls, out, seg, mod, **kw):
    """Per frame [(id, state string, type)], the rows, and the frames as
    eval_waymo_tracking takes them."""
    model = model_cls(**kw)
    scene = mod.load_waymo_scene(out, seg)
    res = [model.frame_mot(fd) for fd in mod.waymo_scene_to_mot_frames(scene)]
    return ([[(tid, s, t) for _, tid, s, t in r] for r in res], [[row for row, *_ in r] for r in res],
            [[{"id": tid, "bbox": row, "type": t} for row, tid, _, t in r] for r in res])


def test_waymo_scene_tracking_equals_jax(raw, mot_tree, monkeypatch):
    ns = padded_jit_geometry()
    monkeypatch.setattr(jassociation, "geometry", ns)
    monkeypatch.setattr(jredundancy, "geometry", ns)
    results, jresults = {}, {}
    for seg in sorted(f.split(".")[0] for f in os.listdir(raw["records"])):
        scene, jscene = waymo.load_waymo_scene(mot_tree, seg), jwaymo.load_waymo_scene(mot_tree, seg)
        same_value(vars(scene), vars(jscene))
        fd = next(waymo.waymo_scene_to_mot_frames(scene))
        jfd = next(jwaymo.waymo_scene_to_mot_frames(jscene))
        same_value({k: v for k, v in vars(fd).items()}, {k: v for k, v in vars(jfd).items()})
        ids, rows, results[seg] = _track(MOTModel, mot_tree, seg, waymo, device="cpu")
        jids, jrows, jresults[seg] = _track(JMOTModel, mot_tree, seg, jwaymo)
        assert ids == jids and sum(map(len, ids)) > 0
        for a, b in zip(rows, jrows):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-9)
    got = waymo.eval_waymo_tracking(mot_tree, results)
    assert got == jwaymo.eval_waymo_tracking(mot_tree, jresults)
    assert list(got) == ["vehicle", "pedestrian", "cyclist"] and got["vehicle"]["num_gt"] > 0
    for types, dist in (((1,), 1.0), ((2, 4), 3.0)):
        assert (waymo.eval_waymo_tracking(mot_tree, results, types, dist)
                == jwaymo.eval_waymo_tracking(mot_tree, jresults, types, dist))


# -- the pkl tree, infos, sweeps and official-format bins ---------------------

@pytest.fixture(scope="module")
def pkl_tree(raw, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo_pkl"))
    names = write_waymo_pkl_tree(str(raw["records"]), root, "train")
    assert len(names) == SMALL["n_segments"] * SMALL["n_frames"]
    return root


def test_pkl_tree_equals_jax_decoders(raw, pkl_tree, tmp_path):
    """write_waymo_pkl_tree's tree equals one written with the JAX decoders."""
    for s, rec in enumerate(sorted(os.listdir(raw["records"]))):
        for f, payload in enumerate(jtfrecord.read_tfrecord(os.path.join(raw["records"], rec))):
            frame = jwp.parse_frame(payload)
            for sub, obj in (("lidar", jdecode.decode_frame(frame, f)),
                             ("annos", jdecode.decode_annos(frame, f))):
                os.makedirs(tmp_path / "train" / sub, exist_ok=True)
                with open(tmp_path / "train" / sub / f"seq_{s}_frame_{f}.pkl", "wb") as fh:
                    pickle.dump(obj, fh)
    assert same_tree(str(tmp_path / "train"), os.path.join(pkl_tree, "train")) == 2 * 8


@pytest.mark.parametrize("nsweeps", [1, 3])
def test_create_data_waymo_equals_jax(nsweeps, pkl_tree, tmp_path, monkeypatch, capsys):
    """The infos (fill_infos' sweep chains, KITTI boxes, zero-point filter),
    the CLI's pkl and line, and load_waymo_points over them."""
    frames = waymo_decode.get_available_frames(pkl_tree, "train")
    assert frames == jdecode.get_available_frames(pkl_tree, "train")
    infos = waymo_decode.fill_infos(pkl_tree, frames, "train", nsweeps)
    same_value(infos, jdecode.fill_infos(pkl_tree, frames, "train", nsweeps))
    capsys.readouterr()
    path = create_data.main(["--waymo", "--dataroot", pkl_tree, "--nsweeps", str(nsweeps)])
    port_out, got = capsys.readouterr().out, read_artifact(path)
    assert run_jax("create_data", ["--waymo", "--dataroot", pkl_tree, "--nsweeps", str(nsweeps)],
                   monkeypatch) == 0
    assert capsys.readouterr().out == port_out == f"wrote waymo infos -> {path}\n"
    same_value(read_artifact(path), got)
    same_value(got, infos)
    same_value(waymo_decode.reorganize_info(infos), jdecode.reorganize_info(infos))
    for info in (infos[0], infos[-1]):
        pts = waymo_decode.load_waymo_points(info, nsweeps)
        same_value(pts, jdecode.load_waymo_points(info, nsweeps))
        assert pts.shape[1] == (5 if nsweeps == 1 else 6)
    assert any(len(i["gt_boxes"]) for i in infos)


@pytest.mark.parametrize("tracking", [False, True])
def test_create_pd_detection_equals_jax(tracking, pkl_tree, tmp_path):
    """Every field equal but the tracks' uuid4 ids: 32 hex characters that
    group the objects as the JAX file's do."""
    frames = waymo_decode.get_available_frames(pkl_tree, "train")
    infos = waymo_decode.reorganize_info(waymo_decode.fill_infos(pkl_tree, frames, "train"))
    rng = np.random.default_rng(6)
    dets = {tok: {"box3d_lidar": rng.normal(size=(4, 7)), "scores": rng.random(4),
                  "label_preds": rng.integers(0, 3, 4), "tracking_ids": rng.integers(0, 5, 4)}
            for tok in frames}
    objs = []
    for mod, proto, sub in ((waymo_decode, wp, "port"), (jdecode, jwp, "jax")):
        os.makedirs(tmp_path / sub)
        path = mod.create_pd_detection(dets, infos, str(tmp_path / sub), tracking=tracking)
        assert os.path.basename(path) == ("tracking_pred.bin" if tracking else "detection_pred.bin")
        with open(path, "rb") as f:
            objs.append([fields(o) for o in proto.parse_objects(f.read()).objects])
    got, want = objs
    assert len(got) == len(want) == 4 * len(frames)
    ids = [(g["object"].pop("id", None), w["object"].pop("id", None)) for g, w in zip(got, want)]
    assert got == want
    if tracking:
        assert all(re.fullmatch(r"[0-9a-f]{32}", a) for a, _ in ids)
        groups = {}
        for a, b in ids:
            groups.setdefault(a, set()).add(b)
        assert all(len(v) == 1 for v in groups.values())
        assert len(groups) == len({b for _, b in ids}) == 5
    else:
        assert ids == [(None, None)] * len(ids)


def test_create_gt_detection_bytes_equal_jax(pkl_tree, tmp_path):
    frames = waymo_decode.get_available_frames(pkl_tree, "train")
    infos = waymo_decode.fill_infos(pkl_tree, frames, "train")
    for mod, sub in ((waymo_decode, "port"), (jdecode, "jax")):
        os.makedirs(tmp_path / sub)
        mod.create_gt_detection(infos, str(tmp_path / sub))
    got = (tmp_path / "port" / "gt_preds.bin").read_bytes()
    assert got == (tmp_path / "jax" / "gt_preds.bin").read_bytes()
    assert 0 < len(wp.parse_objects(got).objects) < SMALL["n_objects"] * len(frames)


def test_extract_raw_pc_equals_jax(raw, tmp_path):
    rec = os.path.join(raw["records"], sorted(os.listdir(raw["records"]))[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        seg = waymo_decode.extract_raw_pc(rec, str(tmp_path / "port"))
    assert seg == jdecode.extract_raw_pc(rec, str(tmp_path / "jax"))
    assert same_tree(str(tmp_path / "jax"), str(tmp_path / "port")) == 1
    pc = read_artifact(str(tmp_path / "port" / (seg + ".npz")))
    assert list(pc) == [str(i) for i in range(SMALL["n_frames"])]
    assert all(v.dtype == np.float32 and v.shape[1] == 3 for v in pc.values())


def test_builder_compresses_with_zlib(raw):
    """The range images are zlib-compressed packed MatrixFloats of the
    real layout: (H, W, 4) per return, (H, W, 6) pixel pose on TOP."""
    frame, _ = _frames(raw)[0]
    top = next(las for las in frame.lasers if las.name == 1)
    ri = wp.decode_matrix_float(zlib.decompress(top.ri_return1.range_image_compressed))
    pose = wp.decode_matrix_float(zlib.decompress(top.ri_return1.range_image_pose_compressed))
    assert ri.shape == SMALL["top_hw"] + (4,) and pose.shape == SMALL["top_hw"] + (6,)
    side = next(las for las in frame.lasers if las.name == 3)
    assert not side.ri_return1.range_image_pose_compressed
    cal = next(c for c in frame.context.laser_calibrations if c.name == 3)
    assert cal.beam_inclinations == [] and cal.beam_inclination_max > cal.beam_inclination_min
