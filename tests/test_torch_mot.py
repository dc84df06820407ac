"""The port's SimpleTrack mot/ stack against the JAX package's (CPU).

tests/test_mot.py, the mot cases of tests/test_submission_validity.py and
the stats of tests/test_misc_components.py, on the port; then MOTModel
over a small world (2 scenes x 6 frames of build_synthetic_world, through
the port's chain) for every asso x match_type against the JAX MOTModel:
track ids, state strings and validity exactly equal, Kalman states within
1e-9 (they follow from the same matches through the same numpy code, so
they are in fact equal). The port computes its iou/giou matrices in f32,
as the JAX package does; here on the CPU.

The JAX package calls its geometry eagerly, op by op: a giou_3d call takes
about a second on the CPU, and a run over the world about a minute. So the
JAX side runs the same geometry functions under jax.jit, on inputs padded
to a few fixed sizes so that each size compiles once; the pad rows lie far
from every box and are cut from the result. Each matrix entry is a
function of its own pair alone.
"""
import copy
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures_nusc
from shasta_tpu.core import geometry as jgeometry
from shasta_tpu.mot import MOTModel as JMOTModel
from shasta_tpu.mot import FrameData as JFrameData
from shasta_tpu.mot import association as jassociation
from shasta_tpu.mot import redundancy as jredundancy
from shasta_tpu.mot.covariance import NuCovariance as JNuCovariance
from shasta_tpu.mot.validity import Validity as JValidity

from shasta_tpu_torch.mot import FrameData, KalmanFilterMotionModel, MOTModel
from shasta_tpu_torch.mot.association import (associate_dets_to_tracks, compute_distance_matrix,
                                              geometry_matrix, greedy_matcher)
from shasta_tpu_torch.mot.covariance import NuCovariance
from shasta_tpu_torch.mot.hit_manager import HitManager
from shasta_tpu_torch.mot.kalman import FrameBasedKalmanFilterMotionModel
from shasta_tpu_torch.mot.mot_model import DEFAULT_CONFIG
from shasta_tpu_torch.mot.redundancy import RedundancyModule
from shasta_tpu_torch.mot.validity import Validity
from shasta_tpu_torch.preprocessing.nuscenes_chain import run_chain
from shasta_tpu_torch.tools.run_oracle_mot import scene_frames, scene_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD_SIZES = (8, 16, 32, 64, 128)


def padded_jit_geometry():
    """iou_3d and giou_3d of shasta_tpu.core.geometry under jax.jit, each
    side padded to the next of PAD_SIZES with 1 m boxes 1 km apart."""
    fns = {name: jax.jit(getattr(jgeometry, name)) for name in ("iou_3d", "giou_3d")}

    def pad(b):
        n = b.shape[0]
        size = next(s for s in PAD_SIZES if s >= n)
        far = np.zeros((size - n, 7), np.float32)
        far[:, 0] = 1000.0 * (np.arange(size - n) + 1)
        far[:, 3:6] = 1.0
        return jnp.concatenate([jnp.asarray(b, jnp.float32), jnp.asarray(far)])

    def padded(fn):
        return lambda b1, b2: fn(pad(b1), pad(b2))[:b1.shape[0], :b2.shape[0]]

    return SimpleNamespace(**{name: padded(fn) for name, fn in fns.items()})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per worker (tests/test_torch_eval.py says why)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jitted_jax_mot():
    """The JAX mot stack's geometry jitted and padded (see the docstring)."""
    mp = pytest.MonkeyPatch()
    ns = padded_jit_geometry()
    mp.setattr(jassociation, "geometry", ns)
    mp.setattr(jredundancy, "geometry", ns)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def world_data(tmp_path_factory):
    """The small world's 2 Hz val tree, written by the port's chain."""
    tmp = tmp_path_factory.mktemp("mot_world")
    fx = fixtures_nusc.build_synthetic_world(tmp, n_scenes=2, n_frames=6)
    run_chain(str(fx["root"]), "v1.0-mini", str(fx["results"]), str(tmp / "prep"), "val")
    return str(tmp / "prep" / "val_2hz")


def _mot_box(x, y, o=0.0, l=4.0, w=2.0, h=1.5, s=0.9, z=0.0):
    return np.array([x, y, z, o, l, w, h, s])


# -- tests/test_mot.py on the port -------------------------------------------

def test_kalman_convergence():
    ts = 0.0
    kf = KalmanFilterMotionModel(_mot_box(0, 0), "car", ts)
    for i in range(1, 8):
        ts = i * 0.5
        kf.get_prediction(ts)
        kf.update(_mot_box(i * 1.0, 0))
    pred = kf.get_prediction(4.0)
    # next prediction continues the motion: x ~ 7 + v*0.5 with v ~ 2 m/s
    assert 7.2 < pred[0] < 8.5, pred[0]
    assert abs(pred[1]) < 0.2


def test_kalman_yaw_flip_correction():
    kf = KalmanFilterMotionModel(_mot_box(0, 0, o=0.0), "car", 0.0)
    kf.get_prediction(0.5)
    kf.update(_mot_box(0.5, 0, o=np.pi - 0.05))
    # state yaw near +-pi (flipped), not near pi/2
    assert abs(abs(kf.x[3]) - np.pi) < 0.3, kf.x[3]


def test_hit_manager_birth_death():
    cfg = {"running": {"max_age_since_update": 2, "min_hits_to_birth": 0}}
    hm = HitManager(cfg, frame_index=5)
    assert hm.state == "alive"
    hm.predict()
    hm.update(0, 6)
    hm.predict()
    hm.update(0, 7)
    assert hm.state == "dead"


def test_association_greedy_global_order():
    pairs = greedy_matcher(np.array([[0.5, 0.1], [0.2, 0.6]]))
    assert pairs.tolist() == [[0, 1], [1, 0]]


def test_association_threshold_rejection():
    dets = np.array([_mot_box(0, 0), _mot_box(100, 100)])
    trks = np.array([_mot_box(0.2, 0), _mot_box(50, 50)])
    matches, ud, ut = associate_dets_to_tracks(dets, trks, "bipartite", "euler", 4.0)
    assert matches == [(0, 0)]
    assert 1 in ud and 1 in ut


def test_mot_model_track_lifecycle():
    m = MOTModel(device="cpu")
    d0 = np.array([_mot_box(0, 0), _mot_box(20, 0)])
    out = m.frame_mot(FrameData(dets=d0, time_stamp=0.0, det_types=["car", "car"]))
    assert len(out) == 2
    ids0 = sorted(t[1] for t in out)
    d1 = np.array([_mot_box(0.5, 0), _mot_box(20.5, 0)])
    out = m.frame_mot(FrameData(dets=d1, time_stamp=0.5, det_types=["car", "car"]))
    assert sorted(t[1] for t in out) == ids0
    # drop one target for > max_age frames; its track dies
    for i in range(2, 6):
        d = np.array([_mot_box(0.5 * i, 0)])
        m.frame_mot(FrameData(dets=d, time_stamp=0.5 * i, det_types=["car"]))
    assert len(m.trackers) == 1


def test_mot_oracle_dets_filters_fps():
    m = MOTModel(oracle="dets", device="cpu")
    fd = FrameData(
        dets=np.array([_mot_box(0, 0, s=0.9), _mot_box(50, 50, s=0.8)]), time_stamp=0.0,
        det_types=["car", "car"], gt_dets=np.array([_mot_box(0.2, 0)]),
        gt_types=["vehicle.car"], gt_ids=["a"],
    )
    assert len(m.frame_mot(fd)) == 1  # the far FP was filtered out


# -- tests/test_submission_validity.py's mot cases ---------------------------

def test_validity_strings():
    for s in ("birth_2", "alive_1_0", "alive_0_2", "alive_1_3", "dead_1", "alive_2"):
        assert Validity.valid(s) == JValidity.valid(s)
        assert Validity.notoutput(s) == JValidity.notoutput(s)
    assert Validity.valid("birth_2")
    assert Validity.valid("alive_1_0")
    assert not Validity.valid("alive_0_2")
    assert Validity.notoutput("alive_0_2")
    assert not Validity.notoutput("alive_1_0")
    assert Validity.agein2hz("alive_1_3") == 3


def test_fbkf_motion_model():
    kf = FrameBasedKalmanFilterMotionModel(np.array([0.0, 0, 0, 0, 4, 2, 1.5, 0.9]), "car", 0.0)
    for i in range(1, 6):
        kf.get_prediction(float(i))  # timestamps ignored by fbkf
        kf.update(np.array([i * 1.0, 0, 0, 0, 4, 2, 1.5, 0.9]))
    pred = kf.get_prediction(99.0)  # still one frame step
    assert 5.3 < pred[0] < 7.0, pred[0]


# -- covariances, device and dtype ------------------------------------------

def test_covariance_tables_equal_the_jax_package():
    """The stats/ copies are byte-identical and give the same tables; a KF
    with nuscenes covariances starts from them."""
    for fn in sorted(os.listdir(os.path.join(REPO, "shasta_tpu", "mot", "stats"))):
        with open(os.path.join(REPO, "shasta_tpu", "mot", "stats", fn), "rb") as f:
            want = f.read()
        with open(os.path.join(REPO, "shasta_tpu_torch", "mot", "stats", fn), "rb") as f:
            assert f.read() == want, fn
    for name in ("cp_2hz", "2hz"):
        got, want = NuCovariance(name), JNuCovariance(name)
        for t in ("P", "Q", "R"):
            for cls, m in getattr(want, t).items():
                assert np.array_equal(getattr(got, t)[cls], m), (name, t, cls)
    kf = KalmanFilterMotionModel(_mot_box(0, 0), "bus", 0.0, covariance="nuscenes_cp_2hz")
    assert np.array_equal(kf.R, JNuCovariance("cp_2hz").R["bus"])


def test_geometry_matrices_are_f32():
    """The iou/giou matrices come back as float32 (the JAX package's dtype),
    and 1 - giou of a box with itself is 0."""
    boxes = np.array([_mot_box(0, 0), _mot_box(1, 0.5, o=0.3), _mot_box(30, 0)])
    for kind in ("iou", "giou"):
        m = geometry_matrix(boxes, boxes, kind, "cpu")
        assert m.dtype == np.float32 and m.shape == (3, 3)
        d = compute_distance_matrix(boxes, boxes, kind, device="cpu")
        assert d.dtype == np.float32
        np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-6)


def test_mot_model_raises_without_a_card():
    """MOTModel and the association default to the card and raise without
    one; device="cpu" is the explicit CPU request."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MOTModel()
    boxes = np.array([_mot_box(0, 0)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_distance_matrix(boxes, boxes, "giou")
    assert MOTModel(device="cpu").device.type == "cpu"


# -- MOTModel against the JAX MOTModel over the small world ------------------

def _run(model_cls, frame_cls, cfg, data, **kw):
    """Per frame: [(id, state string, state row, type)] and the tracks'
    Kalman states (the state row of the other motion models)."""
    out = []
    for scene in scene_names(data):
        model = model_cls(cfg, **kw)
        for f in scene_frames(data, "cp", scene):
            res = model.frame_mot(frame_cls(dets=f.dets, det_types=f.det_types, gt_dets=f.gt_dets,
                                            gt_types=f.gt_types, gt_ids=f.gt_ids,
                                            time_stamp=f.time_stamp))
            out.append(([(tid, s, row, t) for row, tid, s, t in res],
                        [np.array(getattr(trk.motion_model, "x", trk.get_state()))
                         for trk in model.trackers]))
    return out


@pytest.mark.parametrize("match_type", ["bipartite", "greedy"])
@pytest.mark.parametrize("asso", ["iou", "giou", "m_dis", "euler"])
def test_mot_model_equals_jax(asso, match_type, world_data, jitted_jax_mot):
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["running"].update(asso=asso, match_type=match_type)
    got = _run(MOTModel, FrameData, cfg, world_data, device="cpu")
    want = _run(JMOTModel, JFrameData, cfg, world_data)
    assert len(got) == len(want) == 12
    n_ids = set()
    for fi, ((g_out, g_x), (w_out, w_x)) in enumerate(zip(got, want)):
        assert [(tid, s, t) for tid, s, _, t in g_out] == [(tid, s, t) for tid, s, _, t in w_out], fi
        assert [Validity.valid(s) for _, s, _, _ in g_out] == [
            JValidity.valid(s) for _, s, _, _ in w_out]
        for (_, _, g_row, _), (_, _, w_row, _) in zip(g_out, w_out):
            np.testing.assert_allclose(g_row, w_row, rtol=0, atol=1e-9)
        assert len(g_x) == len(w_x)
        for a, b in zip(g_x, w_x):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        n_ids.update(tid for tid, _, _, _ in g_out)
    assert len(n_ids) > 10


@pytest.mark.parametrize("mode", ["mm", "bbox"])
@pytest.mark.parametrize("kind", ["iou", "giou"])
def test_redundancy_matrix_columns_equal_per_track_calls(kind, mode, world_data):
    """The redundancy's one matrix per frame: each track's column equals
    the per-track call of the JAX call structure, bit for bit, on the
    world's frames and tracks; and the rescue decisions equal the
    per-track `infer`."""
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["running"]["asso"] = kind
    cfg["redundancy"]["mode"] = mode
    red = RedundancyModule(cfg, "cpu")
    checked = 0
    for scene in scene_names(world_data):
        model = MOTModel(cfg, device="cpu")
        for f in scene_frames(world_data, "cp", scene):
            cand = [d for d in f.dets if d[7] > red.det_score]
            if model.trackers and cand:
                preds = np.stack([trk.get_state() for trk in model.trackers])
                full = geometry_matrix(np.stack(cand), preds, kind, "cpu")
                for j in range(len(preds)):
                    col = geometry_matrix(np.stack(cand), preds[j:j + 1], kind, "cpu")[:, 0]
                    assert col.tobytes() == full[:, j].tobytes(), (scene, j)
                    checked += 1
                frame = red.infer_frame(model.trackers, f.dets)
                for trk, (bbox, m, _) in zip(model.trackers, frame):
                    one_bbox, one_m, _ = red.infer(trk, f.dets)
                    assert m == one_m and np.array_equal(bbox, one_bbox, equal_nan=True)
            model.frame_mot(f)
    assert checked > 20


def test_oracle_kf_and_velo_models_equal_jax(world_data, jitted_jax_mot):
    """The oracle KF prior (GT snapping), and the velo and ma motion models
    under bbox redundancy, against the JAX MOTModel on the first scene."""
    for oracle, motion, red_mode in (("kf", "kf", "mm"), ("dets", "velo", "mm"),
                                     (None, "ma", "bbox"), (None, "fbkf", "default")):
        cfg = copy.deepcopy(DEFAULT_CONFIG)
        cfg["running"]["motion_model"] = motion
        cfg["redundancy"]["mode"] = red_mode
        got = _run(MOTModel, FrameData, cfg, world_data, oracle=oracle, device="cpu")[:6]
        want = _run(JMOTModel, JFrameData, cfg, world_data, oracle=oracle)[:6]
        for (g_out, _), (w_out, _) in zip(got, want):
            assert [(tid, s) for tid, s, _, _ in g_out] == [(tid, s) for tid, s, _, _ in w_out]
            for (_, _, g_row, _), (_, _, w_row, _) in zip(g_out, w_out):
                np.testing.assert_allclose(g_row, w_row, rtol=0, atol=1e-9)


def test_stats_json_round_trip(tmp_path):
    """write_stats writes {P,Q,R}_{name}.json that NuCovariance reads."""
    from shasta_tpu_torch.preprocessing.stats import write_stats

    classes = ["car", "bus", "trailer", "truck", "pedestrian", "bicycle", "motorcycle"]
    P = {c: list(np.arange(11) + 1.0) for c in classes}
    R = {c: list(np.arange(7) + 2.0) for c in classes}
    write_stats(P, P, R, str(tmp_path), "mine")
    cov = NuCovariance("mine", stats_dir=str(tmp_path))
    assert np.array_equal(np.diag(cov.R["car"]), np.arange(7) + 2.0)
    with open(tmp_path / "Q_mine.json") as f:
        assert json.load(f) == P
