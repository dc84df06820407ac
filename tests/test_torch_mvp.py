"""ShaSTA on CenterPoint-MVP (models/shasta.py reader "dynamic", virtual
route; configs/nusc/mvp/car.py) against the benchmark's plain reference
(trackbench/reference/mvp.py: MVP's voxelization_virtual written from its
description, then the plain sparse trunk at 21 features, f32, TF32 off),
on the CPU at MVP's widths on a 41 x 64 x 64 grid of 0.075 m voxels (a few
thousand rows, about a thousand voxels), with seeded random weights.
Tolerances, each relative to max(1, the largest magnitude): the BEV map
and the descriptors 1e-5 (the voxel means' sums run in another order; the
trunk's products are the same f32 products); the voxels' count and
coordinates exact; track ids, used, keep and FN flags exact.

The file imports no JAX.
"""
import numpy as np
import pytest
import torch

from shasta_tpu_torch.models import ShastaConfig, ShastaModel
from shasta_tpu_torch.models.shasta import dynamic_sparse
from trackbench import harness
from trackbench.drivers.mvp_stream import model_config
from trackbench.gen.mvp import mvp_scenes
from trackbench.reference import model as rm
from trackbench.reference import mvp as rv
from trackbench.reference import pipelines as ref
from trackbench.tests.small_mvp import small_mvp

SEED = 2**31 + 43
HALF = 2.4


def close(got, want, tol=1e-5):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


def tiny(max_voxels=2000):
    """(configuration, mix) on the 41 x 64 x 64 grid."""
    cfg, mix = small_mvp()
    cfg["point_pipeline"].update(pc_range=[-HALF, -HALF, -5.0, HALF, HALF, 3.0])
    cfg["model"].update(pc_start=[-HALF, -HALF], grid_shape=[41, 64, 64], max_voxels=max_voxels)
    mix.update(objects=6, key_points=800, sweep_points=250, spots=150, virtual_points=12,
               cloud_rows=4400)
    return cfg, mix


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread per worker: the plain CPU path and the reference run many
    small parallel regions, which crawl when the suite's workers share the
    cores (a step ~75x slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """The tiny configuration, two scenes of three frames, the weights and
    the dynamic model holding them."""
    cfg, mix = tiny()
    scenes = mvp_scenes(SEED, mix, cfg["point_pipeline"], {"car": 10})
    trunk, heads = harness.class_weights(cfg, SEED, "cpu")
    model = ShastaModel(model_config(ShastaConfig, cfg, 10), device="cpu")
    model.load_state_dict({**trunk, **heads["car"]})
    return cfg, scenes, trunk, heads, model


def cloud(*frames):
    return {k: torch.as_tensor(np.stack([f[k] for f in frames])) for k in ("cloud", "cloud_valid")}


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_config_refuses_a_width_or_a_grid_the_reader_cannot_give():
    """The reader gives 21 features a voxel: any other width is refused.
    Its x and y range is the trunk's grid (pc_start, voxel_size,
    grid_shape), so no grid can disagree with it: a point on the grid's
    last cell is kept, one past the grid's edge or outside z_range is not."""
    with pytest.raises(ValueError, match="21 features"):
        ShastaConfig(reader="dynamic", num_input_features=5)
    cfg = ShastaConfig(reader="dynamic", num_input_features=21, pc_start=(-HALF, -HALF),
                       grid_shape=(41, 64, 64), max_voxels=8)
    last = -HALF + 63.5 * 0.075
    mid = -HALF + 32.5 * 0.075
    xyz = [(last, last, 0.1), (last + 0.075, mid, 0.1), (mid, mid, 3.1), (mid, mid, -4.9)]
    rows = torch.zeros(1, len(xyz), 16)
    rows[0, :, :3] = torch.tensor(xyz)
    rows[0, :, 14] = 1.0
    st = dynamic_sparse(cfg, rows, torch.ones(1, len(xyz), dtype=torch.bool))
    assert int(st.valid.sum()) == 2
    assert st.coords[:2].tolist() == [[0, 0, 32, 32], [0, 25, 63, 63]]


def test_reader_range_is_mvps_published_range():
    """At the cell's configuration the range the reader takes from the grid
    and z_range is MVP's published pc_range (the configuration's det3d
    reader section): a lane of rows inside and around [-54, 54]^2 x [-5, 3]
    voxelizes as dynamic_voxelize_virtual over that range."""
    from shasta_tpu_torch.models import dynamic_voxelize_virtual
    from trackbench.tests.small import load

    cfg = load("configs", "shasta-car-mvp")
    mc = model_config(ShastaConfig, cfg, 10)
    g = torch.Generator().manual_seed(7)
    rows = torch.zeros(1, 3000, 16)
    rows[0, :, :2] = torch.rand(3000, 2, generator=g) * 110.0 - 55.0
    rows[0, :, 2] = torch.rand(3000, generator=g) * 10.0 - 6.0
    rows[0, :, 14] = (torch.rand(3000, generator=g) * 3).floor() - 1
    valid = torch.ones(1, 3000, dtype=torch.bool)
    st = dynamic_sparse(mc, rows, valid)
    feats, zyx, v = dynamic_voxelize_virtual(rows[0], valid[0], cfg["reader"]["pc_range"],
                                             cfg["reader"]["voxel_size"], mc.max_voxels)
    assert 2000 < int(v.sum()) < 3000
    assert torch.equal(st.valid, v) and torch.equal(st.coords[:, 1:], zyx)
    assert torch.equal(st.feats, feats)


# ---------------------------------------------------------------------------
# the reader and the trunk against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", [1, 2])
def test_dynamic_trunk_matches_the_reference(setup, lanes):
    """B lanes of different scenes' frames: each lane's voxels (count and
    zyx exact, features 1e-5, lane index b on rows b*V + v), its BEV map
    and the descriptors sampled at its boxes (1e-5) against the
    reference's. The frames hold voxels of real points only, of painted or
    virtual points only, and of both (renormalised)."""
    cfg, scenes, trunk, _, model = setup
    frames = [scenes[0][1], scenes[1][2]][:lanes]
    tr = rv.Trunk(trunk, cfg["model"], "cpu")
    f = cloud(*frames)
    V = cfg["model"]["max_voxels"]
    with torch.no_grad():
        st = dynamic_sparse(model.cfg, f["cloud"], f["cloud_valid"])
        got = model.bev_single(f)
    assert got.shape == (lanes, 8, 8, 64)
    kinds = set()
    for b, frame in enumerate(frames):
        feats, zyx = tr.voxels(frame)
        rows = slice(b * V, (b + 1) * V)
        n = int(st.valid[rows].sum())
        assert n == len(zyx) and 300 < n < V
        assert bool(st.valid[rows][:n].all())
        assert torch.equal(st.coords[rows][:n], torch.cat(
            [torch.full((n, 1), b), zyx], 1).to(torch.int32))
        close(st.feats[rows][:n], feats)
        real, other = feats[:, :5].abs().sum(1) > 0, feats[:, 5:].abs().sum(1) > 0
        kinds |= {(bool(r), bool(o)) for r, o in zip(real, other)}
        want = tr.bev(frame)
        close(got[b], want)
        boxes = torch.as_tensor(ref.class_boxes(frame, "car", 10)[0])
        close(tr.features(got[b], boxes), tr.features(want, boxes))
    assert kinds == {(True, False), (False, True), (True, True)}


def test_step_frame_matches_the_reference_stream(setup):
    """A scene's three points frames through ScenePipeline.step_frame
    against reference/pipelines.stream on the MVP trunk: track ids
    one-to-one, used, keep and FN flags and tracker scores exact
    (rows_differ 0), the descriptors carried out of the last frame 1e-5."""
    from shasta_tpu_torch.infer import ScenePipeline, default_tracker_params
    from shasta_tpu_torch.tracker.pub_tracker import NUSCENES_TRACKING_NAMES

    cfg, scenes, trunk, heads, model = setup
    pipe = ScenePipeline(model, NUSCENES_TRACKING_NAMES.index("car"),
                         default_tracker_params(max_age=cfg["max_age"]),
                         fp_thresh=cfg["fp_elim"], decision_thresh=cfg["decision_thresh"])
    tr = rv.Trunk(trunk, cfg["model"], "cpu")
    th = (cfg["fp_elim"], cfg["decision_thresh"])
    tally = harness.Tally()
    for scene in scenes[:1]:
        pipe.reset()
        want = ref.stream(tr, heads, {"car": 10}, scene, th, cfg["max_age"])
        ids = harness.IdMap()
        for t, frame in enumerate(scene):
            boxes, n = ref.class_boxes(frame, "car", 10)
            out = pipe.step_frame(dict(cloud(frame), det_boxes=boxes[None]), n,
                                  ref.frame_lag(frame, ["car"]))
            harness.compare_rows(tally, ids, {k: getattr(out, k) for k in
                                              ("tid", "used", "ref", "keep", "fn")},
                                 want[t]["car"])
        last = scene[-1]
        b = torch.as_tensor(ref.class_boxes(last, "car", 10)[0])
        close(pipe._prev_feat[0], tr.features(tr.bev(last), b))
    assert tally.rows > 0 and tally.numbers()["rows_differ"] == 0.0


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

def _profiled_step(model, frame):
    from torch.profiler import ProfilerActivity, profile

    from shasta_tpu_torch.infer import ScenePipeline
    from shasta_tpu_torch.utils import profiler

    pipe = ScenePipeline(model, 0)
    boxes, n = ref.class_boxes(frame, "car", 10)
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pipe.step_frame(dict(cloud(frame), det_boxes=boxes[None]), n, 0.5).tid
        return {e.name for e in prof.events()}, profiler.counters()
    finally:
        profiler.reset_counters()


def test_dynamic_voxel_span_and_counters(setup):
    """A profiled step opens step.dynamic_voxel inside step.trunk, before
    step.sparse_trunk, and counts per lane the valid rows, the painted and
    virtual ones, the voxels, the slots, and no voxel dropped."""
    cfg, scenes, trunk, _, model = setup
    frame = scenes[0][0]
    names, c = _profiled_step(model, frame)
    assert {"step.trunk", "step.dynamic_voxel", "step.sparse_trunk", "step.neck"} <= names
    rows = frame["cloud"][frame["cloud_valid"]]
    n_vox = len(rv.Trunk(trunk, cfg["model"], "cpu").voxels(frame)[1])
    assert c["dynvox.points"] == [len(rows)]
    assert c["dynvox.virtual"] == [int((rows[:, 14] != 1).sum())] and 0 < c["dynvox.virtual"][0]
    assert c["dynvox.voxels"] == [n_vox]
    assert c["dynvox.slots"] == [cfg["model"]["max_voxels"]]
    assert c["dynvox.dropped"] == [0]


def test_a_frame_past_max_voxels_reports_the_dropped_voxels(setup):
    """At 300 slots the frame's ~1,000 voxels overflow: the lowest 300
    keys are kept, the rest counted as dropped."""
    cfg, scenes, trunk, heads, _ = setup
    small, _ = tiny(max_voxels=300)
    model = ShastaModel(model_config(ShastaConfig, small, 10), device="cpu")
    model.load_state_dict({**trunk, **heads["car"]})
    frame = scenes[0][0]
    _, c = _profiled_step(model, frame)
    n_vox = len(rv.Trunk(trunk, cfg["model"], "cpu").voxels(frame)[1])
    assert c["dynvox.voxels"] == [300]
    assert c["dynvox.dropped"] == [n_vox - 300] and n_vox > 300


# ---------------------------------------------------------------------------
# the two-frame forward, the CLIs' model, training
# ---------------------------------------------------------------------------

def test_bev_maps_take_both_frames_as_one_batch(setup):
    """The two-frame forward's maps: the curr and prev clouds as one batch
    of 2, each equal to its frame's own bev_single (1e-6)."""
    _, scenes, _, _, model = setup
    a, b = scenes[0][0], scenes[1][1]
    batch = {**cloud(a), **{"prev_" + k: v for k, v in cloud(b).items()}}
    with torch.no_grad():
        curr, prev = model.bev_maps(batch)
        close(curr, model.bev_single(cloud(a)), 1e-6)
        close(prev, model.bev_single(cloud(b)), 1e-6)


def test_cli_config_builds_the_published_mvp_model():
    """configs/nusc/mvp/car.py through tools/common.build_model: the
    dynamic virtual reader over [-54, 54] x [-54, 54] x [-5, 3] m at 0.075
    x 0.075 x 0.2 m into 160,000 slots, conv_input 21 -> 16, the trunk's
    16/32/64/128, the RPN to 512 and the shared conv 512 -> 64."""
    from shasta_tpu_torch.tools.common import build_model
    from shasta_tpu_torch.utils.config import Config

    cfg = Config.fromfile("configs/nusc/mvp/car.py")
    m = build_model(cfg, "cpu")
    c = m.cfg
    assert (c.reader, c.max_voxels, c.num_input_features) == ("dynamic", 160000, 21)
    assert (tuple(c.pc_start), tuple(c.z_range)) == ((-54.0, -54.0), (-5.0, 3.0))
    assert (tuple(c.voxel_size), tuple(c.grid_shape)) == ((0.075, 0.075), (41, 1440, 1440))
    assert m.trunk_names == ("backbone", "neck", "shared_conv")
    assert m.backbone.conv_input[0].weight.shape == (3, 3, 3, 21, 16)
    assert m.backbone.extra_conv[0].weight.shape == (3, 1, 1, 128, 128)
    assert m.shared_conv[0].weight.shape == (64, 512, 3, 3)
    assert set(m.state_dict()) == set(rm.trunk_spec(21)) | set(rm.head_spec(90))


def test_training_refuses_the_dynamic_reader(setup):
    from shasta_tpu_torch.train.loop import make_optimizer, make_train_step

    _, _, _, _, model = setup
    with pytest.raises(NotImplementedError, match="dynamic"):
        make_train_step(model, make_optimizer(model))
