"""ShaSTA on CenterPoint-PointPillars (models/shasta.py reader "pillars",
configs/nusc/pp/car.py) against the benchmark's plain reference
(trackbench/reference/pillars.py: det3d's modules as written, f32, TF32
off), on the CPU at the published channel widths on a 64 x 64 canvas of
0.2 m pillars (about a thousand filled of 1,500 slots), with seeded random
weights. Tolerances, each relative to max(1, the largest magnitude): the
BEV map 1e-4 (the neck's f32 tolerance: the program's BN folded into
scale and shift, the reference's unfolded patches), the carried
descriptors 1e-4; track ids, used, keep and FN flags exact.

The file imports no JAX, so its card tests also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_pillars.py
"""
import numpy as np
import pytest
import torch
from torch import nn

from shasta_tpu_torch.models import RPN, ShastaConfig, ShastaModel
from shasta_tpu_torch.models import rpn as rpn_mod
from shasta_tpu_torch.models.pillars import PillarFeatureNet
from shasta_tpu_torch.models.shasta import pillar_canvas
from shasta_tpu_torch.ops.kernels import dense_conv as dc
from trackbench import harness
from trackbench.drivers.pillar_stream import NOT_FIELDS, weights
from trackbench.gen.scenes import stream_scenes
from trackbench.reference import model as rm
from trackbench.reference import pillars as rp
from trackbench.reference import pipelines as ref
from trackbench.tests.small_pp import small_pp

SEED = 2**31 + 41
FRAME_KEYS = ("voxels", "num_points", "coordinates", "voxels_valid")
PUBLISHED = dict(layer_nums=(3, 5, 5), ds_layer_strides=(2, 2, 2), ds_num_filters=(64, 128, 256),
                 us_layer_strides=(0.5, 1, 2), us_num_filters=(128, 128, 128),
                 num_input_features=64)


def close(got, want, tol=1e-4):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


def config(dtype=None):
    """(the small configuration, its mix, the port's ShastaConfig)."""
    cfg, mix = small_pp()
    m = cfg["model"]
    mc = ShastaConfig(**{**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in m.items() if k not in NOT_FIELDS},
                         "max_obj": 10, "dtype": dtype})
    return cfg, mix, mc


@pytest.fixture(scope="module")
def setup():
    """The small configuration, two scenes of three frames, its weights and
    the pillar model holding them."""
    cfg, mix, mc = config()
    scenes = stream_scenes(SEED, mix, cfg["point_pipeline"], {"car": 10})
    trunk, heads = weights(cfg, SEED, "cpu")
    model = ShastaModel(mc, device="cpu")
    model.load_state_dict({**trunk, **heads["car"]})
    return cfg, scenes, trunk, heads, model


def frame_tensors(frame, B=1):
    return {k: torch.as_tensor(np.stack([frame[k]] * B)) for k in FRAME_KEYS}


# ---------------------------------------------------------------------------
# the defaults build today's modules
# ---------------------------------------------------------------------------

def test_default_config_and_modules_unchanged():
    """The default ShastaConfig builds the VoxelNet trunk with the neck and
    shared conv whose names and shapes the reference's VoxelNet spec lists
    (two blocks, a 1x1 and a 2x2 transposed deblock, 512 -> 64); RPN() is
    that neck; PillarFeatureNet() keeps the JAX reading (every layer at its
    listed width)."""
    m = ShastaModel(ShastaConfig(max_obj=10), device="cpu")
    assert m.cfg.reader == "voxelnet" and m.trunk_names == ("backbone", "neck", "shared_conv")
    assert not hasattr(m, "reader")
    want = {k: s for k, (s, _) in rm.trunk_spec().items()
            if k.startswith(("neck.", "shared_conv."))}
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()
           if k.startswith(("neck.", "shared_conv."))}
    assert got == want
    assert {k: tuple(v.shape) for k, v in RPN().state_dict().items()} == {
        k[5:]: s for k, s in want.items() if k.startswith("neck.")}
    up = RPN().deblocks
    assert isinstance(up[0][0], nn.Conv2d) and up[0][0].kernel_size == (1, 1)
    assert isinstance(up[1][0], nn.ConvTranspose2d)
    pfn = PillarFeatureNet((32, 32), device="cpu")
    assert (pfn.pfn_0.weight.shape, pfn.pfn_1.weight.shape) == ((32, 10), (32, 64))
    assert not pfn.det3d
    assert PillarFeatureNet(device="cpu").pfn_0.weight.shape == (64, 10)


def test_config_refuses_an_unknown_reader_or_a_missing_canvas():
    """An unknown reader raises; the pillar reader has no canvas of its
    own to miss: it scatters onto grid_shape's (ny, nx)."""
    with pytest.raises(ValueError, match="reader"):
        ShastaConfig(reader="dcn")
    cfg = ShastaConfig(reader="pillars", grid_shape=(1, 24, 40), pc_start=(-2.4, -4.0))
    reader = PillarFeatureNet(cfg.pfn_filters, cfg.num_input_features, cfg.voxel_size,
                              cfg.pc_start, device="cpu", det3d=True)
    frame = dict(voxels=torch.zeros(1, 3, 4, 5), num_points=torch.ones(1, 3, dtype=torch.int32),
                 coordinates=torch.tensor([[[0, 23, 39], [0, 0, 0], [0, 5, 7]]]),
                 voxels_valid=torch.tensor([[True, True, False]]))
    assert tuple(pillar_canvas(cfg, reader, frame).shape) == (1, 24, 40, 64)


# ---------------------------------------------------------------------------
# the RPN's fractional upsample stride, det3d's PFN reading
# ---------------------------------------------------------------------------

def test_rpn_fractional_stride_rule():
    """det3d's rule: a stride below 1 is a conv of kernel and stride
    round(1 / s), 1 a 1x1 conv, above 1 a transposed conv; at the
    published dims 0.5 takes block 0's 256 x 256 map to 128 x 128, and the
    three deblocks meet at 128 x 128 in 384 channels."""
    neck = RPN(**PUBLISHED).eval()
    kinds = [(type(d[0]), d[0].kernel_size, d[0].stride) for d in neck.deblocks]
    assert kinds == [(nn.Conv2d, (2, 2), (2, 2)), (nn.Conv2d, (1, 1), (1, 1)),
                     (nn.ConvTranspose2d, (2, 2), (2, 2))]
    assert [len(rpn_mod._conv_bns(b)) for b in neck.blocks] == [4, 6, 6]
    with torch.no_grad():
        assert neck.deblocks[0](torch.zeros(1, 64, 256, 256)).shape == (1, 128, 128, 128)
        assert neck(torch.zeros(1, 64, 64, 64)).shape == (1, 384, 16, 16)
    assert rpn_mod.deblock_conv(64, 32, 0.25).kernel_size == (4, 4)


def _pfn_case(seed=3):
    """A few pillars of all-positive points and a layer-0 weight row that
    is negative everywhere: that channel's points fall below its BN
    shift, which a padded (zero) slot takes, so in det3d's reading a
    padded slot wins the channel's max."""
    g = torch.Generator().manual_seed(seed)
    V, P = 6, 20
    vox = torch.rand(V, P, 5, generator=g) + 0.5
    num = torch.tensor([1, 3, 20, 7, 12, 19], dtype=torch.int32)
    vox[torch.arange(P)[None, :] >= num[:, None]] = 0.0  # the voxelizer's zero padding
    zyx = torch.stack([torch.zeros(V, dtype=torch.int32),
                       torch.randint(0, 64, (V,), generator=g, dtype=torch.int32),
                       torch.randint(0, 64, (V,), generator=g, dtype=torch.int32)], 1)
    m = dict(pfn_filters=[64, 64], num_input_features=5)
    spec = {k: v for k, v in rp.trunk_spec({**small_pp()[0]["model"], **m}).items()
            if k.startswith("reader.")}
    sd = rm.make_weights(spec, seed, "cpu")
    sd["reader.pfn_0.weight"][0] = -sd["reader.pfn_0.weight"][0].abs() - 0.1
    sd["reader.bn_0.bias"][0] = 2.0
    sd["reader.bn_0.weight"][0] = 1.0
    return vox, num, zyx, sd


def test_pfn_det3d_reading_matches_the_reference():
    """The port's det3d reading (halved units, padded slots through every
    layer) against det3d's PFN as written, 1e-5; on this case the masked
    reading (only each pillar's points: the reference on the first n
    slots) differs, by more than 1e-2."""
    vox, num, zyx, sd = _pfn_case()
    pfn = PillarFeatureNet((64, 64), 5, (0.2, 0.2), (-6.4, -6.4), device="cpu", det3d=True)
    assert (pfn.pfn_0.weight.shape, pfn.pfn_1.weight.shape) == ((32, 10), (64, 64))
    pfn.load_state_dict({k[len("reader."):]: v for k, v in sd.items()})
    pfn.eval()
    with torch.no_grad():
        got = pfn(vox, num, zyx)
    want = rp.pfn(sd, vox, num, zyx, 2, (0.2, 0.2), (-6.4, -6.4))
    assert got.shape == (6, 64)
    close(got, want, 1e-5)
    masked = torch.cat([rp.pfn(sd, vox[i:i + 1, :n], num[i:i + 1], zyx[i:i + 1], 2,
                               (0.2, 0.2), (-6.4, -6.4)) for i, n in enumerate(num.tolist())])
    assert float((masked - want).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# the model's BEV map, the two-frame forward and the serving step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["run", "kernel"])
def test_bev_map_matches_the_reference(setup, monkeypatch, route):
    """bev_single of a frame against the reference's trunk, 1e-4: on
    `_run`, and on the kernel route forced on the CPU (dense_conv's plain
    version: packed weights, BN folded, NHWC, the three deblocks into one
    384-channel map), which takes 20 convs a frame."""
    cfg, scenes, trunk, _, model = setup
    calls = []
    if route == "kernel":
        monkeypatch.setattr(rpn_mod, "kernel_route", rpn_mod.fusable)
        plain = dc.dense_conv_plain
        monkeypatch.setattr(dc, "dense_conv_plain",
                            lambda *a, **k: calls.append(1) or plain(*a, **k))
    tr = rp.Trunk(trunk, cfg["model"], "cpu")
    frame = scenes[0][1]
    with torch.no_grad():
        got = model.bev_single(frame_tensors(frame))
    want = tr.bev(frame)
    assert got.shape == (1, 16, 16, 64)
    close(got[0], want)
    assert len(calls) == (20 if route == "kernel" else 0)
    assert 300 < tr.sets[-1][0] < 1500  # filled pillars of the 1,500 slots


def test_bev_maps_take_both_frames_as_one_batch(setup):
    """The two-frame forward's maps: curr and prev as one batch of 2, each
    equal to its frame's own bev_single (1e-5)."""
    _, scenes, _, _, model = setup
    a, b = scenes[0][0], scenes[1][2]
    batch = {**frame_tensors(a), **{"prev_" + k: v for k, v in frame_tensors(b).items()}}
    with torch.no_grad():
        curr, prev = model.bev_maps(batch)
        close(curr, model.bev_single(frame_tensors(a)), 1e-5)
        close(prev, model.bev_single(frame_tensors(b)), 1e-5)


def test_step_frame_matches_the_reference_stream(setup):
    """Each scene through ScenePipeline.step_frame against
    reference/pipelines.stream on the pillar trunk: track ids one-to-one,
    used, keep and FN flags and tracker scores exact (rows_differ 0), the
    descriptors carried out of each scene's last frame 1e-4."""
    from shasta_tpu_torch.infer import ScenePipeline, default_tracker_params
    from shasta_tpu_torch.tracker.pub_tracker import NUSCENES_TRACKING_NAMES

    cfg, scenes, trunk, heads, model = setup
    pipe = ScenePipeline(model, NUSCENES_TRACKING_NAMES.index("car"),
                         default_tracker_params(max_age=cfg["max_age"]),
                         fp_thresh=cfg["fp_elim"], decision_thresh=cfg["decision_thresh"])
    tr = rp.Trunk(trunk, cfg["model"], "cpu")
    th = (cfg["fp_elim"], cfg["decision_thresh"])
    tally = harness.Tally()
    for scene in scenes:
        pipe.reset()
        want = ref.stream(tr, heads, {"car": 10}, scene, th, cfg["max_age"])
        ids = harness.IdMap()
        for t, frame in enumerate(scene):
            boxes, n = ref.class_boxes(frame, "car", 10)
            out = pipe.step_frame(dict(frame_tensors(frame), det_boxes=boxes[None]), n,
                                  ref.frame_lag(frame, ["car"]))
            harness.compare_rows(tally, ids, {k: getattr(out, k) for k in
                                              ("tid", "used", "ref", "keep", "fn")},
                                 want[t]["car"])
        last = scene[-1]
        b = torch.as_tensor(ref.class_boxes(last, "car", 10)[0])
        close(pipe._prev_feat[0], tr.features(tr.bev(last), b))
    assert tally.rows > 0 and tally.numbers()["rows_differ"] == 0.0


def test_pillar_spans_and_counters(setup):
    """A profiled step opens step.pillars and step.neck inside step.trunk,
    never step.sparse_trunk, and counts per frame pillars.kept (the valid
    pillars), pillars.slots (V) and pillars.points (their points)."""
    from torch.profiler import ProfilerActivity, profile

    from shasta_tpu_torch.infer import ScenePipeline
    from shasta_tpu_torch.utils import profiler

    _, scenes, _, _, model = setup
    frame = scenes[0][0]
    pipe = ScenePipeline(model, 0)
    boxes, n = ref.class_boxes(frame, "car", 10)
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pipe.step_frame(dict(frame_tensors(frame), det_boxes=boxes[None]), n, 0.5).tid
        names = {e.name for e in prof.events()}
        c = profiler.counters()
    finally:
        profiler.reset_counters()
    assert {"step.trunk", "step.pillars", "step.neck"} <= names
    assert "step.sparse_trunk" not in names
    valid = frame["voxels_valid"]
    assert c["pillars.kept"] == [int(valid.sum())]
    assert c["pillars.slots"] == [len(valid)]
    assert c["pillars.points"] == [int(frame["num_points"][valid].sum())]


def test_bf16_reader_and_neck_stay_near_f32(setup):
    """dtype bf16 runs the PFN linears and the neck's convs in bf16 (BN in
    f32): the map moves, by less than bf16's few parts in a hundred."""
    cfg, scenes, trunk, heads, model = setup
    bf = ShastaModel(config(dtype=torch.bfloat16)[2], device="cpu")
    bf.load_state_dict(model.state_dict())
    frame = frame_tensors(scenes[0][1])
    with torch.no_grad():
        want, got = model.bev_single(frame), bf.bev_single(frame)
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    assert 0 < err < 5e-2


# ---------------------------------------------------------------------------
# the CLIs' model, checkpoints, training
# ---------------------------------------------------------------------------

def test_cli_config_builds_the_published_pillar_model():
    """configs/nusc/pp/car.py through tools/common.build_model: det3d's
    two-layer PFN (10 -> 32, 64 -> 64), the three-block neck to 384
    channels, the shared conv 384 -> 64; the pillar voxel generator."""
    from shasta_tpu_torch.tools.common import build_model
    from shasta_tpu_torch.utils.config import Config

    cfg = Config.fromfile("configs/nusc/pp/car.py")
    m = build_model(cfg, "cpu")
    assert m.trunk_names == ("reader", "neck", "shared_conv") and not hasattr(m, "backbone")
    assert (m.reader.pfn_0.weight.shape, m.reader.pfn_1.weight.shape) == ((32, 10), (64, 64))
    assert [len(rpn_mod._conv_bns(b)) for b in m.neck.blocks] == [4, 6, 6]
    assert m.shared_conv[0].weight.shape == (64, 384, 3, 3)
    assert tuple(m.cfg.grid_shape) == (1, 512, 512) and m.cfg.out_stride == 4
    pp = cfg.point_pipeline
    assert (tuple(pp.voxel_size), pp.max_points_in_voxel, pp.max_voxels) == ((0.2, 0.2, 8.0), 20,
                                                                              60000)


def test_clis_serve_the_pillar_config(tmp_path):
    """configs/nusc/pp/car.py cut to a 64 x 64 canvas, through the serving
    CLIs on the CPU from a split on disk: tools.track_scene tracks every
    frame, ids carried over frames; tools.eval's batched lanes
    (bev_single) and its per-pair loop (the two-frame forward, both frames
    as one batch of 2) give the same annotations after each scene's first
    frame (flags exact, scores 1e-4)."""
    import os

    from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
    from shasta_tpu_torch.tools import eval as teval
    from shasta_tpu_torch.tools import track_scene
    from shasta_tpu_torch.tools.common import build_model
    from shasta_tpu_torch.train.checkpoint import save_checkpoint
    from shasta_tpu_torch.utils.config import Config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = write_split_config(
        os.path.join(repo, "configs", "nusc", "pp", "car.py"), {}, str(tmp_path / "base.py"),
        point_pipeline=dict(pc_range=(-6.4, -6.4, -5.0, 6.4, 6.4, 3.0), max_voxels=1500),
        model=dict(pc_start=(-6.4, -6.4), grid_shape=(1, 64, 64), max_obj=10),
        max_objects=10)
    sp = write_track_split(str(tmp_path / "data"), Config.fromfile(base), n_scenes=2,
                           n_frames=3, seed=5, n_objects=12, n_points=3000, n_spots=800)
    cfg_path = write_split_config(base, sp["val"], str(tmp_path / "split.py"))
    sd = build_model(Config.fromfile(cfg_path), "cpu", seed=3).state_dict()
    # random heads are near uniform and fire no decision: sharpen the last layer
    sd["aff.10.weight"] *= 10.0
    sd["aff.10.bias"] *= 10.0
    sd["aff.10.bias"][-2:] += 5.0
    ckpt = str(tmp_path / "pp.pth")
    save_checkpoint(ckpt, sd)
    common = ["--config", cfg_path, "--checkpoint", ckpt, "--cpu"]
    tracked = track_scene.main(common + ["--out", str(tmp_path / "track.json")])
    assert sorted(tracked["results"]) == sorted(sp["tokens"])
    ids = [{a["tracking_id"] for a in tracked["results"][t]} for t in sp["tokens"]]
    assert sum(len(a & b) for a, b in zip(ids, ids[1:])) > 0
    batched = teval.main(common + ["--work_dir", str(tmp_path / "b"), "--batch", "2"])
    parity = teval.main(common + ["--work_dir", str(tmp_path / "p"), "--parity"])
    later = [t for t in sp["tokens"] if not t.endswith("f0")]
    n = 0
    for tok in later:
        got, want = batched["results"][tok], parity["results"][tok]
        assert len(got) == len(want), tok
        for g, w in zip(got, want):
            assert g.keys() == w.keys(), tok
            for k, v in w.items():
                if k == "ref_detection_score" or (k == "translation" and "FN" in w):
                    assert np.allclose(g[k], v, atol=1e-4, rtol=0), (tok, k)
                else:
                    assert g[k] == v, (tok, k)
            n += 1
    assert n > 10


def test_det3d_pillar_checkpoint_loads(setup, tmp_path):
    """A CenterPoint-PP .pth in det3d's names (reader.pfn_layers.{i}.linear
    / .norm, neck.*, a bbox_head the model has none of, a DDP `module.`
    prefix) fills the pillar model's reader and neck."""
    from shasta_tpu_torch.train.checkpoint import load_checkpoint, merge_pretrained

    _, _, _, _, model = setup
    other = ShastaModel(model.cfg, device="cpu")
    sd = {}
    for k, v in other.state_dict().items():
        if k.startswith("reader."):
            _, mod, rest = k.split(".", 2)
            kind, i = mod.split("_")
            k = f"reader.pfn_layers.{i}.{'linear' if kind == 'pfn' else 'norm'}.{rest}"
        elif not k.startswith("neck."):
            continue
        sd["module." + k] = torch.randn_like(v.float()).to(v.dtype) if v.dim() else v
    sd["module.bbox_head.shared_conv.0.weight"] = torch.zeros(64, 384, 3, 3)
    path = str(tmp_path / "centerpoint_pp.pth")
    torch.save({"state_dict": sd}, path)
    loaded = load_checkpoint(path)
    assert {k.split(".")[0] for k in loaded} == {"reader", "neck"}
    assert "reader.pfn_0.weight" in loaded and "reader.bn_1.running_var" in loaded
    merged = merge_pretrained(model.state_dict(), loaded)
    for k, v in loaded.items():
        assert torch.equal(merged[k], v), k
    assert torch.equal(merged["shared_conv.0.weight"], model.state_dict()["shared_conv.0.weight"])


def test_training_refuses_the_pillar_reader(setup):
    from shasta_tpu_torch.train.loop import make_optimizer, make_train_step

    _, _, _, _, model = setup
    with pytest.raises(NotImplementedError, match="pillars"):
        make_train_step(model, make_optimizer(model))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _published_neck(dev):
    """The pillar neck (RPN 64 -> 384, shared conv 384 -> 64) at published
    widths, drawn as the card tests of the VoxelNet neck draw theirs."""
    from chip_smoke import random_neck

    return random_neck(dev, 11, PUBLISHED)


@pytest.mark.gpu
def test_pillar_neck_kernel_matches_plain_on_the_card():
    """dense_conv at each of the pillar neck's 20 shapes (64 x 512 x 512
    in: 64-channel 3x3 convs over 256 x 256, the 2x2 stride-2 deblock, the
    384 -> 64 shared conv at 128 x 128) against its plain version on the
    card (cuDNN, TF32 off) within 1e-4 x max(1, |out|); the whole neck in
    20 launches, against `_run`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from chip_smoke import neck_convs
    from shasta_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    neck, shared = _published_neck(dev)
    x = torch.relu(torch.randn(1, 64, 512, 512, generator=torch.Generator().manual_seed(1))).to(dev)
    with torch.no_grad():
        convs = neck_convs(neck, shared, x)
        assert len(convs) == 20
        for name, h, p, _ in convs:
            want = dc.dense_conv_plain(h, p)
            got = dc.dense_conv(h, p)
            err = (got - want).abs().max().item()
            assert err <= 1e-4 * max(1.0, want.abs().max().item()), (name, err)
        before = dc.dense_conv.launches
        got = shared(neck(x))
        assert dc.dense_conv.launches - before == 20
        ups = []
        h = x
        for blk, de in zip(neck.blocks, neck.deblocks):
            h = rpn_mod._run(blk, h, None)
            ups.append(rpn_mod._run(de, h, None))
        want = rpn_mod._run(shared, torch.cat(ups, 1), None)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.gpu
def test_pillar_model_at_published_size_on_the_card():
    """configs/nusc/pp/car.py's model on the card at 60,000 pillars and
    the 512 x 512 canvas: a served frame's BEV map against the same
    weights on the CPU (1e-4), 20 dense_conv launches a frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shasta_tpu_torch import resolve_device
    from shasta_tpu_torch.tools.common import build_model
    from shasta_tpu_torch.utils.config import Config
    from trackbench.tests.small import load

    dev = resolve_device("cuda")
    cfg = Config.fromfile("configs/nusc/pp/car.py")
    mix = load("traffic", "pp_stream")
    pp = {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.point_pipeline.items()}
    frame = stream_scenes(7, dict(mix, scenes=1, frames=1), pp, {"car": 90})[0][0]
    assert frame["voxels"].shape == (60000, 20, 5)
    maps = {}
    for d in ("cuda", "cpu"):
        m = build_model(cfg, d, seed=3)
        m.load_state_dict(build_model(cfg, "cpu", seed=3).state_dict())
        before = dc.dense_conv.launches
        with torch.no_grad():
            maps[d] = m.bev_single({k: v.to(d) for k, v in frame_tensors(frame).items()}).cpu()
        assert dc.dense_conv.launches - before == (20 if d == "cuda" else 0)
    assert maps["cpu"].shape == (1, 128, 128, 64)
    close(maps["cuda"], maps["cpu"])
