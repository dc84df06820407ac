"""ShaSTA on DSVT-P (models/shasta.py reader "dsvt", models/dsvt.py,
models/rpn.py ResNeck; configs/nusc/dsvt/car.py) against the benchmark's
plain reference (trackbench/reference/dsvt.py: the dynamic pillar reader,
DSVT's partition and blocks, the residual neck and the plain shared conv
written from their description, f32, TF32 off), on the CPU at a small
size (trackbench/tests/small_dsvt.py: a 48 x 48 grid at 0.3 m, windows
of 6 shifted by 3, sets of 8, d_model 32, all four blocks), with seeded
random weights. Tolerances, each relative to max(1, the largest
magnitude): features, BEV maps and descriptors 1e-5 (sums in another
order); the partition's slots and masks, the pillars' cells and counts,
track ids, used, keep and FN flags exact.

The file imports no JAX.
"""
import numpy as np
import pytest
import torch
from torch import nn

from shasta_tpu_torch.models import ShastaConfig, ShastaModel
from shasta_tpu_torch.models import dsvt as md
from shasta_tpu_torch.models import rpn as rpn_mod
from shasta_tpu_torch.models.shasta import dsvt_canvas
from shasta_tpu_torch.ops.kernels import dense_conv as dc
from trackbench import harness
from trackbench.drivers.dsvt_stream import model_config, weights
from trackbench.gen.dsvt import dsvt_scenes
from trackbench.reference import dsvt as rd
from trackbench.reference import model as rm
from trackbench.reference import pipelines as ref
from trackbench.tests.small_dsvt import small_dsvt

SEED = 2**31 + 47


def close(got, want, tol=1e-5):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread per worker: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """The small configuration, two scenes of three frames, the weights and
    the DSVT model holding them."""
    cfg, mix = small_dsvt()
    scenes = dsvt_scenes(SEED, mix, cfg["point_pipeline"], {"car": 10})
    trunk, heads = weights(cfg, SEED, "cpu")
    model = ShastaModel(model_config(ShastaConfig, cfg, 10), device="cpu")
    model.load_state_dict({**trunk, **heads["car"]})
    return cfg, scenes, trunk, heads, model


def cloud(*frames):
    return {k: torch.as_tensor(np.stack([f[k] for f in frames])) for k in ("cloud", "cloud_valid")}


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(num_input_features=4), dict(grid_shape=(2, 48, 48)), dict(pfn_filters=(32, 64)),
    dict(dsvt_heads=5), dict(neck_input_features=64), dict(out_stride=4)])
def test_config_refuses_widths_the_reader_cannot_give(bad):
    cfg, _ = small_dsvt()
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()
          if k != "type"}
    ShastaConfig(**kw)
    with pytest.raises(ValueError, match="dsvt reader"):
        ShastaConfig(**{**kw, **bad})


def test_cli_config_builds_the_published_dsvt_model():
    """configs/nusc/dsvt/car.py through tools/common.build_model: the
    pillar net 11 -> 64 (+ its max) -> 128 over 360 x 360 pillars of 0.3
    m, four blocks of two encoder layers (8 heads of 16, FFN 256) with a
    position MLP per block and shift, sets of 90 in 30 x 30 windows
    shifted by 15, the residual neck [1, 2, 2] / [128, 128, 256] upsampled
    [0.5, 1, 2] to 3 x 128, the plain shared conv 384 -> 128, 23 convs;
    its weights are the reference's spec and ShaSTA's head at 128."""
    from shasta_tpu_torch.tools.common import build_model
    from shasta_tpu_torch.utils.config import Config

    cfg = Config.fromfile("configs/nusc/dsvt/car.py")
    m = build_model(cfg, "cpu")
    c = m.cfg
    assert (c.reader, c.grid_shape, c.voxel_size, c.out_stride) == ("dsvt", (1, 360, 360),
                                                                    (0.3, 0.3), 2)
    assert (c.pfn_filters, c.dsvt_d_model, c.dsvt_heads, c.dsvt_ffn) == ((128, 128), 128, 8, 256)
    assert (c.dsvt_set_size, c.dsvt_window, c.dsvt_shift, c.dsvt_blocks) == (90, 30, 15, 4)
    assert m.trunk_names == ("dsvt", "neck", "shared_conv")
    v = m.dsvt.vfe.pfn_layers
    assert v[0].linear.weight.shape == (64, 11) and v[1].linear.weight.shape == (128, 128)
    assert len(m.dsvt.stage_0) == 4 and len(m.dsvt.residual_norm_stage_0) == 4
    attn = m.dsvt.stage_0[3].encoder_list[1].win_attn
    assert attn.self_attn.in_proj_weight.shape == (384, 128) and attn.self_attn.num_heads == 8
    assert attn.linear1.weight.shape == (256, 128)
    assert [len(level) for level in m.neck.blocks] == [2, 3, 3]
    convs = [x for x in m.neck.modules() if isinstance(x, (nn.Conv2d, nn.ConvTranspose2d))]
    assert len(convs) == 22
    assert [type(d[0]).__name__ for d in m.neck.deblocks] == ["Conv2d", "ConvTranspose2d",
                                                              "ConvTranspose2d"]
    assert len(m.shared_conv) == 1 and m.shared_conv[0].weight.shape == (128, 384, 3, 3)
    assert m.shared_conv[0].bias is None
    model = {k: tuple(v) if isinstance(v, tuple) else v for k, v in cfg.model.items()}
    assert set(m.state_dict()) == set(rd.trunk_spec(model)) | set(rm.head_spec(90, C=128))


def test_training_refuses_the_dsvt_reader(setup):
    from shasta_tpu_torch.train.loop import make_optimizer, make_train_step

    model = setup[-1]
    with pytest.raises(NotImplementedError, match="dsvt"):
        make_train_step(model, make_optimizer(model))


# ---------------------------------------------------------------------------
# the partition and the first-slot rule
# ---------------------------------------------------------------------------

# pillars a window at shift 0 (6 x 6 windows, sets of 8): below the set
# size, equal to it, a multiple of it, above it and not a multiple, full
COUNTS = {(0, 0): 5, (1, 0): 8, (2, 1): 16, (3, 3): 13, (5, 2): 36, (7, 7): 1, (6, 4): 9}


def hand_pillars(seed: int, counts=COUNTS) -> torch.Tensor:
    """(M, 2) [y, x] cells: counts[(wx, wy)] distinct cells in that window."""
    g = torch.Generator().manual_seed(seed)
    cells = []
    for (wx, wy), n in counts.items():
        pick = torch.randperm(36, generator=g)[:n]
        cells.append(torch.stack([wy * 6 + pick // 6, wx * 6 + pick % 6], 1))
    yx = torch.cat(cells)
    return yx[torch.randperm(len(yx), generator=g)]


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("shift", [0, 3])
def test_partition_matches_the_reference(lanes, shift):
    """Both orders' slots and masks exactly as the reference's, lane after
    lane, then the padding sets (every slot on row 0, all but the first
    masked); at shift 0 the windows hold 1, 5, 8, 9, 13, 16 and 36 pillars."""
    m = small_dsvt()[0]["model"]
    slots, K = 100, m["dsvt_set_size"]
    lane_yx = [hand_pillars(lane) for lane in range(lanes)]
    yx = torch.zeros((lanes * slots, 2), dtype=torch.int64)
    valid = torch.zeros(lanes * slots, dtype=torch.bool)
    for b, c in enumerate(lane_yx):
        yx[b * slots:b * slots + len(c)] = c
        valid[b * slots:b * slots + len(c)] = True
    part = md.set_partition(yx, valid, lanes, shift, m["dsvt_window"], K, (48, 48))
    assert part.inds.shape == (2, md.set_cap(lanes, slots, (48, 48), 6, K), K)
    at = 0
    for b, c in enumerate(lane_yx):
        want, masks, xy = rd.partition(c, m, shift)
        S = len(want[0])
        assert int(part.sets[b]) == S
        for o in range(2):
            assert torch.equal(part.inds[o, at:at + S], want[o] + b * slots)
            assert torch.equal(part.mask[o, at:at + S], masks[o])
        assert torch.equal(part.pos[b * slots:b * slots + len(c)], xy)
        at += S
    if shift == 0:
        assert at == lanes * sum(-(-n // K) for n in COUNTS.values())
    assert not part.inds[:, at:].any() and not part.mask[:, at:, 0].any()
    assert part.mask[:, at:, 1:].all()


def test_first_slot_rule_on_a_pillar_in_two_sets(setup):
    """Eq. 3 never puts a pillar in two sets of one partition (its slots
    are consecutive and never cross a set's end), but DSVT's scatter back
    to the pillars takes any layout: here pillar 3 sits in set 0 (slot 3)
    and set 1 (slot 0). The port takes its output from set 0, as the
    reference does, and the rule matters: set 1's output differs."""
    cfg, _, trunk, _, model = setup
    m = cfg["model"]
    d = m["dsvt_d_model"]
    inds = torch.tensor([[0, 1, 2, 3], [3, 4, 5, 5]])
    mask = torch.tensor([[False] * 4, [False, False, False, True]])
    g = torch.Generator().manual_seed(3)
    x, pos = torch.randn(6, d, generator=g), torch.randn(6, d, generator=g)
    first = md.first_slots(inds, 6)
    assert first.tolist() == [0, 1, 2, 3, 5, 6]
    layer = model.dsvt.stage_0[0].encoder_list[0]
    part = md.Partition(inds[None], mask[None], first[None], None, None)
    with torch.no_grad():
        got = md.encoder_layer(layer, x, part, 0, pos, None)
        last = md.encoder_layer(layer, x, part._replace(first=torch.tensor([[0, 1, 2, 4, 5, 6]])),
                                0, pos, None)
    want = rd.encoder(trunk, "dsvt.stage_0.0.encoder_list.0", x, inds, mask, pos, m["dsvt_heads"])
    close(got, want)
    assert float((got[3] - last[3]).abs().max()) > 1e-3
    close(got[:3], last[:3])


# ---------------------------------------------------------------------------
# the reader, the neck kernel's epilogues, the neck
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1500, 600])
def test_reader_matches_the_reference(setup, cap):
    """A frame's pillars: cells exact in ascending y * nx + x, the rows on
    the grid counted, 128-wide features 1e-5; at 600 slots the lowest 600
    pillars are kept with the same features, the rest counted as dropped."""
    cfg, scenes, trunk, _, model = setup
    frame = scenes[0][1]
    rows = torch.as_tensor(frame["cloud"])
    valid = torch.as_tensor(frame["cloud_valid"])
    want, yx, on_grid = rd.pillars(trunk, rows[valid], cfg["model"])
    M = len(want)
    assert 900 < M < 1500
    dsvt = model.dsvt
    old = dsvt.max_pillars
    dsvt.max_pillars = cap
    try:
        with torch.no_grad():
            feats, got_yx, pvalid, points, demand = dsvt.pillars(rows, valid)
    finally:
        dsvt.max_pillars = old
    n = min(M, cap)
    assert feats.shape == (cap, 32) and int(pvalid.sum()) == n and bool(pvalid[:n].all())
    assert int(points) == on_grid and int(demand) == M
    assert torch.equal(got_yx[:n], yx[:n])
    close(feats[:n], want[:n])


def _bn(c, seed):
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(c, eps=1e-3).eval()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return bn


@pytest.mark.parametrize("case", ["relu-free 3x3", "relu-free 1x1 stride 2", "residual",
                                  "residual into a buffer", "plain conv, no BN"])
def test_dense_conv_new_epilogues_against_conv2d(case):
    """dense_conv's CPU route (its plain version) with the ReLU-free and the
    residual epilogues against F.conv2d, BN, the residual and ReLU as
    modules; a residual with relu=False is refused."""
    g = torch.Generator().manual_seed(len(case))
    x = torch.randn(2, 32, 9, 11, generator=g)
    stride, k = (2, 1) if "stride 2" in case else (1, 3)
    conv = nn.Conv2d(32, 64, k, stride=stride, padding=k // 2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) / (32 * k * k) ** 0.5)
    bn = None if "no BN" in case else _bn(64, len(case))
    with torch.no_grad():
        y = conv(x) if bn is None else bn(conv(x))
        res = torch.randn(y.shape, generator=g) if "residual" in case else None
        relu = res is not None
        want = (torch.relu(y + res) if relu else y).permute(0, 2, 3, 1)
        xh = x.permute(0, 2, 3, 1).contiguous()
        p = dc.pack(conv, bn)
        rh = None if res is None else res.permute(0, 2, 3, 1).contiguous()
        if "buffer" in case:
            buf = torch.full((*want.shape[:3], 96), 7.0)
            wide = torch.zeros_like(buf)
            wide[..., 32:] = rh
            dc.dense_conv(xh, p, buf, 32, relu=True, residual=wide)
            got = buf[..., 32:]
            assert bool((buf[..., :32] == 7.0).all())
        else:
            got = dc.dense_conv(xh, p, relu=relu, residual=rh)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if res is not None:
        with pytest.raises(ValueError, match="before the ReLU"):
            dc.dense_conv(xh, p, relu=False, residual=rh)


def test_res_neck_routes_match_the_reference(setup, monkeypatch):
    """The residual neck and the plain shared conv on a random canvas: the
    kernel route (taken on the CPU: dense_conv's plain version, 23
    launches) and `_run`'s route against the reference's neck at 1e-5."""
    cfg, _, trunk, _, model = setup
    x = torch.randn(1, 32, 48, 48, generator=torch.Generator().manual_seed(5))
    want = rd.neck(trunk, x, cfg["model"])[0]
    with torch.no_grad():
        run = model.shared_conv(model.neck(x)).permute(0, 2, 3, 1)[0]
        calls = []
        plain = dc.dense_conv_plain
        monkeypatch.setattr(dc, "dense_conv_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
        monkeypatch.setattr(rpn_mod, "kernel_route", rpn_mod.fusable)
        fused = model.shared_conv(model.neck(x)).permute(0, 2, 3, 1)[0]
    assert len(calls) == 23
    close(run, want)
    close(fused, want)


def test_chip_smoke_breaks_a_served_canvas_into_the_counted_convs(setup):
    """chip_smoke.py phase 25's pieces on a served frame: res_neck_calls
    lists the 23 convs in count/dsvt.py's order and shapes, each input made
    by the plain version, the last one's output equal to the neck and the
    shared conv by `_run` (1e-5); count/dsvt.py's rows on the grid, pillars
    and sets of the frame equal to the reference's."""
    from chip_smoke import res_neck_calls
    from trackbench.count import dsvt as cd

    cfg, scenes, trunk, _, model = setup
    m, frame = cfg["model"], scenes[0][1]
    with torch.no_grad():
        canvas = dsvt_canvas(model.cfg, model.dsvt, cloud(frame))
        calls = res_neck_calls(model.neck, model.shared_conv, canvas)
        counted = cd.neck_convs(m)
        assert [c[0] for c in calls] == [c["name"] for c in counted]
        for (name, h, p, relu, res), c in zip(calls, counted):
            up = p.up * p.up  # a transposed conv's outputs a GEMM row
            got = (int(np.prod(dc.out_grid(h, p))) * up, p.w.shape[0] // up)
            assert got == (c["m_out"], c["cout"]), name
            assert h.shape[1] * h.shape[2] == c["m_in"] and h.shape[3] == c["cin"], name
        name, h, p, relu, res = calls[-1]
        want = model.shared_conv(model.neck(canvas.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        close(dc.dense_conv_plain(h, p, relu=relu, residual=res), want)
    rows = torch.as_tensor(frame["cloud"])[torch.as_tensor(frame["cloud_valid"])]
    _, yx, on_grid = rd.pillars(trunk, rows, m)
    _, sets = rd.blocks(trunk, torch.zeros(len(yx), 32), yx, m)
    points, cells = cd.frame_pillars(frame, m)
    assert points == on_grid and np.array_equal(cells, np.asarray(yx))
    assert [cd.sets(cells, m, s) for s in (0, m["dsvt_shift"])] == list(sets)


# ---------------------------------------------------------------------------
# the trunk, the step, spans and counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", [1, 2])
def test_dsvt_trunk_matches_the_reference(setup, lanes):
    """B lanes of different scenes' frames: each lane's BEV map and the
    descriptors sampled at its boxes against the reference's (1e-5)."""
    cfg, scenes, trunk, _, model = setup
    frames = [scenes[0][1], scenes[1][2]][:lanes]
    tr = rd.Trunk(trunk, cfg["model"], "cpu")
    with torch.no_grad():
        got = model.bev_single(cloud(*frames))
    assert got.shape == (lanes, 24, 24, 32)
    for b, frame in enumerate(frames):
        want = tr.bev(frame)
        close(got[b], want)
        boxes = torch.as_tensor(ref.class_boxes(frame, "car", 10)[0])
        close(tr.features(got[b], boxes), tr.features(want, boxes))


def test_step_frame_matches_the_reference_stream(setup):
    """A scene's three points frames through ScenePipeline.step_frame
    against reference/pipelines.stream on the DSVT-P trunk: track ids
    one-to-one, used, keep and FN flags and tracker scores exact
    (rows_differ 0), the descriptors carried out of the last frame 1e-5."""
    from shasta_tpu_torch.infer import ScenePipeline, default_tracker_params
    from shasta_tpu_torch.tracker.pub_tracker import NUSCENES_TRACKING_NAMES

    cfg, scenes, trunk, heads, model = setup
    pipe = ScenePipeline(model, NUSCENES_TRACKING_NAMES.index("car"),
                         default_tracker_params(max_age=cfg["max_age"]),
                         fp_thresh=cfg["fp_elim"], decision_thresh=cfg["decision_thresh"])
    tr = rd.Trunk(trunk, cfg["model"], "cpu")
    th = (cfg["fp_elim"], cfg["decision_thresh"])
    tally = harness.Tally()
    scene = scenes[1]
    want = ref.stream(tr, heads, {"car": 10}, scene, th, cfg["max_age"])
    ids = harness.IdMap()
    for t, frame in enumerate(scene):
        boxes, n = ref.class_boxes(frame, "car", 10)
        out = pipe.step_frame(dict(cloud(frame), det_boxes=boxes[None]), n,
                              ref.frame_lag(frame, ["car"]))
        harness.compare_rows(tally, ids, {k: getattr(out, k) for k in
                                          ("tid", "used", "ref", "keep", "fn")}, want[t]["car"])
    b = torch.as_tensor(ref.class_boxes(scene[-1], "car", 10)[0])
    close(pipe._prev_feat[0], tr.features(tr.bev(scene[-1]), b))
    assert tally.rows > 0 and tally.numbers()["rows_differ"] == 0.0


def test_spans_and_counters(setup):
    """A profiled step opens step.dyn_pillars (twice: the reader, then the
    canvas), step.dsvt with dsvt.partition inside, and step.neck, and counts
    per lane the rows on the grid, the pillars, the slots and none dropped;
    per partition (four) the pillars, the sets and their slots."""
    from torch.profiler import ProfilerActivity, profile

    from shasta_tpu_torch.infer import ScenePipeline
    from shasta_tpu_torch.utils import profiler

    cfg, scenes, trunk, _, model = setup
    frame = scenes[0][0]
    pipe = ScenePipeline(model, 0)
    boxes, n = ref.class_boxes(frame, "car", 10)
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pipe.step_frame(dict(cloud(frame), det_boxes=boxes[None]), n, 0.5).tid
        names = [e.name for e in prof.events()]
        c = profiler.counters()
    finally:
        profiler.reset_counters()
    assert names.count("step.dyn_pillars") == 2 and names.count("dsvt.partition") == 1
    assert {"step.trunk", "step.dsvt", "step.neck"} <= set(names)
    rows = torch.as_tensor(frame["cloud"])[torch.as_tensor(frame["cloud_valid"])]
    _, yx, on_grid = rd.pillars(trunk, rows, cfg["model"])
    _, sets = rd.blocks(trunk, torch.zeros(len(yx), 32), yx, cfg["model"])
    m = cfg["model"]
    assert c["dynpillar.points"] == [on_grid] and c["dynpillar.pillars"] == [len(yx)]
    assert c["dynpillar.slots"] == [m["max_pillars"]] and c["dynpillar.dropped"] == [0]
    assert c["dsvt.pillars"] == [4 * len(yx)]
    assert c["dsvt.sets"] == [2 * sum(sets)]
    assert c["dsvt.slots"] == [2 * sum(sets) * m["dsvt_set_size"]]


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


def test_bf16_model_runs_its_linears_and_convs_in_bf16(setup):
    """dtype bf16 (trackbench.control's lower precision): the map stays f32
    and near the f32 model's, not equal to it."""
    cfg, scenes, trunk, heads, model = setup
    low = ShastaModel(model_config(ShastaConfig, cfg, 10, torch.bfloat16), device="cpu")
    low.load_state_dict({**trunk, **heads["car"]})
    with torch.no_grad():
        got = low.bev_single(cloud(scenes[0][0]))
        want = model.bev_single(cloud(scenes[0][0]))
        canvas = dsvt_canvas(low.cfg, low.dsvt, cloud(scenes[0][0]))
    assert got.dtype == torch.float32 and canvas.dtype == torch.float32
    err = float((got - want).abs().max() / want.abs().max())
    assert 1e-4 < err < 0.2, err


# ---------------------------------------------------------------------------
# the cell's check catches a fault in the timed path
# ---------------------------------------------------------------------------

def _swapped(set_partition):
    def swap(*a, **k):
        p = set_partition(*a, **k)
        return p._replace(inds=p.inds.flip(0), mask=p.mask.flip(0), first=p.first.flip(0))
    return swap


def _unshifted(set_partition):
    def no_shift(yx, valid, lanes, shift, *a):
        return set_partition(yx, valid, lanes, 0, *a)
    return no_shift


@pytest.mark.parametrize("fault", [None, _swapped, _unshifted],
                         ids=["sound", "orders swapped", "no shift"])
def test_the_cell_check_catches_a_broken_partition(monkeypatch, fault):
    """cardsvt.stream's run and check at the small size (trackbench/run.py
    run_cell on the CPU): within its limits as it is; `correct` false where
    the program's partition swaps its two orders or drops the shift."""
    import json

    from trackbench import run
    from trackbench.tests.small import load

    if fault is not None:
        monkeypatch.setattr(md, "set_partition", fault(md.set_partition))
    cfg, mix = small_dsvt()
    bench = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
    e2e = [m for m in bench["end_to_end"] if "cardsvt.stream" in m.get("workloads",
                                                                         ["cardsvt.stream"])]
    out = run.run_cell(cfg, mix, SEED, 0.5, False, "cpu", e2e, [])
    limits = load("limits", "cardsvt.stream")
    assert set(out["compared"]) == set(limits)
    ok = all(out["compared"][k] <= limits[k] for k in limits)
    assert ok == (fault is None), out["compared"]
