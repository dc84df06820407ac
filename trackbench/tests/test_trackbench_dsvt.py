"""The DSVT-P cell (`cardsvt.stream`) on the CPU at a small size: its run
reads within its limits and its work (tests/test_torch_dsvt.py breaks the
timed path: `correct` false); a program without the DSVT reader refuses
the cell in set-up; the generator's rows; count/dsvt.py against a hand
count; the four new readers and the neck's roofline on hand-made contexts."""
import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.utils import profiler
from trackbench import run
from trackbench.count import dsvt as cd
from trackbench.count import pillars as cp
from trackbench.count import work
from trackbench.gen import dsvt as gd
from trackbench.tests.small import load
from trackbench.tests.small_dsvt import small_dsvt

CELL = "cardsvt.stream"
SEED = 2**31 + 23


def e2e():
    bench = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
    return [m for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])]


def correct(c: dict) -> bool:
    limits = load("limits", CELL)
    assert set(c) == set(limits)
    return all(c[k] <= limits[k] for k in limits)


def test_cell_within_limits_and_its_work_on_cpu():
    """A window, the check and the work the traced metrics read: the FLOPs
    a frame, DSVT's least time, the neck's 23 convs."""
    from trackbench.drivers.dsvt_stream import Cell

    cfg, mix = small_dsvt()
    cell = Cell(cfg, mix, SEED, "cpu")
    rec = cell.window(1.0)
    assert rec["frames"] >= 1 and set(rec) >= {"latency_s", "queue_s"}
    w = cell.work()
    cell.release()
    c = cell.check()
    assert correct(c), c
    assert len(w["flops"]) == len(w["dsvt_least_s"]) == len(w["neck_convs"]) == rec["frames"]
    assert len(w["neck_convs"][0]) == 23 and min(w["flops"]) > 0 and min(w["dsvt_least_s"]) > 0


def test_driver_refuses_a_program_without_the_dsvt_reader(monkeypatch):
    """A ShastaConfig without the reader's keys (the program before it)
    fails the cell's set-up at once, before any traffic is made."""
    import dataclasses

    from shasta_tpu_torch import models
    from trackbench.drivers import dsvt_stream

    @dataclasses.dataclass(frozen=True)
    class Older:
        max_obj: int = 90
        dtype: object = None

    monkeypatch.setattr(dsvt_stream, "dsvt_scenes",
                        lambda *a, **k: pytest.fail("traffic made before the refusal"))
    cfg, mix = small_dsvt()
    monkeypatch.setattr(models, "ShastaConfig", Older)
    with pytest.raises(TypeError):
        dsvt_stream.Cell(cfg, mix, 3, "cpu")


def test_generator_rows():
    """Each frame: the key cloud's and the sweeps' rows [x, y, z,
    intensity, lag] padded to cloud_rows with a mask, the same clouds and
    detections as the stream mix's voxelized frames; the same seed gives
    the same rows."""
    from trackbench.gen.scenes import stream_scenes

    cfg, mix = small_dsvt()
    pp = dict(cfg["point_pipeline"], max_points_in_voxel=10, max_voxels=6000)
    one = dict(mix, scenes=1, frames=2)
    a = gd.dsvt_scenes(7, one, pp, {"car": 10})[0]
    b = gd.dsvt_scenes(7, one, pp, {"car": 10})[0]
    s = stream_scenes(7, one, pp, {"car": 10})[0]
    f = a[1]
    assert f["cloud"].shape == (mix["cloud_rows"], 5) and f["cloud"].dtype == np.float32
    assert np.array_equal(f["cloud"], b[1]["cloud"])
    rows = f["cloud"][f["cloud_valid"]]
    assert not f["cloud"][~f["cloud_valid"]].any()
    assert mix["key_points"] < len(rows) <= mix["key_points"] + 9 * mix["sweep_points"]
    assert len(np.unique(rows[:, 4])) == pp["nsweeps"]
    for k in f["boxes"]:
        assert np.array_equal(f["boxes"][k], s[1]["boxes"][k])


def test_count_against_a_hand_count():
    """count/dsvt.py at the small size (pfn [32, 32], d 32, FFN 64, K 8, 48
    x 48 grid, neck 32/32/64 to 96, shared conv 96 -> 32) on a made-up
    frame of 6 pillars (2 windows at shift 0)."""
    m = small_dsvt()[0]["model"]
    rows = np.zeros((10, 5), np.float32)
    cells = [(0, 0), (0, 0), (1, 2), (5, 5), (5, 6), (6, 6), (40, 41), (40, 41), (47, 47), (47, 47)]
    for r, (y, x) in zip(rows, cells):
        r[:2] = (x * 0.3 - 7.2 + 0.1, y * 0.3 - 7.2 + 0.1)
    frame = {"cloud": np.concatenate([rows, np.full((2, 5), 50.0, np.float32)]),
             "cloud_valid": np.ones(12, bool)}
    w = cd.frame_work(frame, m)
    assert (w["points"], w["pillars"]) == (10, 7)
    # shift 0: windows (0, 0) 3, (0, 1) 1, (1, 1) 1, (6, 6) 1, (7, 7) 1 -> 5 sets;
    # shift 3: (0, 0) 2, (1, 1) 3, (7, 6) 1, (8, 8) 1 -> 4 sets
    assert w["sets"] == [5, 4]
    assert cd.reader(10, m) == dict(flops=2.0 * 10 * (11 * 16 + 32 * 32),
                                    bytes=4.0 * (10 * 5 + 10 * 27 + 11 * 16 + 10 * 64 + 32 * 32))
    assert cd.gathers(5, m)["bytes"] == 40 * (8 + 2 * 4 * 32)
    layer = cd.encoder_layer(5, 7, m)
    assert layer["flops"] == (2.0 * 40 * 32 * 96 + 4.0 * 5 * 64 * 32 + 2.0 * 40 * 32 * 32
                              + 4.0 * 7 * 32 * 64)
    weights = 4 * 32 * 32 + 4 * 32 + 2 * 32 * 64 + 64 + 32 + 6 * 32
    assert layer["bytes"] == 40 * (8 + 2 * 4 * 32) + 4.0 * (2 * 7 * 32 + weights)
    assert cd.position_mlp(7, m)["flops"] == 2.0 * 7 * (64 + 32 * 32)
    parts = cd.dsvt_parts(7, [5, 4], m)
    assert len(parts) == 16 and parts[6]["flops"] == cd.encoder_layer(4, 7, m)["flops"]
    assert w["flops"] == cd.reader(10, m)["flops"] + sum(p["flops"] for p in parts)
    assert w["dsvt_least_s"] == pytest.approx(sum(
        max(p["flops"] / work.F32_FLOPS_PER_S, p["bytes"] / work.HBM_BYTES_PER_S) for p in parts))
    convs = cd.neck_convs(m)
    assert [c["name"] for c in convs[:5]] == ["level0.block0.downsample", "level0.block0.conv1",
                                              "level0.block0.conv2", "level0.block1.conv1",
                                              "level0.block1.conv2"]
    assert len(convs) == 23 and convs[-1]["name"] == "shared"
    f = {c["name"]: c["flops"] for c in convs}
    assert f["level0.block1.conv2"] == 2.0 * 48 * 48 * 9 * 32 * 32
    assert f["level1.block0.downsample"] == 2.0 * 24 * 24 * 32 * 32
    assert f["level2.block2.conv1"] == 2.0 * 12 * 12 * 9 * 64 * 64
    assert f["deblock0"] == 2.0 * 24 * 24 * 4 * 32 * 32  # 2 x 2 at stride 2
    assert f["deblock1"] == 2.0 * 24 * 24 * 32 * 32  # 1 x 1
    assert f["deblock2"] == 2.0 * 12 * 12 * 4 * 64 * 32  # transposed 2 x 2
    assert f["shared"] == 2.0 * 24 * 24 * 9 * 96 * 32


def ctx(frames, spans=(), **more):
    return {"frames": frames, **more, "trace": {"busy_s": 1.0, "spans": {
        n: {"host_s": 1.0, "device_s": d, "count": c} for n, (d, c) in dict(spans).items()}}}


@pytest.mark.parametrize("name,span", [("dynpillar_dev_ms.stream", "step.dyn_pillars"),
                                       ("dsvt_dev_ms.stream", "step.dsvt")])
def test_device_ms_readers(name, span):
    read = run.reader(name).read
    assert read(ctx(16, {span: (0.032, 32)})) == pytest.approx(2.0)
    assert read(ctx(16, {"step.neck": (1.0, 16)})) is None  # no such span


def test_rooflines_read_the_least_time_over_the_span():
    dsvt = run.reader("dsvt_roofline.stream").read
    assert dsvt(ctx(2, {"step.dsvt": (0.01, 2)}, dsvt_least_s=[1e-3, 2e-3])) == pytest.approx(30.0)
    assert dsvt(ctx(2, {"step.dsvt": (0.01, 2)})) is None
    assert dsvt(ctx(2, dsvt_least_s=[1e-3])) is None
    m = small_dsvt()[0]["model"]
    convs = cd.neck_convs(m)
    least = sum(cp.conv_least_s(c) for c in convs)
    neck = run.reader("neck_roofline.stream").read
    assert neck(ctx(2, {"step.neck": (least, 2)}, neck_convs=[convs, convs])) == pytest.approx(200.0)
    assert neck(ctx(2, {"step.neck": (least, 2)})) is None


def test_dsvt_slot_fill_reads_the_counters(monkeypatch):
    mod = run.reader("dsvt_slot_fill.stream")
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(4):
                profiler.count("dsvt.pillars", [18000])
                profiler.count("dsvt.slots", [270 * 90])
        assert mod.read(ctx(1)) == pytest.approx(100.0 * 18000 / 24300)
        profiler.reset_counters()
        assert mod.read(ctx(1)) is None  # a trunk without DSVT
        monkeypatch.delattr(profiler, "counters")
        assert mod.read(ctx(1)) is None  # a program without counters
    finally:
        profiler.reset_counters()
