"""The MVP cell (`carmvp.stream`) on the CPU at a small size: its run reads
within its limits and counts the trunk's real work at 21 features in; a
fault in the timed path (the real and the virtual points' blocks swapped)
reads `correct: false`; a program without the dynamic reader refuses the
cell in set-up; the generator's rows; the two new readers on hand-made
contexts."""
import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.utils import profiler
from trackbench import run
from trackbench.gen import mvp as gm
from trackbench.tests.small import load
from trackbench.tests.small_mvp import small_mvp

CELL = "carmvp.stream"


def e2e():
    bench = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
    return [m for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])]


def correct(c: dict) -> bool:
    limits = load("limits", CELL)
    assert set(c) == set(limits)
    return all(c[k] <= limits[k] for k in limits)


def test_cell_within_limits_and_its_work_on_cpu():
    """A window, the check and the work the traced metrics read: the
    trunk's 21 convs a frame from the reference's voxels, conv_input at 21
    channels in."""
    from trackbench.drivers.mvp_stream import Cell

    cfg, mix = small_mvp()
    cell = Cell(cfg, mix, 2**31 + 19, "cpu")
    rec = cell.window(1.0)
    assert rec["frames"] >= 1 and set(rec) >= {"latency_s", "queue_s"}
    w = cell.work()
    cell.release()
    c = cell.check()
    assert correct(c), c
    assert len(w["convs"]) == len(w["flops"]) == rec["frames"]
    first = w["convs"][0]
    assert len(first) == 21 and first[0]["name"] == "conv_input" and first[0]["cin"] == 21
    assert first[0]["hits"] > 0 and min(w["flops"]) > 0


def test_real_and_virtual_blocks_swapped_is_caught(monkeypatch):
    """The program's reader fed each row with real and virtual swapped (a
    real point's features in the painted/virtual block and back)."""
    from shasta_tpu_torch.models import shasta

    orig = shasta.dynamic_voxelize_virtual

    def swapped(points, *a, **k):
        kind = points[:, -2]
        flipped = points.clone()
        flipped[:, -2] = kind.where(kind == 0, -kind)
        return orig(flipped, *a, **k)
    monkeypatch.setattr(shasta, "dynamic_voxelize_virtual", swapped)
    cfg, mix = small_mvp()
    out = run.run_cell(cfg, mix, 2**31 + 19, 0.5, False, "cpu", e2e(), [])
    assert not correct(out["compared"])


def test_driver_refuses_a_program_without_the_dynamic_reader(monkeypatch):
    """A ShastaConfig without the reader's keys (the program before the
    dynamic reader) fails the cell's set-up at once, before any traffic is
    made."""
    import dataclasses

    from shasta_tpu_torch import models
    from trackbench.drivers import mvp_stream

    @dataclasses.dataclass(frozen=True)
    class Older:
        max_obj: int = 90
        dtype: object = None

    monkeypatch.setattr(mvp_stream, "mvp_scenes",
                        lambda *a, **k: pytest.fail("traffic made before the refusal"))
    cfg, mix = small_mvp()
    monkeypatch.setattr(models, "ShastaConfig", Older)
    with pytest.raises(TypeError):
        mvp_stream.Cell(cfg, mix, 3, "cpu")


def test_generator_rows():
    """Each frame: the real points (the key cloud and its sweeps) of type
    1 with their intensity, the key cloud's object points painted (type 0,
    a one-hot class and a score), virtual_points virtual points an object a
    sweep (type -1) at the sweep's lag, padded to cloud_rows with a mask;
    the same seed gives the same rows."""
    cfg, mix = small_mvp()
    pp = cfg["point_pipeline"]
    a = gm.mvp_scenes(7, dict(mix, scenes=1, frames=2), pp, {"car": 10})[0]
    b = gm.mvp_scenes(7, dict(mix, scenes=1, frames=2), pp, {"car": 10})[0]
    f = a[1]
    assert f["cloud"].shape == (mix["cloud_rows"], 16) and f["cloud"].dtype == np.float32
    assert np.array_equal(f["cloud"], b[1]["cloud"])
    rows = f["cloud"][f["cloud_valid"]]
    assert not f["cloud"][~f["cloud_valid"]].any()
    kind = rows[:, gm.TYPE]
    n_virtual = mix["objects"] * mix["virtual_points"] * pp["nsweeps"]
    assert int((kind == -1).sum()) == n_virtual
    assert int((kind == 0).sum()) == mix["key_points"] // 5
    assert set(np.unique(kind)) == {-1.0, 0.0, 1.0}
    other = rows[kind != 1]
    assert np.array_equal(other[:, 3:13].sum(1), np.ones(len(other), np.float32))
    assert ((other[:, 13] >= 0.3) & (other[:, 13] < 1)).all()
    assert not rows[kind == 1][:, 4:14].any()
    lags = np.unique(rows[kind == -1][:, gm.TIME])
    assert len(lags) == pp["nsweeps"] and lags[0] == 0.0
    with pytest.raises(ValueError, match="rows"):
        gm.rows(rows, len(rows) - 1)


def ctx(frames, spans=()):
    return {"frames": frames, "trace": {"busy_s": 1.0, "spans": {
        n: {"host_s": 1.0, "device_s": d, "count": c} for n, (d, c) in dict(spans).items()}}}


def test_dynvox_dev_ms_reads_device_ms_a_frame():
    read = run.reader("dynvox_dev_ms.stream").read
    assert read(ctx(16, {"step.dynamic_voxel": (0.016, 16)})) == pytest.approx(1.0)
    assert read(ctx(16, {"step.sparse_trunk": (1.0, 16)})) is None  # no reader span


def test_dynvox_fill_reads_the_counters(monkeypatch):
    mod = run.reader("dynvox_fill.stream")
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for kept in (90000, 110000):
                profiler.count("dynvox.voxels", [kept])
                profiler.count("dynvox.slots", [160000])
        assert mod.read(ctx(2)) == pytest.approx(100.0 * 200000 / 320000)
        profiler.reset_counters()
        assert mod.read(ctx(2)) is None  # a trunk without the dynamic reader
        monkeypatch.delattr(profiler, "counters")
        assert mod.read(ctx(2)) is None  # a program without counters
    finally:
        profiler.reset_counters()
