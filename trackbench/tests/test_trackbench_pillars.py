"""The pillar cell (`carpp.stream`) on the CPU at a small size: its run
reads within its limits; a fault in the timed path (the scatter's x and y
swapped, or the JAX module's masked reading in place of det3d's PFN)
reads `correct: false`; its three new readers on hand-made contexts; and
count/pillars.py against the published neck's 82.4 GFLOP."""
import json

import pytest
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.utils import profiler
from trackbench import run
from trackbench.count import pillars as cp
from trackbench.tests.small import load
from trackbench.tests.small_pp import small_pp

CELL = "carpp.stream"


def e2e():
    bench = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
    return [m for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])]


def compared(seed=2**31 + 17) -> dict:
    cfg, mix = small_pp()
    out = run.run_cell(cfg, mix, seed, 1.0, False, "cpu", e2e(), [])
    assert out["frames"] >= 1
    return out["compared"]


def correct(c: dict) -> bool:
    limits = load("limits", CELL)
    assert set(c) == set(limits)
    return all(c[k] <= limits[k] for k in limits)


def test_cell_within_limits_on_cpu():
    c = compared()
    assert correct(c), c


def test_scatter_with_x_and_y_swapped_is_caught(monkeypatch):
    from shasta_tpu_torch.models import shasta

    orig = shasta.point_pillars_scatter

    def swapped(feats, coords, valid, B, ny, nx):
        return orig(feats, coords[:, [0, 1, 3, 2]], valid, B, ny, nx)
    monkeypatch.setattr(shasta, "point_pillars_scatter", swapped)
    assert not correct(compared())


def test_masked_pfn_reading_is_caught(monkeypatch):
    """The port's JAX reading (padded slots masked out of each max) on
    det3d's widths."""
    from shasta_tpu_torch.models.pillars import PillarFeatureNet

    orig = PillarFeatureNet.forward

    def masked(self, *a):
        self.det3d = False
        try:
            return orig(self, *a)
        finally:
            self.det3d = True
    monkeypatch.setattr(PillarFeatureNet, "forward", masked)
    assert not correct(compared())


def test_driver_refuses_a_program_without_the_pillar_reader(monkeypatch):
    """A ShastaConfig without the pillar keys (the program before the
    pillar reader) fails the cell's set-up at once, before any traffic is
    made."""
    import dataclasses

    from shasta_tpu_torch import models
    from trackbench.drivers import pillar_stream

    @dataclasses.dataclass(frozen=True)
    class Older:
        max_obj: int = 90
        dtype: object = None

    monkeypatch.setattr(models, "ShastaConfig", Older)
    monkeypatch.setattr(pillar_stream, "stream_scenes",
                        lambda *a, **k: pytest.fail("traffic made before the refusal"))
    cfg, mix = small_pp()
    with pytest.raises(TypeError):
        pillar_stream.Cell(cfg, mix, 3, "cpu")


def ctx(frames, **spans):
    return {"frames": frames, "trace": {"busy_s": 1.0, "spans": {
        n.replace("_", "."): {"host_s": 1.0, "device_s": d, "count": c}
        for n, (d, c) in spans.items()}}}


def test_pillars_dev_ms_reads_device_ms_a_frame():
    read = run.reader("pillars_dev_ms.stream").read
    assert read(ctx(16, step_pillars=(0.032, 16))) == pytest.approx(2.0)
    assert read(ctx(16, step_sparse_trunk=(1.0, 16))) is None  # no pillar span


def test_pillar_fill_reads_the_counters(monkeypatch):
    mod = run.reader("pillar_fill.stream")
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for kept in (24000, 25000):
                profiler.count("pillars.kept", [kept])
                profiler.count("pillars.slots", [60000])
        assert mod.read(ctx(2)) == pytest.approx(100.0 * 49000 / 120000)
        profiler.reset_counters()
        assert mod.read(ctx(2)) is None  # a trunk without the pillar reader
        monkeypatch.delattr(profiler, "counters")
        assert mod.read(ctx(2)) is None  # a program without counters
    finally:
        profiler.reset_counters()


def test_neck_roofline_reads_least_time_over_device_time():
    read = run.reader("neck_roofline.stream").read
    m = small_pp()[0]["model"]
    convs = cp.neck_convs(m)
    least = sum(map(cp.conv_least_s, convs))
    c = dict(ctx(2, step_neck=(4 * least, 2)), neck_convs=[convs, convs])
    assert read(c) == pytest.approx(50.0)
    assert read(ctx(2, step_neck=(1.0, 2))) is None  # a driver without neck_convs
    assert read(dict(ctx(2, step_trunk=(1.0, 2)), neck_convs=[convs])) is None


def test_count_of_the_published_neck():
    """The published neck at 512 x 512: 20 convs, 82.4 GFLOP (19.3 in
    block 0, 1.07 the 2x2 conv, 26.6 in each of blocks 1 and 2, 0.54 the
    1x1 deblock, 1.07 the deconv, 7.25 the shared conv), 0.50 ms at the
    f32 peak; the reader 10.6 GFLOP over 60,000 x 20 slots."""
    m = load("configs", "shasta-car-pp")["model"]
    convs = cp.neck_convs(m)
    assert len(convs) == 20
    g = {c["name"]: c["flops"] / 1e9 for c in convs}
    assert sum(v for k, v in g.items() if k.startswith("block0")) == pytest.approx(19.327, abs=1e-3)
    assert g["deblock0"] == g["deblock2"] == pytest.approx(1.0737, abs=1e-4)
    assert g["deblock1"] == pytest.approx(0.5369, abs=1e-4)
    assert g["shared"] == pytest.approx(7.2478, abs=1e-4)
    assert cp.dense_flops(m) / 1e9 == pytest.approx(82.41, abs=0.01)
    assert sum(map(cp.conv_least_s, convs)) * 1e3 == pytest.approx(0.502, abs=1e-3)
    assert cp.reader_flops(60000, 20, m) == 2 * 60000 * 20 * (10 * 32 + 64 * 64)
    d0 = next(c for c in convs if c["name"] == "deblock0")
    assert cp.conv_bytes(d0) == 4 * (256 * 256 * 64 + 128 * 128 * 128 + 4 * 64 * 128)
