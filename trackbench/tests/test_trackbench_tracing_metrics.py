"""The readers of the program's spans and counters on hand-made contexts:
each reads its span or counter a frame, and reads nothing (None) from a
trace or a program without them."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.utils import profiler
from trackbench import run


def ctx(frames, **spans):
    """A traced run's context: {span: (host_s, count)}."""
    return {"frames": frames, "trace": {"busy_s": 1.0, "spans": {
        n.replace("_", "."): {"host_s": h, "device_s": 0.0, "count": c}
        for n, (h, c) in spans.items()}}}


@pytest.mark.parametrize("name,span", [
    ("points_ms.eval", "data_points"), ("voxelize_ms.eval", "data_voxelize"),
    ("step_host_ms.stream", "step_frame"), ("upload_ms.stream", "step_upload"),
    ("fetch_wait_ms.stream", "step_fetch")])
def test_span_readers_give_host_ms_a_frame(name, span):
    read = run.reader(name).read
    assert read(ctx(80, **{span: (12.0, 160)})) == pytest.approx(150.0)
    assert read(ctx(80, step_neck=(1.0, 80))) is None  # a program without the span


def test_clouds_per_frame_counts_the_voxelize_spans():
    read = run.reader("clouds_per_frame.eval").read
    assert read(ctx(80, data_voxelize=(12.0, 160))) == 2.0
    assert read(ctx(80, data_voxelize=(6.0, 80))) == 1.0
    assert read(ctx(80, eval_read=(1.0, 11))) is None


@pytest.fixture
def counted():
    """Counters of two traced steps of two lanes: conv2 keeps 10 + 6 of 20
    slots, extra 3 + 3 of 10."""
    profiler.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            profiler.count("trunk.cap.conv2.demand", torch.tensor([10, 9]))
            profiler.count("trunk.cap.conv2.kept", torch.tensor([10, 6]))
            profiler.count("trunk.cap.conv2.slots", 20)
            profiler.count("trunk.cap.extra.demand", np.array([3, 3]))
            profiler.count("trunk.cap.extra.kept", np.array([3, 3]))
            profiler.count("trunk.cap.extra.slots", 10)
            profiler.count("other.kept", 1000)
    yield
    profiler.reset_counters()


@pytest.mark.parametrize("name", ["cap_fill.eval", "cap_fill.stream"])
def test_cap_fill_reads_kept_over_slots(counted, name, monkeypatch):
    read = run.reader(name).read
    assert read(ctx(8)) == pytest.approx(100.0 * 2 * (16 + 6) / (2 * (20 + 10)))
    profiler.reset_counters()
    assert read(ctx(8)) is None  # nothing counted
    monkeypatch.delattr(profiler, "counters")
    assert read(ctx(8)) is None  # a program without counters
