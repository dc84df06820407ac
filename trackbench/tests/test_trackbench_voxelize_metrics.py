"""The card voxelizer's eval readers on hand-made contexts: device
milliseconds a frame under `step.voxelize`, and the `voxelize.clouds`
counter a frame; each reads nothing (None) from a trace or a program
without its span, kernel or counters."""
import pytest
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.utils import profiler
from trackbench import run


def ctx(frames, **spans):
    """A traced run's context: {span: (device_s, count)}."""
    return {"frames": frames, "trace": {"busy_s": 1.0, "spans": {
        n.replace("_", "."): {"host_s": 1.0, "device_s": d, "count": c}
        for n, (d, c) in spans.items()}}}


def test_voxelize_dev_ms_reads_device_ms_a_frame():
    read = run.reader("voxelize_dev_ms.eval").read
    assert read(ctx(80, step_voxelize=(0.008, 16))) == pytest.approx(0.1)
    assert read(ctx(80, data_voxelize=(0.0, 160))) is None  # the host voxelizes


def test_card_clouds_per_frame_reads_clouds_a_frame(monkeypatch):
    mod = run.reader("card_clouds_per_frame.eval")
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for n in (8, 8, 2):
                profiler.count("voxelize.clouds", n)
        assert mod.read(ctx(18)) == pytest.approx(1.0)
        profiler.reset_counters()
        assert mod.read(ctx(18)) == 0  # the program has the kernel, its eval never took it
        monkeypatch.setattr(mod, "KERNEL", "shasta_tpu_torch.ops.kernels.no_such_kernel")
        assert mod.read(ctx(18)) is None  # a program without the kernel (the parent)
        monkeypatch.undo()
        monkeypatch.delattr(profiler, "counters")
        assert mod.read(ctx(18)) is None  # a program without counters
    finally:
        profiler.reset_counters()
