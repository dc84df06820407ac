"""The neck's stream readers on hand-made contexts: device milliseconds a
frame under `step.neck`, and the `neck.kernel_convs` counter a frame; each
reads nothing (None) from a trace or a program without its span, kernel or
counters, and the counter reads 0 where the kernel is there but unused."""
import pytest
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.utils import profiler
from trackbench import run


def ctx(frames, **spans):
    """A traced run's context: {span: (device_s, count)}."""
    return {"frames": frames, "trace": {"busy_s": 1.0, "spans": {
        n.replace("_", "."): {"host_s": 1.0, "device_s": d, "count": c}
        for n, (d, c) in spans.items()}}}


def test_neck_dev_ms_reads_device_ms_a_frame():
    read = run.reader("neck_dev_ms.stream").read
    assert read(ctx(16, step_neck=(0.064, 16))) == pytest.approx(4.0)
    assert read(ctx(16, step_trunk=(1.0, 16))) is None  # a program without the span


def test_neck_kernel_convs_reads_launches_a_frame(monkeypatch):
    mod = run.reader("neck_kernel_convs.stream")
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2 * 15):
                profiler.count("neck.kernel_convs", 1)
            profiler.count("trunk.cap.conv2.kept", 7)
        assert mod.read(ctx(2)) == pytest.approx(15.0)
        profiler.reset_counters()
        profiler.count("neck.kernel_convs", 1)  # no profiler records: not counted
        assert mod.read(ctx(2)) == 0  # the program has the kernel, its neck never took it
        monkeypatch.setattr(mod, "KERNEL", "shasta_tpu_torch.ops.kernels.no_such_kernel")
        assert mod.read(ctx(2)) is None  # a program without the kernel (the parent)
        monkeypatch.undo()
        monkeypatch.delattr(profiler, "counters")
        assert mod.read(ctx(2)) is None  # a program without counters
    finally:
        profiler.reset_counters()
