"""The greedy-kernel stream reader on hand-made contexts: the
`tracker.greedy_launches` counter a frame; nothing (None) from a program
without the kernel or without counters, 0 where the kernel is there but
unused."""
import pytest
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.utils import profiler
from trackbench import run


def test_greedy_launches_reads_launches_a_frame(monkeypatch):
    mod = run.reader("greedy_launches.stream")
    ctx = {"frames": 16, "trace": {"busy_s": 1.0, "spans": {}}}
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(16):
                profiler.count("tracker.greedy_launches", 1)
            profiler.count("neck.kernel_convs", 15)
        assert mod.read(ctx) == pytest.approx(1.0)
        profiler.reset_counters()
        profiler.count("tracker.greedy_launches", 1)  # no profiler records: not counted
        assert mod.read(ctx) == 0  # the program has the kernel, its tracker never took it
        monkeypatch.setattr(mod, "KERNEL", "shasta_tpu_torch.ops.kernels.no_such_kernel")
        assert mod.read(ctx) is None  # a program without the kernel (the parent)
        monkeypatch.undo()
        monkeypatch.delattr(profiler, "counters")
        assert mod.read(ctx) is None  # a program without counters
    finally:
        profiler.reset_counters()
