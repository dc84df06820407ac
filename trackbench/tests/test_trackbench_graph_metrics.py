"""The trunk-graph stream reader on hand-made contexts: the
`trunk.graph_replays` counter a frame; nothing (None) from a program
without the trunk's graph or without counters, 0 where the graph is there
but no frame replayed it."""
import pytest
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.utils import profiler
from trackbench import run


def test_trunk_graph_replays_reads_replays_a_frame(monkeypatch):
    mod = run.reader("trunk_graph_replays.stream")
    ctx = {"frames": 16, "trace": {"busy_s": 1.0, "spans": {}}}
    profiler.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(16):
                profiler.count("trunk.graph_replays", 1)
            profiler.count("tracker.greedy_launches", 16)
        assert mod.read(ctx) == pytest.approx(1.0)
        profiler.reset_counters()
        profiler.count("trunk.graph_replays", 1)  # no profiler records: not counted
        assert mod.read(ctx) == 0  # the program has the graph, its trunk ran eagerly
        monkeypatch.setattr(mod, "GRAPH", "shasta_tpu_torch.models.no_such_module")
        assert mod.read(ctx) is None  # a program without the graph (the parent)
        monkeypatch.undo()
        monkeypatch.delattr(profiler, "counters")
        assert mod.read(ctx) is None  # a program without counters
    finally:
        profiler.reset_counters()
