"""The end-to-end arithmetic: the rate covers every frame and the whole
window, the 90th percentile every frame's latency."""
import pytest

from trackbench import run


def test_percentile_over_all_frames():
    lat = list(range(1, 101))  # 1..100 ms
    assert run.percentile(lat, 90) == pytest.approx(90.1)
    assert run.percentile([5.0] * 7 + [100.0] * 3, 90) == 100.0


def test_rate_is_frames_over_the_window(monkeypatch):
    class Cell:
        def __init__(self, *a):
            pass

        def window(self, seconds):
            return dict(frames=30, wall_s=12.5, latency_s=[0.4] * 30, queue_s=[0.1] * 30)

        def release(self):
            pass

        def check(self):
            return {"score_gap": 0.0}

    import types
    import sys
    mod = types.ModuleType("trackbench.drivers.fake")
    mod.Cell = Cell
    monkeypatch.setitem(sys.modules, "trackbench.drivers.fake", mod)
    e2e = [{"name": "frames_per_s", "unit": "frames/s"}, {"name": "frame_p90_ms", "unit": "ms"},
           {"name": "setup_s", "unit": "s"}]
    out = run.run_cell({}, {"driver": "fake"}, 1, 10.0, False, "cpu", e2e, [])
    assert out["metrics"]["frames_per_s"]["value"] == 30 / 12.5
    assert abs(out["metrics"]["frame_p90_ms"]["value"] - 400.0) < 1e-9
    assert out["metrics"]["setup_s"]["value"] > 0
