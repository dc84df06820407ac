"""A run with the timed path broken underneath reads `correct: false`:
each cell driven on the CPU at a small size (the harness's look for a card
skipped), once for each fault the cell can have: a step that leaves its
state unchanged, half of the lanes or classes left out, an answer altered
where it is produced. (One card: no exchange between chips to leave out.)"""
import pytest

from trackbench import run
from trackbench.tests.small import load, small
from trackbench.tests.test_trackbench_reference import CELLS, e2e_of


def correct(cell) -> bool:
    cfg, mix = small(*CELLS[cell])
    out = run.run_cell(cfg, mix, 2**31 + 29, 1.0, False, "cpu", e2e_of(cell), [])
    limits = load("limits", cell)
    return all(out["compared"][k] <= limits[k] for k in limits)


def freeze(cls, method, fields):
    """cls.method that leaves the carried `fields` as they were."""
    orig = getattr(cls, method)

    def frozen(self, *a, **k):
        kept = [getattr(self, f) for f in fields]
        out = orig(self, *a, **k)
        for f, v in zip(fields, kept):
            setattr(self, f, v)
        return out
    return frozen


def test_state_unchanged(monkeypatch):
    from shasta_tpu_torch.infer import MultiClassScenePipeline, ScenePipeline
    from shasta_tpu_torch.tracker.runner import EvalLanes

    carry = ["_prev_feat", "_prev_boxes"]
    monkeypatch.setattr(ScenePipeline, "_step", freeze(ScenePipeline, "_step",
                                                       carry + ["_table", "_n_prev"]))
    monkeypatch.setattr(MultiClassScenePipeline, "dispatch_frame",
                        freeze(MultiClassScenePipeline, "dispatch_frame", carry + ["_tables"]))
    monkeypatch.setattr(EvalLanes, "_step", freeze(EvalLanes, "_step", carry))
    for cell in CELLS:
        assert not correct(cell), cell


def test_half_left_out(monkeypatch):
    from shasta_tpu_torch.infer import MultiClassScenePipeline
    from shasta_tpu_torch.tracker import runner

    def half_lanes(orig):
        def step(self, f, sc):
            out = orig(self, f, sc)
            out[out.shape[0] // 2:] = 0.0
            return out
        return step

    def half_classes(orig):
        def dispatch(self, frame, class_boxes, time_lag):
            names = sorted(class_boxes)
            return orig(self, frame, {n: class_boxes[n] for n in names[: len(names) // 2]},
                        time_lag)
        return dispatch

    monkeypatch.setattr(runner.EvalLanes, "_step", half_lanes(runner.EvalLanes._step))
    monkeypatch.setattr(MultiClassScenePipeline, "dispatch_frame",
                        half_classes(MultiClassScenePipeline.dispatch_frame))
    assert not correct("car.eval8")
    assert not correct("nusc7.stream")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_answer_altered(monkeypatch, cell):
    from shasta_tpu_torch import infer
    from shasta_tpu_torch.tracker import runner

    def packed(*a):
        out = orig_packed(*a)
        out[..., 3, 0] = 1.0 - out[..., 3, 0]  # the first detection's keep flag
        return out

    def rows(dec):
        out = orig_rows(dec)
        out[..., 5, :] += 1e-2  # the refined scores
        return out

    orig_packed, orig_rows = infer._packed, runner._decision_rows
    monkeypatch.setattr(infer, "_packed", packed)
    monkeypatch.setattr(runner, "_decision_rows", rows)
    assert not correct(cell)
