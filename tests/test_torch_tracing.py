"""The port's spans and counters (CPU): `utils.profiler.count` outside a
profiler does nothing, the trunk's cap counters per lane on both routes of
the index builds, the eval's spans around reading (the dataset's data.*
spans inside eval.read) and the serving step's step.frame, step.upload and
step.fetch; and the aten operations each stepper dispatches a step, held at
or below the counts the steppers had before they shared one lane step."""
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from shasta_tpu_torch.data.synthetic import make_batch, write_split_config, write_track_split
from shasta_tpu_torch.infer import BatchedScenePipeline, MultiClassScenePipeline, ScenePipeline
from shasta_tpu_torch.models import ShastaConfig, ShastaModel
from shasta_tpu_torch.ops import sparse as sp
from shasta_tpu_torch.plans import frame_plans
from shasta_tpu_torch.tools.common import build_dataset, build_model
from shasta_tpu_torch.tracker.runner import EvalLanes, run_affinity_eval_batched
from shasta_tpu_torch.utils import Config
from shasta_tpu_torch.utils import profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(max_obj=6, grid_shape=(41, 48, 48), cap_conv2=512, cap_conv3=256,
             cap_conv4=128, cap_extra=128)
STAGES = ("conv2", "conv3", "conv4", "extra")
HOLD = dict(cap_conv2=20000, cap_conv3=20000, cap_conv4=20000, cap_extra=20000)
VOXELS = 1500


@pytest.fixture(autouse=True)
def fresh_counters():
    profiler.reset_counters()
    yield
    profiler.reset_counters()


class Ops(TorchDispatchMode):
    """The aten operations run inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _spans(prof, name):
    """(start, end) in microseconds of each span `name` in the trace."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events() if e.name == name]


def _inside(inner, outer):
    return all(any(s >= a and e <= b for a, b in outer) for s, e in inner)


def _lanes(cfg, B, seed=0):
    """B frames of make_batch, stacked as one (1, B, ...) chunk."""
    frames = [make_batch(cfg, num_voxels_cap=VOXELS, n_dets=4, seed=seed + b) for b in range(B)]
    return {k: np.concatenate([f[k] for f in frames])[None]
            for k in ("voxels", "num_points", "coordinates", "voxels_valid", "det_boxes")}


def _run_lanes(cfg, B):
    """One EvalLanes step of B lanes under the profiler; the counters."""
    model = ShastaModel(cfg, device="cpu")
    lanes = EvalLanes(model, B)
    with _cpu_profile():
        lanes.step_chunk(_lanes(cfg, B), [[True] * B], [[4] * B]).array()
    return profiler.counters()


def _cap(c, stage):
    return {k: c[f"trunk.cap.{stage}.{k}"] for k in ("demand", "kept", "slots")}


def test_count_outside_a_profiler_records_nothing_and_allocates_nothing():
    assert not profiler.recording()
    cfg = ShastaConfig(**SMALL)
    f = make_batch(cfg, num_voxels_cap=VOXELS, seed=0)
    st = sp.SparseTensor(torch.zeros(VOXELS, 5),
                         torch.cat([torch.zeros(VOXELS, 1, dtype=torch.int32),
                                    torch.as_tensor(f["coordinates"][0]).int()], 1),
                         torch.as_tensor(f["voxels_valid"][0]), cfg.grid_shape, 1)
    geom = ((3, 3, 3), (2, 2, 2), (1, 1, 1))
    sp.strided_output_set(st, *geom, 64, plain=True)  # makes the cached constants
    with Ops() as counted:
        profiler.count("x", 3)
        profiler.count("y", np.ones(2, np.int64))
        sp.strided_output_set(st, *geom, 64, plain=True, stage="conv2")
    with Ops() as uncounted:
        sp.strided_output_set(st, *geom, 64, plain=True)
    assert counted.ops == uncounted.ops  # not one tensor more
    frame_plans(f["coordinates"][0], f["voxels_valid"][0], cfg)
    assert profiler.counters() == {}
    with _cpu_profile():
        profiler.count("x", 3)
        profiler.count("x", torch.tensor([1, 2]))
        profiler.count("x", np.array([1]))
    assert profiler.counters() == {"x": [5, 2]}


def test_cap_counters_per_lane_see_the_later_lane_cut():
    """B=2 lanes: at caps that hold, every row is kept; at caps between
    lane 0's set and both lanes' sets, lane 0 keeps its keys (the smallest)
    and lane 1 loses rows."""
    held = _run_lanes(ShastaConfig(**dict(SMALL, **HOLD)), 2)
    for stage in STAGES:
        c = _cap(held, stage)
        assert c["demand"] == c["kept"] and min(c["demand"]) > 0, (stage, c)
        assert c["slots"] == 20000
    d = {s: _cap(held, s)["demand"] for s in STAGES}
    caps = dict(cap_conv2=d["conv2"][0] + d["conv2"][1] // 2,
                cap_conv3=d["conv3"][0] + d["conv3"][1] // 2,
                cap_conv4=d["conv4"][0] + d["conv4"][1] // 2,
                cap_extra=d["extra"][0] + d["extra"][1] // 2)
    profiler.reset_counters()
    cut = _run_lanes(ShastaConfig(**dict(SMALL, **caps)), 2)
    for stage in STAGES:
        c = _cap(cut, stage)
        assert c["kept"][0] == c["demand"][0] == d[stage][0], (stage, c)  # lane 0: no cut
        assert sum(c["kept"]) <= c["slots"]
    c2 = _cap(cut, "conv2")
    assert c2["demand"][1] - c2["kept"][1] == d["conv2"][1] - d["conv2"][1] // 2 > 0
    assert c2["kept"][1] + c2["kept"][0] == c2["slots"]  # the cap is full


@pytest.mark.parametrize("caps", ["hold", "cut"])
def test_cap_counters_agree_between_the_host_plans_and_the_device_route(caps):
    cfg = ShastaConfig(**dict(SMALL, **HOLD))
    if caps == "cut":
        cfg = ShastaConfig(**dict(SMALL, cap_conv2=300, cap_conv3=150, cap_conv4=60,
                                  cap_extra=40))
    f = make_batch(cfg, num_voxels_cap=VOXELS, seed=3)
    with _cpu_profile():
        frame_plans(f["coordinates"][0], f["voxels_valid"][0], cfg)
    host = profiler.counters()
    profiler.reset_counters()
    model = ShastaModel(cfg, device="cpu")
    with _cpu_profile(), torch.no_grad():
        model.frame_features({k: torch.as_tensor(v) for k, v in f.items()})
    device = profiler.counters()
    assert set(host) == {f"trunk.cap.{s}.{k}" for s in STAGES
                         for k in ("demand", "kept", "slots")}
    assert host == device
    cut = sum(_cap(host, s)["demand"][0] - _cap(host, s)["kept"][0] for s in STAGES)
    assert (cut > 0) == (caps == "cut")


def test_eval_spans_name_reading_and_agree_with_its_timings(tmp_path):
    """run_affinity_eval_batched over a 2 x 3-frame split: eval.read holds
    each frame's data.dets and data.points spans (one cloud a frame, no host
    voxelizing: no data.voxelize span), each call's step.voxelize lies in
    eval.step between its step.upload and its step.trunk, and
    timings["read"] is the eval.read spans' host time."""
    base = write_split_config(os.path.join(REPO, "configs", "nusc", "car.py"), {},
                              str(tmp_path / "base.py"), max_objects=6,
                              model=dict(SMALL, pc_start=(-12.0, -12.0), voxel_size=(0.3, 0.3)),
                              point_pipeline=dict(voxel_size=(0.3, 0.3, 0.2),
                                                  pc_range=(-12.0, -12.0, -5.0, 12.0, 12.0, 3.0),
                                                  max_voxels=2000, nsweeps=2))
    sp_ = write_track_split(str(tmp_path / "data"), Config.fromfile(base), n_scenes=2,
                            n_frames=3, seed=4, n_objects=6, n_points=3000, n_spots=800)
    cfg = Config.fromfile(write_split_config(base, sp_["val"], str(tmp_path / "split.py")))
    model = build_model(cfg, "cpu")
    # the first span a process profiles costs ~1 ms more: not a part of reading
    with _cpu_profile(), profiler.annotate("warm-up"):
        pass
    timings: dict = {}
    with _cpu_profile() as prof:
        annos = run_affinity_eval_batched(model, build_dataset(cfg, "val"), batch=2,
                                          timings=timings)
    frames = len(annos["results"])
    assert frames == 6
    read = _spans(prof, "eval.read")
    for name in ("data.points", "data.dets"):
        assert _inside(_spans(prof, name), read), name
    assert len(_spans(prof, "data.points")) == frames and _spans(prof, "data.voxelize") == []
    steps = _spans(prof, "eval.step")
    assert len(steps) == 3 and len(_spans(prof, "eval.assemble")) >= 1  # 3 rows of 2 lanes
    vox = _spans(prof, "step.voxelize")
    assert len(vox) == len(steps) and _inside(vox, steps)
    for (us, ue), (vs, ve), (ts, _) in zip(_spans(prof, "step.upload"), vox,
                                            _spans(prof, "step.trunk")):
        assert ue <= vs and ve <= ts
    span_s = sum(e - s for s, e in read) * 1e-6
    assert abs(span_s - timings["read"]) <= 0.05 * timings["read"], (span_s, timings)
    assert _inside(_spans(prof, "step.upload"), _spans(prof, "eval.step"))


def test_step_frame_spans_its_upload_and_the_fetch():
    cfg = ShastaConfig(**SMALL)
    pipe = ScenePipeline(ShastaModel(cfg, device="cpu"), cls_id=0)
    f = make_batch(cfg, num_voxels_cap=VOXELS, n_dets=4, seed=1)
    frame = {k: f[k] for k in ("voxels", "num_points", "coordinates", "voxels_valid",
                               "det_boxes")}
    with _cpu_profile() as prof:
        out = pipe.step_frame(frame, 4, 0.5)
    assert len(_spans(prof, "step.frame")) == len(_spans(prof, "step.upload")) == 1
    assert _inside(_spans(prof, "step.upload"), _spans(prof, "step.frame"))
    assert _inside(_spans(prof, "step.sparse_trunk"), _spans(prof, "step.frame"))
    assert _spans(prof, "step.fetch") == []
    with _cpu_profile() as prof:
        out.tid, out.used  # noqa: B018: the first field read fetches, the second reuses
    assert len(_spans(prof, "step.fetch")) == 1


def _stepper(kind):
    """(a stepper at SMALL, one step of it as f(reset)): the step feeds two
    lanes or classes of 600 voxel slots and 4 dets, lane 0 starting its
    scene where reset is set."""
    cfg = ShastaConfig(**SMALL)
    frames = [make_batch(cfg, num_voxels_cap=600, n_dets=4, seed=s) for s in (1, 2)]
    keys = ("voxels", "num_points", "coordinates", "voxels_valid", "det_boxes")
    two = {k: np.concatenate([f[k] for f in frames]) for k in keys}
    torch.manual_seed(0)
    model = ShastaModel(cfg, device="cpu")
    if kind == "scene":
        pipe = ScenePipeline(model, cls_id=0)
        one = {k: frames[0][k] for k in keys}

        def step(reset):
            if reset:
                pipe.reset()
            return pipe.step_frame(one, 4, 0.5)
    elif kind == "batched":
        pipe = BatchedScenePipeline(model, cls_id=0, batch=2)

        def step(reset):
            return pipe.step_frames(two, [4, 4], [reset, False], [0.5, 0.5])
    elif kind == "multiclass":
        small = ShastaModel(ShastaConfig(**dict(SMALL, max_obj=5)), device="cpu")
        pipe = MultiClassScenePipeline({"car": model, "pedestrian": small}, device="cpu")
        arrays = {k: frames[0][k] for k in keys[:4]}
        boxes = {"car": (frames[0]["det_boxes"], 4),
                 "pedestrian": (frames[1]["det_boxes"][:, :5], 4)}

        def step(reset):
            if reset:
                pipe.reset()
            return pipe.dispatch_frame(arrays, boxes, 0.5)
    else:
        pipe = EvalLanes(model, 2)
        chunk = {k: v[None] for k, v in two.items()}

        def step(reset):
            return pipe.step_chunk(chunk, [[reset, False]], [[4, 4]])
    return pipe, step


# aten operations of one step (steady, lane 0 reset) on the tree before
# the lane step was written once: torch 2.13 on the CPU, _stepper's setting
PARENT_OPS = {"scene": (2399, 2411), "batched": (2451, 2451), "multiclass": (2523, 2553),
              "eval": (2043, 2043)}


@pytest.mark.parametrize("kind", sorted(PARENT_OPS))
def test_one_step_dispatches_no_more_operations_than_before(kind):
    """The host sets the pace of the serving streams: a step may not gain
    aten operations unnoticed. Each stepper's step, after a warm-up step,
    counted with no lane starting a scene and with lane 0 starting one."""
    _, step = _stepper(kind)
    step(True)
    counts = []
    for reset in (False, True):
        with Ops() as ops:
            step(reset)
        counts.append(len(ops.ops))
    assert all(c <= p for c, p in zip(counts, PARENT_OPS[kind])), (counts, PARENT_OPS[kind])
