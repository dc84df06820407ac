"""The sparse trunk's CUDA graph (models/trunk_graph.py) on the CPU: which
calls take it (`SparseBackbone.graphed`), and the bookkeeping of
`TrunkGraphs` around a capture, with the graph stood in for by a replay of
the eager route into the captured buffers. On the CPU, with host plans and
in a trunk that trains nothing is captured and nothing counts as a replay.
tests/test_torch_gpu.py holds the replays on the card against the eager
route, bit for bit."""
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.models import ShastaConfig, SparseBackbone, trunk_graph
from shasta_tpu_torch.models.shasta import frame_sparse
from shasta_tpu_torch.ops.kernels.gather_conv import gather_conv
from shasta_tpu_torch.ops.kernels.lookup import sorted_lookup
from shasta_tpu_torch.plans import attach_plans, frame_plans
from shasta_tpu_torch.utils import profiler

CFG = ShastaConfig(max_obj=6, grid_shape=(41, 48, 48), cap_conv2=512, cap_conv3=256,
                   cap_conv4=128, cap_extra=128)
VOXELS = 1500
KEYS = ("voxels", "num_points", "coordinates", "voxels_valid")


@pytest.fixture(autouse=True)
def fresh_counters():
    profiler.reset_counters()
    yield
    profiler.reset_counters()


def _frame(seed, voxels=VOXELS, plans=False):
    f = make_batch(CFG, num_voxels_cap=voxels, n_dets=4, seed=seed)
    if plans:
        f = attach_plans(f, frame_plans(f["coordinates"][0], f["voxels_valid"][0], CFG))
    return frame_sparse(CFG, {k: torch.as_tensor(v) for k, v in f.items()
                              if k in KEYS or k.startswith("plan_")})


def _trunk():
    torch.manual_seed(0)
    return SparseBackbone(5, caps=(CFG.cap_conv2, CFG.cap_conv3, CFG.cap_conv4,
                                   CFG.cap_extra)).eval()


def _counted(run):
    """run() under a profiler: (its result, the counters)."""
    profiler.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run()
    return out, profiler.counters()


class CpuGraph:
    """Stands in for a captured graph: a replay runs the route again on the
    static inputs and writes its map and counts into the captured tensors."""

    def __init__(self, route, inputs, out, tally):
        self.route, self.inputs, self.out, self.tally = route, inputs, out, tally

    def replay(self):
        tally = []
        self.out.copy_(self.route(self.inputs, tally))
        for (_, demand, kept, _), (_, d, k, _) in zip(self.tally, tally):
            demand.copy_(d)
            kept.copy_(k)


LAUNCHES = (12, 21)


def _cpu_capture(route, st):
    inputs = st._replace(feats=st.feats.clone(), coords=st.coords.clone(),
                         valid=st.valid.clone())
    tally = []
    out = route(inputs, tally)
    return trunk_graph._Captured(CpuGraph(route, inputs, out, tally), inputs, out, tally,
                                 LAUNCHES)


@pytest.fixture
def graphed_on_cpu(monkeypatch):
    """The graph route taken on the CPU, with CpuGraph for the capture."""
    monkeypatch.setattr(SparseBackbone, "graphed",
                        lambda self, st, plans: plans is None and not self.training)
    monkeypatch.setattr(trunk_graph, "_capture", _cpu_capture)


def test_graphed_only_on_the_card_without_plans_in_eval_with_no_gradient():
    bb = _trunk().requires_grad_(False)
    st, _ = _frame(0)
    card = st._replace(feats=types.SimpleNamespace(is_cuda=True, requires_grad=False))
    assert not bb.graphed(st, None)  # the CPU
    assert bb.graphed(card, None)
    assert not bb.graphed(card, {"s0_rb": None})  # host plans
    bb.train()
    assert not bb.graphed(card, None)  # BN on batch statistics
    bb.eval().requires_grad_(True)
    assert not bb.graphed(card, None)  # a trunk that trains
    with torch.no_grad():
        assert bb.graphed(card, None)
    bb.requires_grad_(False)
    grad_in = card._replace(feats=types.SimpleNamespace(is_cuda=True, requires_grad=True))
    assert not bb.graphed(grad_in, None)  # a gradient to the input
    with torch.no_grad():
        assert bb.graphed(grad_in, None)


@pytest.mark.parametrize("route", ["cpu", "plans", "trains"])
def test_the_cpu_the_planned_route_and_a_trunk_that_trains_replay_nothing(route):
    bb = _trunk()
    st, plans = _frame(1, plans=route == "plans")
    if route == "trains":
        bb.requires_grad_(True)
        out, counts = _counted(lambda: bb(st))
        out.sum().backward()
        assert bb.conv1[0].conv1.weight.grad is not None
    else:
        with torch.no_grad():
            out, counts = _counted(lambda: bb(st, plans))
    assert out.abs().max() > 0
    assert "trunk.graph_replays" not in counts and not bb._graphs._graphs
    if route != "plans":  # the host planner counts the planned route's caps
        assert counts["trunk.cap.conv2.slots"] == CFG.cap_conv2  # the eager route counted


def test_a_replay_refills_its_inputs_and_keeps_every_count(graphed_on_cpu):
    """Two frames in turn through one captured key: each map is the eager
    route's, and the cap counters and launch counts of the replays equal
    the eager frames' (each replay counts clones: the second does not
    overwrite what the first counted)."""
    bb = _trunk()
    frames = [_frame(2)[0], _frame(3)[0]]
    with torch.no_grad():
        with trunk_graph.eager():
            want, want_counts = _counted(lambda: [bb(st).clone() for st in frames])
        assert not bb._graphs._graphs
        bb(frames[0])  # the capture, outside the counted run
        launches = sorted_lookup.launches, gather_conv.launches
        got, counts = _counted(lambda: [bb(st).clone() for st in frames])
    assert len(bb._graphs._graphs) == 1
    assert not torch.equal(want[0], want[1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert counts.pop("trunk.graph_replays") == 2
    assert counts == want_counts
    assert (sorted_lookup.launches - launches[0], gather_conv.launches - launches[1]) == (
        2 * LAUNCHES[0], 2 * LAUNCHES[1])


def test_a_key_beyond_the_cache_runs_eagerly(graphed_on_cpu):
    bb = _trunk()
    sizes = [VOXELS + 8 * i for i in range(trunk_graph.MAX_KEYS + 1)]
    frames = [_frame(4, voxels=v)[0] for v in sizes]
    with torch.no_grad():
        with trunk_graph.eager():
            want = [bb(st).clone() for st in frames]
        for st, w in zip(frames[:-1], want):
            assert torch.equal(bb(st), w)
        assert len(bb._graphs._graphs) == trunk_graph.MAX_KEYS
        got, counts = _counted(lambda: bb(frames[-1]))
        assert torch.equal(got, want[-1])
        assert "trunk.graph_replays" not in counts  # ran eagerly
        assert counts["trunk.cap.extra.slots"] == CFG.cap_extra
        _, counts = _counted(lambda: bb(frames[0]))
        assert counts["trunk.graph_replays"] == 1  # a kept key still replays
    assert len(bb._graphs._graphs) == trunk_graph.MAX_KEYS
    bb.float()  # parameters moved: the graphs read their old memory
    assert not bb._graphs._graphs
