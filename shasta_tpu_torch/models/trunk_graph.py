"""The sparse trunk's device-built route as one CUDA graph an input key.

Without host plans, `SparseBackbone` builds every index on the card at
shapes that only the voxel capacity, the batch and the four stage caps
fix, and reads no value back to the host: 4 subm and 4 strided index
builds, 12 `sorted_lookup` and 21 `gather_conv` launches, BN, ReLU and the
scatter to dense, some 1,450 operations dispatched one at a time.
`TrunkGraphs` captures that route once per input key and replays it:
a call copies the frame's feats, coords and valid rows into the graph's
static inputs (three copies) and launches the graph. The replay runs the
same kernels on the same shapes in the same order as the eager route, so
its output is the eager route's bit for bit.

The first call at a key runs the route eagerly once on a side stream
(the kernels' libraries load and set their shared-memory attributes there,
and `device.const` makes its constants, none of which a capture may do),
captures it, then replays it. At most MAX_KEYS keys are kept: a call at
another key returns None and its caller runs the eager route.

What a replay keeps true, though it runs none of the route's Python:
- `sorted_lookup.launches` and `gather_conv.launches` gain the launches the
  capture recorded;
- while a profiler records, `trunk.graph_replays` counts 1 and each strided
  stage counts `trunk.cap.<stage>.*` (`plans.count_cap`) from clones of the
  per-lane demand and kept that the graph computes on every replay (the
  next replay overwrites them).

The dense map a replay returns is the graph's static output: the next
replay at its key overwrites it, so the caller reads it before it calls
the trunk again (the neck does, in the same call).

`eager()` makes every trunk run its eager route for the probes that watch
the route's Python calls (`probe_b1_routes.recorded`), which a replay does
not make.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch

from ..ops import sparse as sp
from ..ops.kernels.gather_conv import gather_conv
from ..ops.kernels.lookup import sorted_lookup
from ..plans import count_cap
from ..utils import profiler

MAX_KEYS = 4
# the hand-written kernels the route launches, each with its launch counter
KERNELS = (sorted_lookup, gather_conv)
_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Inside, every trunk runs its eager route: nothing is captured or
    replayed."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: sp.SparseTensor  # the static feats, coords and valid
    out: torch.Tensor  # the static dense map
    tally: list  # (stage, demand, kept, max_out) of each strided stage
    launches: tuple  # per kernel of KERNELS, the launches a replay makes


# route(st, tally) -> the dense map, counting each strided stage into the list tally
Route = Callable[[sp.SparseTensor, list], torch.Tensor]


def _capture(route: Route, st: sp.SparseTensor) -> _Captured:
    dev = st.feats.device
    inputs = st._replace(feats=st.feats.clone(), coords=st.coords.clone(),
                         valid=st.valid.clone())
    before = [k.launches for k in KERNELS]
    try:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            route(inputs, [])  # the warm-up: its counts go nowhere
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = [k.launches for k in KERNELS]
        graph, tally = torch.cuda.CUDAGraph(), []
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = route(inputs, tally)
        launches = tuple(k.launches - w for k, w in zip(KERNELS, warm))
    finally:  # neither run launched for the caller
        for k, n in zip(KERNELS, before):
            k.launches = n
    return _Captured(graph, inputs, out, tally, launches)


class TrunkGraphs:
    """A trunk's captured graphs, by input key."""

    def __init__(self):
        self._graphs: dict = {}

    def clear(self) -> None:
        self._graphs.clear()

    def __call__(self, route: Route, st: sp.SparseTensor, key) -> torch.Tensor | None:
        """The dense map of `st` by the graph captured at `key` (captured
        now if new and there is room), or None: the caller runs the route
        eagerly."""
        if _eager_depth:
            return None
        g = self._graphs.get(key)
        if g is None:
            if len(self._graphs) >= MAX_KEYS:
                return None
            g = self._graphs[key] = _capture(route, st)
        for static, t in zip(g.inputs[:3], st[:3]):
            static.copy_(t)
        g.graph.replay()
        for k, n in zip(KERNELS, g.launches):
            k.launches += n
        if profiler.recording():
            profiler.count("trunk.graph_replays", 1)
            for stage, demand, kept, max_out in g.tally:
                count_cap(stage, demand.clone(), kept.clone(), max_out)
        return g.out
