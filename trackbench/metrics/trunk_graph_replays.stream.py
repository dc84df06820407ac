"""The sparse trunk's CUDA-graph replays a frame: the program's counter
`trunk.graph_replays` (one a replay of the trunk's captured graph, counted
only while a profiler records) over the traced frames. 1 where each frame's
trunk runs as one graph launch; None where the program has no such graph or
no counters (its trunk dispatched from the host one operation at a time).
More of the trunk replayed is better. Source: program_counter. Moves
frame_p90_ms."""
import importlib.util

SOURCE, MOVES = "program_counter", "frame_p90_ms"
GRAPH = "shasta_tpu_torch.models.trunk_graph"


def read(ctx):
    from shasta_tpu_torch.utils import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None or importlib.util.find_spec(GRAPH) is None:
        return None
    return counters().get("trunk.graph_replays", 0) / ctx["frames"]
