"""The scan tracker's greedy-kernel launches a frame: the program's counter
`tracker.greedy_launches` (one a launch of the greedy-assignment kernel,
counted only while a profiler records) over the traced frames. 1 where each
frame's tracker step assigns all its lanes in one launch; None where the
program has no such kernel or no counters (its assignment a host loop of
small launches a row). Fewer launches for the same assignment is better.
Source: program_counter. Moves frame_p90_ms."""
import importlib.util

SOURCE, MOVES = "program_counter", "frame_p90_ms"
KERNEL = "shasta_tpu_torch.ops.kernels.greedy"


def read(ctx):
    from shasta_tpu_torch.utils import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None or importlib.util.find_spec(KERNEL) is None:
        return None
    return counters().get("tracker.greedy_launches", 0) / ctx["frames"]
