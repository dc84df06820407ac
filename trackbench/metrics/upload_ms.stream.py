"""Host milliseconds a frame inside span `step.upload`: the frame's arrays
and the step's scalars copied to the card through pinned memory, over the
traced frames. Source: program_span. Moves frame_p90_ms."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "program_span", "frame_p90_ms"


def read(ctx):
    s = span_s(ctx, "step.upload", "host_s")
    return None if s is None else s / ctx["frames"] * 1e3
