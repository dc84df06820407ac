"""Host milliseconds a frame inside span `step.frame`: the whole call of the
serving step (`step_frame`, or the multi-class `dispatch_frame`), the
program's own counterpart of `queue_ms.stream`, over the traced frames.
Source: program_span. Moves frame_p90_ms."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "program_span", "frame_p90_ms"


def read(ctx):
    s = span_s(ctx, "step.frame", "host_s")
    return None if s is None else s / ctx["frames"] * 1e3
