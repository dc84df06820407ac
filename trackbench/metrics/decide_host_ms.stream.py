"""Host milliseconds a frame inside span `step.decide_track` (decision
rules, dead flags and the scan tracker's step), over the traced frames.
Source: program_span. Moves frame_p90_ms."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "program_span", "frame_p90_ms"


def read(ctx):
    s = span_s(ctx, "step.decide_track", "host_s")
    return None if s is None else s / ctx["frames"] * 1e3
