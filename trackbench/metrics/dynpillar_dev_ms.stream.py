"""Device milliseconds a frame of the operations launched under span
`step.dyn_pillars` (DSVT-P's dynamic pillar reader and the scatter of its
pillars onto the canvas), over the traced frames; None for a program or a
trunk without the span. Source: device_trace. Moves frame_p90_ms."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "device_trace", "frame_p90_ms"


def read(ctx):
    s = span_s(ctx, "step.dyn_pillars", "device_s")
    return None if not s else s / ctx["frames"] * 1e3
