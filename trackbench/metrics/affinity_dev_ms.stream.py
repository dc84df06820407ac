"""Device milliseconds a frame of the operations launched under span
`step.affinity` (the affinity head; class-stacked at several classes),
over the traced frames. Source: device_trace. Moves frame_p90_ms."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "device_trace", "frame_p90_ms"


def read(ctx):
    s = span_s(ctx, "step.affinity", "device_s")
    return None if not s else s / ctx["frames"] * 1e3
