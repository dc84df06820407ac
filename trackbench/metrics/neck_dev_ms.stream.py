"""Device milliseconds a frame of the operations launched under span
`step.neck` (the RPN and the shared conv), over the traced frames, as
`neck_dev_ms.eval` reads it for the eval. Source: device_trace. Moves
frame_p90_ms."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "device_trace", "frame_p90_ms"


def read(ctx):
    s = span_s(ctx, "step.neck", "device_s")
    return None if not s else s / ctx["frames"] * 1e3
