"""Device milliseconds a frame of the operations launched under span
`step.neck` (the RPN and the shared conv), over the traced pass. Source:
device_trace. Moves frames_per_s."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "device_trace", "frames_per_s"


def read(ctx):
    s = span_s(ctx, "step.neck", "device_s")
    return None if not s else s / ctx["frames"] * 1e3
