"""Share of the traced frames's wall time in which no operation ran on the
device: 1 - busy / wall, busy the union of the trace's kernels and copies.
Source: device_trace. Moves frame_p90_ms."""
from trackbench.metrics._roofline import idle_share

SOURCE, MOVES = "device_trace", "frame_p90_ms"


def read(ctx):
    return idle_share(ctx)
