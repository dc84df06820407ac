"""Share of the traced pass's wall time in which no operation ran on the
device: 1 - busy / wall, busy the union of the trace's kernels and copies.
Source: device_trace. Moves frames_per_s."""
from trackbench.metrics._roofline import idle_share

SOURCE, MOVES = "device_trace", "frames_per_s"


def read(ctx):
    return idle_share(ctx)
