"""Host milliseconds a frame inside span `data.points` (each cloud's
sweeps read from disk and merged, `load_sweep_points`, in the dataset's
reading of a frame), over the traced pass's frames. Source: program_span.
Moves frames_per_s."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "program_span", "frames_per_s"


def read(ctx):
    s = span_s(ctx, "data.points", "host_s")
    return None if s is None else s / ctx["frames"] * 1e3
