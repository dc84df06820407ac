"""Host milliseconds a frame inside span `data.voxelize` (each cloud's
voxelization, `voxelize_frame`, in the dataset's reading of a frame), over
the traced pass's frames. Source: program_span. Moves frames_per_s."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "program_span", "frames_per_s"


def read(ctx):
    s = span_s(ctx, "data.voxelize", "host_s")
    return None if s is None else s / ctx["frames"] * 1e3
