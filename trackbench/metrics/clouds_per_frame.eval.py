"""Clouds voxelized a frame: the count of `data.voxelize` spans (one per
cloud the dataset reads) over the traced pass's frames. The lanes consume
one cloud a frame, the frame's own. Source: program_span. Moves
frames_per_s."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "program_span", "frames_per_s"


def read(ctx):
    n = span_s(ctx, "data.voxelize", "count")
    return None if n is None else n / ctx["frames"]
