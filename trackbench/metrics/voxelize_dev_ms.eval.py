"""Device milliseconds a frame of the operations launched under span
`step.voxelize` (the lanes' clouds voxelized on the card, one call a
step), over the traced pass. None where the program opens no such span (it
voxelizes on the host). Source: device_trace. Moves frames_per_s."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "device_trace", "frames_per_s"


def read(ctx):
    s = span_s(ctx, "step.voxelize", "device_s")
    return None if not s else s / ctx["frames"] * 1e3
