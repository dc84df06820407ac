"""The whole step's share of the card's f32 peak (495/3 TFLOP/s): the
model's FLOPs a frame by trackbench/count/ (trunk convs over their hits,
neck, shared conv, affinity head) times the traced frames, over the traced
wall time. Source: device_trace. Moves frames_per_s."""
from trackbench.metrics._roofline import mfu

SOURCE, MOVES = "device_trace", "frames_per_s"


def read(ctx):
    return mfu(ctx)
