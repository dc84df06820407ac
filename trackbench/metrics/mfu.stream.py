"""The whole step's share of the card's f32 peak (495/3 TFLOP/s): the
model's FLOPs a frame by trackbench/count/ (trunk convs over their hits,
neck, shared conv, affinity head) times the traced frames, over the traced
wall time. Source: device_trace. Moves frame_p90_ms."""
from trackbench.metrics._roofline import mfu

SOURCE, MOVES = "device_trace", "frame_p90_ms"


def read(ctx):
    return mfu(ctx)
