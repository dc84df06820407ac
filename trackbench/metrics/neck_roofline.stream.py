"""The neck's share of its roofline on the pillar trunk: the least time
of the neck's convs by trackbench/count/pillars.py (each conv's products
at the f32 peak or its bytes at HBM's rate, the larger), summed over the
traced frames, over the device time of every operation launched under
span `step.neck`, whatever kernels run there. None without the span or
without the driver's `neck_convs`. Source: device_trace. Moves
frame_p90_ms."""
from trackbench.count import pillars as cp
from trackbench.metrics._span import span_s

SOURCE, MOVES = "device_trace", "frame_p90_ms"


def read(ctx):
    dev = span_s(ctx, "step.neck", "device_s")
    convs = ctx.get("neck_convs")
    if not dev or not convs:
        return None
    return 100.0 * sum(cp.conv_least_s(c) for frame in convs for c in frame) / dev
