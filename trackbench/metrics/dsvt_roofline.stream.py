"""DSVT's share of its roofline: the least time of the DSVT stage by
trackbench/count/dsvt.py (each position MLP's and encoder layer's
products at the f32 peak or its bytes, its gathers included, at HBM's
rate, the larger; over the frame's real sets and pillars), summed over
the traced frames, over the device time of every operation launched
under span `step.dsvt`. None without the span or without the driver's
`dsvt_least_s`. Source: device_trace. Moves frame_p90_ms."""
from trackbench.metrics._span import span_s

SOURCE, MOVES = "device_trace", "frame_p90_ms"


def read(ctx):
    dev = span_s(ctx, "step.dsvt", "device_s")
    least = ctx.get("dsvt_least_s")
    if not dev or not least:
        return None
    return 100.0 * sum(least) / dev
