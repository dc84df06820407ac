"""Shares of the card's peaks over the traced frames."""
from trackbench.metrics._span import span_s

from trackbench.count import work


def trunk_share(ctx):
    dev = span_s(ctx, "step.sparse_trunk", "device_s")
    if not dev:
        return None
    least = sum(work.conv_least_s(c) for frame in ctx["convs"] for c in frame)
    return 100.0 * least / dev


def mfu(ctx):
    return 100.0 * sum(ctx["flops"]) / ctx["wall_s"] / work.F32_FLOPS_PER_S


def idle_share(ctx):
    busy = ctx["trace"]["busy_s"]
    return None if not busy else 100.0 * (1.0 - busy / ctx["wall_s"])
