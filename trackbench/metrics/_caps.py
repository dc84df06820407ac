"""The trunk's stage caps over the traced frames, from the program's own
counters (`shasta_tpu_torch.utils.profiler.counters`), which count only
while a profiler records: the warm-up before the trace is not in them."""


def cap_fill(ctx):
    """Rows kept over slots offered, %, summed over the four strided stages
    (`trunk.cap.<stage>.kept` per lane, `.slots` the cap) and the traced
    steps; None where the program has no such counters."""
    from shasta_tpu_torch.utils import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:
        return None
    kept = slots = 0
    for name, v in counters().items():
        if name.startswith("trunk.cap."):
            v = sum(v) if isinstance(v, list) else v
            if name.endswith(".kept"):
                kept += v
            elif name.endswith(".slots"):
                slots += v
    return 100.0 * kept / slots if slots else None
