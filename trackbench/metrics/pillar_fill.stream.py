"""Share of the pillar reader's fixed slots that hold a pillar: the
program's counters `pillars.kept` (the frame's valid pillars) over
`pillars.slots` (the V slots the reader runs), summed over the traced
frames (counted only while a profiler records). The reader's stock ops
run over every slot, so this is the share of their rows that are real.
None where the program has no such counters. Source: program_counter.
Moves frame_p90_ms."""

SOURCE, MOVES = "program_counter", "frame_p90_ms"


def read(ctx):
    from shasta_tpu_torch.utils import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:
        return None
    c = counters()
    kept, slots = c.get("pillars.kept"), c.get("pillars.slots")
    if not slots:
        return None
    total = sum(slots) if isinstance(slots, list) else slots
    kept = sum(kept) if isinstance(kept, list) else (kept or 0)
    return 100.0 * kept / total if total else None
