"""Share of DSVT's attention slots that are not repeats: the program's
counters `dsvt.pillars` (the valid pillars a partition covers) over
`dsvt.slots` (its sets' slots, K a set), summed over the four partitions
a frame and the traced frames (counted only while a profiler records).
Each pillar fills one slot of a partition and the rest of its sets'
slots repeat a pillar, masked but still computed. None where the program
has no such counters. Source: program_counter. Moves frame_p90_ms."""

SOURCE, MOVES = "program_counter", "frame_p90_ms"


def read(ctx):
    from shasta_tpu_torch.utils import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:
        return None
    c = counters()
    pillars, slots = c.get("dsvt.pillars"), c.get("dsvt.slots")
    if not slots:
        return None
    total = sum(slots) if isinstance(slots, list) else slots
    pillars = sum(pillars) if isinstance(pillars, list) else (pillars or 0)
    return 100.0 * pillars / total if total else None
