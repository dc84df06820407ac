"""Share of the dynamic reader's voxel slots that hold a voxel: the
program's counters `dynvox.voxels` (a lane's valid voxels) over
`dynvox.slots` (its max_voxels), summed over lanes and the traced frames
(counted only while a profiler records). The sparse trunk's first index
build runs over every slot, so this is the share of its rows that are
real. None where the program has no such counters. Source:
program_counter. Moves frame_p90_ms."""

SOURCE, MOVES = "program_counter", "frame_p90_ms"


def read(ctx):
    from shasta_tpu_torch.utils import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:
        return None
    c = counters()
    kept, slots = c.get("dynvox.voxels"), c.get("dynvox.slots")
    if not slots:
        return None
    total = sum(slots) if isinstance(slots, list) else slots
    kept = sum(kept) if isinstance(kept, list) else (kept or 0)
    return 100.0 * kept / total if total else None
