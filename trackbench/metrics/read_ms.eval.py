"""Host milliseconds a frame spends reading and voxelizing in the eval
loop: `run_affinity_eval_batched(timings=)`'s "read" over the traced
pass's frames. Source: program_span. Moves frames_per_s."""
SOURCE, MOVES = "program_span", "frames_per_s"


def read(ctx):
    t = ctx.get("timings", {}).get("read")
    return None if t is None else t / ctx["frames"] * 1e3
