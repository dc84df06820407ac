"""Host milliseconds a frame spends being staged and queued in the eval
loop: `run_affinity_eval_batched(timings=)`'s "step" over the traced
pass's frames. Source: program_span. Moves frames_per_s."""
SOURCE, MOVES = "program_span", "frames_per_s"


def read(ctx):
    t = ctx.get("timings", {}).get("step")
    return None if t is None else t / ctx["frames"] * 1e3
