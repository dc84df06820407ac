"""Host milliseconds from the call of the serving step's `step_frame` to
its return (the frame queued, outputs not yet read), by the benchmark's
clock, the mean over the traced frames. Source: host_clock. Moves
frame_p90_ms."""
SOURCE, MOVES = "host_clock", "frame_p90_ms"


def read(ctx):
    q = ctx.get("queue_s")
    return None if not q else sum(q) / len(q) * 1e3
