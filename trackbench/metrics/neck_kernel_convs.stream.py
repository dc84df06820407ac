"""The neck's conv-kernel launches a frame: the program's counter
`neck.kernel_convs` (one a launch of the neck's own conv kernel, counted
only while a profiler records) over the traced frames. 15 where the whole
neck takes the kernel route; 0 where the program has the kernel but its
neck never took it; None where the program has no such kernel or no
counters. Fewer launches for the same neck is better. Source:
program_counter. Moves frame_p90_ms."""
import importlib.util

SOURCE, MOVES = "program_counter", "frame_p90_ms"
KERNEL = "shasta_tpu_torch.ops.kernels.dense_conv"


def read(ctx):
    from shasta_tpu_torch.utils import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None or importlib.util.find_spec(KERNEL) is None:
        return None
    return counters().get("neck.kernel_convs", 0) / ctx["frames"]
