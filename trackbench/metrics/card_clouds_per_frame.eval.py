"""Clouds voxelized on the card a frame: the program's counter
`voxelize.clouds` (each voxelizer call counts the clouds it took, only
while a profiler records) over the traced pass's frames. 1 where each
frame's own cloud is voxelized once; 0 where the program has the kernel but
its eval never took it; None where the program has no such kernel or no
counters. Source: program_counter. Moves frames_per_s."""
import importlib.util

SOURCE, MOVES = "program_counter", "frames_per_s"
KERNEL = "shasta_tpu_torch.ops.kernels.voxelize"


def read(ctx):
    from shasta_tpu_torch.utils import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None or importlib.util.find_spec(KERNEL) is None:
        return None
    return counters().get("voxelize.clouds", 0) / ctx["frames"]
