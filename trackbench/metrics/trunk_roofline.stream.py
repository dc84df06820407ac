"""The sparse trunk's share of its roofline: the least time of the trunk's
convs by trackbench/count/ (each conv's products at the f32 peak or its
bytes at HBM's rate), over the device time of every operation launched
under span `step.sparse_trunk`, whatever kernels run there. Source:
device_trace. Moves frame_p90_ms."""
from trackbench.metrics._roofline import trunk_share

SOURCE, MOVES = "device_trace", "frame_p90_ms"


def read(ctx):
    return trunk_share(ctx)
