"""Share of the sparse trunk's strided output slots that hold a row: the
rows each of conv2, conv3, conv4 and extra kept, summed over lanes and
traced steps, over the slots their caps offered. The index builds run over
every slot, so this is the share of their rows that are real. Source:
program_span (the program's counters). Moves frames_per_s."""
from trackbench.metrics._caps import cap_fill

SOURCE, MOVES = "program_span", "frames_per_s"


def read(ctx):
    return cap_fill(ctx)
