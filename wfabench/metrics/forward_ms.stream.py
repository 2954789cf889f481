"""forward_ms.stream: the segmented executor's forward segments, the total
of the program's spans "forward" (each segment's fused-loop enqueue and
the wait for its end), ms a batch of the window."""
from wfabench.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "batches", "total", ("forward",))
