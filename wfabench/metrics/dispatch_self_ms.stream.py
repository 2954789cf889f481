"""dispatch_self_ms.stream: the batch dispatch's own host time, the self
time of the program's spans dispatch, config, encode, push and stage_out
of every rung, and of the segmented executor outside its forward
segments, replays and walks (segmented, snapshot, restore, gather), ms a
batch of the window."""
from wfabench.program_spans import DISPATCH, per_unit


def read(ctx):
    return per_unit(ctx, "batches", "self", DISPATCH)
