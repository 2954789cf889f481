"""walk_self_ms.stream: the walk's host loop of launches, the self time of
the program's span "walk" (ops/engine.walk_segment less its syncs), ms a
batch of the window."""
from wfabench.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "batches", "self", ("walk",))
