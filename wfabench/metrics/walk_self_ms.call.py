"""walk_self_ms.call: the walk's host loop of launches, the self time of
the program's span "walk" (ops/engine.walk_segment less its syncs), ms a
call of the window."""
from wfabench.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "calls", "self", ("walk",))
