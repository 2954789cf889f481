"""walk_steps.stream: the walk's score steps (the counts the program's
"walk" spans carry: the steps of each ops/engine.walk_segment), a batch
of the window."""
from wfabench.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "batches", "count", ("walk",))
