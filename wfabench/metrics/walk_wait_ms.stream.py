"""walk_wait_ms.stream: the host blocked on the device inside the walk,
the total of the program's spans "sync" (each bool(here.any()) of
ops/engine.walk_segment), ms a batch of the window."""
from wfabench.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "batches", "total", ("sync",))
