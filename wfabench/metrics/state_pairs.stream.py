"""state_pairs.stream: the pairs' states that crossed the link between the
card and the host, a batch of the window: the counts the program's
"compact" spans carry (the pairs whose ring rows a segmented run's
boundary snapshot copied to the host) plus those of its "expand" spans
(the pairs whose rows a replay's restore put back)."""
from wfabench.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "batches", "count", ("compact", "expand"))
