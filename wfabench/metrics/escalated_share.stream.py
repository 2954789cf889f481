"""escalated_share.stream: 100 x the pairs the finish sent from their
first rung to a next one (the counts of the program's outermost
"escalate" spans: a pair that escalates again from the next rung counts
once) over the pairs whose results came back in the window, in %."""
from wfabench.program_spans import window_spans


def read(ctx):
    sp = window_spans(ctx)
    pairs = ctx.window.get("pairs") if sp else None
    if not pairs or "batches" not in ctx.window:
        return None
    return 100.0 * sp["outer"].get("escalate", 0) / pairs
