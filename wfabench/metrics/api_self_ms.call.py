"""api_self_ms.call: the pywfa API's own host time, the self time of the
program's span "call" (align.WavefrontAligner.__call__ less the dispatch
and finish under it), ms a call of the window."""
from wfabench.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "calls", "self", ("call",))
