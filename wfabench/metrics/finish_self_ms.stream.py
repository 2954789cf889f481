"""finish_self_ms.stream: the batch finish's own host time, the self time
of the program's spans pull_wait, finish, pull, native_fill, assemble,
escalate and oracle, each rung counted once (an escalation's self time
leaves out the next rung's dispatch and finish), ms a batch of the
window."""
from wfabench.program_spans import FINISH, per_unit


def read(ctx):
    return per_unit(ctx, "batches", "self", FINISH)
