"""walk_ms.stream: host time inside ops/engine.walk_segment (the
benchmark's span around every call), ms a batch of the window."""


def read(ctx):
    n = ctx.window.get("batches")
    if not n or "walk" not in ctx.spans:
        return None
    return 1e3 * ctx.spans["walk"] / n
