"""walk_ms.call: host time inside ops/engine.walk_segment (the benchmark's
span around every call), ms a call of the window."""


def read(ctx):
    n = ctx.window.get("calls")
    if not n or "walk" not in ctx.spans:
        return None
    return 1e3 * ctx.spans["walk"] / n
