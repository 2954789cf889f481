"""api_ms.call: the pywfa API's own host time a call (align.WavefrontAligner
and engine_adapter): each call's wall minus its batch.align_pairs span,
averaged over the window's calls, in ms."""


def read(ctx):
    w = ctx.window
    if not w.get("latencies") or "align_pairs" not in ctx.spans:
        return None
    return 1e3 * (sum(w["latencies"]) - ctx.spans["align_pairs"]) / w["calls"]
