"""fused_loop_roofline.stream: the fused loop's share of its roofline in
the profiled slice: the least time the card could take for the work of the
pairs dispatched in the slice (wfabench/roofline.py, from penalties,
lengths and confirmed optimal scores alone), over the device time of the
kernels named fused_loop in the slice, in %. The harness works it out
once, with the bound (operations or bytes) it prints beside the card's
power limit."""


def read(ctx):
    if ctx.roofline is None:
        return None
    return ctx.roofline["percent"]
