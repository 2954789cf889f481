"""alignments_per_s: pairs whose results came back inside the window, over
the window's length (from the result that opened it to the one that
closed it); batches in flight at its close are not counted."""


def read(ctx):
    w = ctx.window
    if "batches" not in w:
        return None
    return w["pairs"] / (w["t_end"] - w["t_start"])
