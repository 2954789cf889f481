"""device_idle_share.stream: 100 x (1 - the union of the device's kernel,
copy and set intervals / the wall of the profiled slice of batches)."""


def read(ctx):
    sl = ctx.slice
    if not sl or not sl.get("device_events") or "batches" not in ctx.window:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])
