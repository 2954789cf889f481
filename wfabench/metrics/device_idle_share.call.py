"""device_idle_share.call: 100 x (1 - the union of the device's kernel,
copy and set intervals / the wall of the profiled slice of calls)."""


def read(ctx):
    sl = ctx.slice
    if not sl or not sl.get("device_events") or "calls" not in ctx.window:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])
