"""device_idle_walk_share.stream: 100 x the device's idle time whose
innermost open range is wfa:walk (ops/engine.walk_segment outside its
syncs: the walk's launch loop), over the wall of the profiled slice of
batches; read from the slice's idle time by innermost range."""


def read(ctx):
    sl = ctx.slice
    if not sl or not sl.get("device_events") or "batches" not in ctx.window:
        return None
    gaps = dict(sl.get("idle_gaps", ()))
    if "walk" not in gaps:
        return None
    return 100.0 * gaps["walk"] / sl["wall_s"]
