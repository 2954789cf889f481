"""encode_ms.stream: batch dispatch's host set-up and encode
(PYWFA_PROF's d.config + d.encode, pywfa_tpu_torch.batch), ms a batch of
the window."""


def read(ctx):
    n = ctx.window.get("batches")
    keys = ("d.config", "d.encode")
    if not n or not any(k in ctx.prof for k in keys):
        return None
    return 1e3 * sum(ctx.prof.get(k, 0.0) for k in keys) / n
