"""finish_ms.stream: the host finish (PYWFA_PROF's f.pull, f.native_fill,
f.assemble, f.escalate and f.oracle, pywfa_tpu_torch.batch), ms a batch of
the window."""

KEYS = ("f.pull", "f.native_fill", "f.assemble", "f.escalate", "f.oracle")


def read(ctx):
    n = ctx.window.get("batches")
    if not n or not any(k in ctx.prof for k in KEYS):
        return None
    return 1e3 * sum(ctx.prof.get(k, 0.0) for k in KEYS) / n
