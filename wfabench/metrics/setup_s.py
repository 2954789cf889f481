"""setup_s: seconds from the start of the process to the window's start:
imports, the kernels' build (the first run in a checkout), the traffic
made from the seed, the aligner and the warm-up."""


def read(ctx):
    return ctx.setup_s
