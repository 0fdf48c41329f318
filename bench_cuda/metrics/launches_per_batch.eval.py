"""Kernel launches the host issued a batch (CUDA graph replays count as one
``cudaGraphLaunch`` each, which is not a kernel launch)."""


def read(ctx):
    return ctx.trace.launches / ctx.batches
