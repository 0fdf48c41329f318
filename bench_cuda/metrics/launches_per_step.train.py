"""Kernel launches the host issued a training step."""


def read(ctx):
    return ctx.trace.launches / ctx.batches
