"""Device milliseconds a step of NCCL's kernels on rank 0: the all-reduces
of the gradients and the losses (``parallel/collectives.py``), the wait for
the slowest rank included."""

INCLUDE = ("nccl",)


def read(ctx):
    s = ctx.trace.seconds(INCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
