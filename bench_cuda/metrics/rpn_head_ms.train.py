"""Device milliseconds a step of K1's training instance (``snn/cuda_rpn.py``,
the forward that saves the currents)."""

INCLUDE = ("rpn_level_kernel<true",)


def read(ctx):
    s = ctx.trace.seconds(INCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
