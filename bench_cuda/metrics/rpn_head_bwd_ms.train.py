"""Device milliseconds a step of K7, the RPN head's backward for its weights
(``snn/cuda_rpn.py``: the sweep, the weight gradient and dwout)."""

INCLUDE = ("sweep_kernel", "wgrad_kernel", "dwout_")


def read(ctx):
    s = ctx.trace.seconds(INCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
