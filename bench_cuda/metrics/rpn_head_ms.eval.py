"""Device milliseconds a batch of the RPN head kernel (K1,
``snn/cuda_rpn.py``; its evaluation instances, not the training one)."""

INCLUDE = ("rpn_level_kernel",)
EXCLUDE = ("rpn_level_kernel<true",)


def read(ctx):
    s = ctx.trace.seconds(INCLUDE, EXCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
