"""Device milliseconds a batch of the fused FPN kernel (K5,
``ops/cuda_fpn.py``)."""

INCLUDE = ("fpn_level_kernel",)


def read(ctx):
    s = ctx.trace.seconds(INCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
