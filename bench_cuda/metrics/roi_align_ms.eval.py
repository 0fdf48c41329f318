"""Device milliseconds a batch of the RoIAlign kernel (K2,
``ops/cuda_roi_align.py``)."""

INCLUDE = ("roi_align_kernel",)


def read(ctx):
    s = ctx.trace.seconds(INCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
