"""Device milliseconds a batch of PyTorch's elementwise kernels: the
backbone's frozen BatchNorm affines and activations, the heads' glue, a
class of kernel rather than a layer."""

INCLUDE = ("elementwise",)


def read(ctx):
    s = ctx.trace.seconds(INCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
