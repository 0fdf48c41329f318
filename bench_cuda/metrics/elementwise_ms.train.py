"""Device milliseconds a step of PyTorch's elementwise kernels over the
whole step: the frozen backbone's BatchNorm affines and activations, the
box head's scan under autograd, the losses and AdamW; a class of kernel
rather than a layer."""

INCLUDE = ("elementwise",)


def read(ctx):
    s = ctx.trace.seconds(INCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
