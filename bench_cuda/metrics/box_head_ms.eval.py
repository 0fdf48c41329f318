"""Device milliseconds a batch of the box head kernels: K3 (encoder and fc6,
``snn/cuda_fc6.py``) and K4 (LIF tail and readouts, ``snn/cuda_tail.py``)."""

INCLUDE = ("encoder_code_kernel", "StoreF32", "lif6_kernel", "LifCodesT", "LiOutT")


def read(ctx):
    s = ctx.trace.seconds(INCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
