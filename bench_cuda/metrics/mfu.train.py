"""The whole training step's share of the card's bf16 dense peak: the dense
FLOPs of the traced steps (``flops.train_step``: the frozen backbone's
forward 1x, the heads' layers on frozen inputs 2x, the others 3x) over the
traced seconds and 989 TFLOP/s."""

from bench_cuda import flops, roofline


def read(ctx):
    done = flops.train_step(ctx.cfg, ctx.batch)["total"] * ctx.batches
    return 100.0 * done / ctx.trace.window_s / roofline.PEAK_BF16_FLOPS
