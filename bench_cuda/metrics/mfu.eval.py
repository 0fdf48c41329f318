"""The whole evaluation batch's share of the card's bf16 dense peak: the
dense FLOPs of the traced batches (``flops.eval_batch``) over the traced
window's seconds and 989 TFLOP/s (H100 SXM, at 700 W)."""

from bench_cuda import flops, roofline


def read(ctx):
    done = flops.eval_batch(ctx.cfg, ctx.batch)["total"] * ctx.batches
    return 100.0 * done / ctx.trace.window_s / roofline.PEAK_BF16_FLOPS
