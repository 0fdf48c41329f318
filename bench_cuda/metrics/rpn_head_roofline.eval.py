"""K1's share of its roofline: its least time on the batch
(``roofline.rpn_head_bound_s``, with the encoder spikes that the judged
batches' images make, counted by the reference) over its device time a
batch."""

from bench_cuda import flops, roofline

INCLUDE = ("rpn_level_kernel",)
EXCLUDE = ("rpn_level_kernel<true",)


def read(ctx):
    s = ctx.trace.seconds(INCLUDE, EXCLUDE) / ctx.batches
    if s <= 0 or not ctx.enc_spikes_per_batch:
        return None
    cfg = ctx.cfg
    readout = 5 * len(cfg["anchor_sizes"][0]) * len(cfg["aspect_ratios"])
    least = roofline.rpn_head_bound_s(flops.level_shapes(cfg), ctx.batch, cfg["fpn_channels"],
                                      cfg["t_rpn"], readout, ctx.enc_spikes_per_batch)
    return 100.0 * least / s
