"""Milliseconds of one all-reduce of the trained leaves' gradient buffer
over the port's process group, every rank starting it together after a
barrier (``train._Ranks.allreduce_alone_s``): the exchange alone, without
the wait for the slowest rank that ``nccl_ms.train`` holds."""


def read(ctx):
    return 1e3 * ctx.allreduce_alone_s if ctx.allreduce_alone_s else None
