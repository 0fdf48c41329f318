"""The collectives of data-parallel training and sharded evaluation.

Port of ``snn_automotive_object_detection_tpu/parallel/collectives.py``
(the reference's pickled ``all_gather``, its utils.py:78-91) and of what
the JAX package's SPMD step does implicitly: each loss is a sum over the
global batch divided by a count over the global batch, so a rank divides
its own sums by counts summed over the ranks, and the gradients of those
losses are summed over the ranks before the update.

Sampler draws follow one rule: every rank draws from the same seeded
generator at the global batch's shape and keeps its own rows, so that W
ranks of b images sample exactly what one process of W b images samples.

Without a process group nothing here communicates and every function
returns its input's values as they are.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from snn_automotive_object_detection_tpu_torch.parallel.mesh import group_active


def parallel_world() -> Tuple[int, int]:
    """(rank, size) of this process in the process group; (0, 1) without
    one."""
    if not group_active():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def all_gather_objects(obj: Any) -> List[Any]:
    """Every process's ``obj`` (picklable), in rank order."""
    _, size = parallel_world()
    if size == 1:
        return [obj]
    out = [None] * size
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(values: Sequence[float]) -> List[float]:
    """The sum over processes of a short list of floats."""
    _, size = parallel_world()
    if size == 1:
        return list(values)
    return [sum(v) for v in zip(*all_gather_objects([float(x) for x in values]))]


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place, while a group is up (a loss's
    count over the global batch); ``t`` untouched without one."""
    if group_active():
        dist.all_reduce(t)
    return t


def sum_losses_over_ranks(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The losses (each a rank's share of a global-batch loss) summed over
    the ranks in one collective: the global losses, on every rank."""
    if not group_active():
        return losses
    flat = torch.stack(list(losses.values()))
    dist.all_reduce(flat)
    return dict(zip(losses, flat.unbind()))


def sum_grads_over_ranks(leaves: Sequence[torch.Tensor]) -> None:
    """Each leaf's ``.grad`` replaced by its sum over the ranks: one
    collective per dtype over a flat buffer. A leaf that the loss does not
    reach has no gradient (the box head's fc6 at T = 2, on every rank
    alike): it adds zeros to the buffer, so that every rank's buffer has
    one layout, and keeps no gradient, as in one process, so that the
    optimizer skips it. Nothing happens without a group."""
    if not group_active():
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for leaf in leaves:
        by_dtype.setdefault(leaf.dtype, []).append(leaf)
    for group in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in group])
        dist.all_reduce(flat)
        for p, g in zip(group, flat.split([p.numel() for p in group])):
            if p.grad is not None:
                p.grad = g.view_as(p)


def rank_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """This rank's ``rows`` rows of ``x``, whose first axis is the global
    batch (size x ``rows``)."""
    rank, size = parallel_world()
    if x.shape[0] != size * rows:
        raise ValueError(f"draws for a global batch of {size} x {rows} rows, got "
                         f"{x.shape[0]}")
    return x if size == 1 else x[rank * rows:(rank + 1) * rows]


def rank_rand(shape: Sequence[int], generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """Uniform draws of ``shape`` ([rows, ...]) for this rank: its rows of
    draws made from ``generator`` at the global batch's shape."""
    rows, rest = shape[0], tuple(shape[1:])
    _, size = parallel_world()
    full = torch.rand((size * rows, *rest), generator=generator, device=device)
    return rank_rows(full, rows)
