"""Where this process stands among the processes of one run, and the two
collectives the host side needs (an evaluator's detections gathered, a
logger's totals summed).

:func:`parallel_world` is the one place that says how many processes there
are. It reports a single process, (0, 1): the port runs on one card per
process and starts no process group yet, so nothing is gathered or summed
and no distributed package is imported. Once it reports more, the
collectives below go through ``torch.distributed``.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple


def parallel_world() -> Tuple[int, int]:
    """(rank, size) of this process among the run's processes."""
    return 0, 1


def all_gather_objects(obj: Any) -> List[Any]:
    """Every process's ``obj`` (picklable), in rank order."""
    _, size = parallel_world()
    if size == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * size
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(values: Sequence[float]) -> List[float]:
    """The sum over processes of a short list of floats."""
    _, size = parallel_world()
    if size == 1:
        return list(values)
    return [sum(v) for v in zip(*all_gather_objects([float(x) for x in values]))]
