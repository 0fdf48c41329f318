"""CUDA graphs for pure tensor functions of static shapes.

Evaluation runs about 600 small operations a batch in its box
postprocess (proposal filtering, the detection NMS and the outputs around
it), each a launch from the host of a few microseconds of device work: the
host, not the card, sets the pace there. :func:`graphed` wraps such a
function so that, on CUDA tensors under ``torch.inference_mode()``, each of
its calls is one replay of a CUDA graph.

The device and the mode pick the route, as they do for the kernels; there
is no flag:

  * On CUDA tensors under inference mode, the first call with a new key
    (:func:`graph_key`: the function, each tensor argument's shape, dtype
    and device, every other argument by value) runs the function once
    eagerly on a side stream and returns that run's results, then captures
    it into a CUDA graph of its own memory pool. Every later call with that
    key copies its tensor arguments into the graph's static inputs and
    replays it. A capture that fails raises; nothing falls back to eager.
  * A call made while a wrapped function is being warmed up or captured
    (or while the stream is capturing) runs its function directly: a
    wrapped function may call another, whose work then joins the outer
    graph.
  * Everywhere else (the CPU, training, autograd) the function runs as it
    is.

A wrapper keeps each key's graph, with its static inputs and outputs, for
the life of the process: a few MB for the flagship's five functions.

Results leave as fresh tensors: each call returns clones of the graph's
static outputs, so that no later call overwrites what a caller holds,
except that an output that is one of the arguments returns the caller's
own tensor. The launch counters of ``utils/cuda_build`` see a replay as
the launches its capture recorded: a capture counts nothing, a replay adds
what the captured run's wrappers counted.

A wrapped function must be a pure function of its arguments: no host read
of a device value (it raises at capture), no randomness, no state kept
between calls, and everything it caches on first use (such as
``utils/constants.device_constant``) filled by the warm-up run. Its
arguments are tensors, numbers, strings, None, hashable configuration
objects, and lists, tuples and dicts of these; its results tensors in
lists, tuples and dicts. The original function stays reachable as
``__wrapped__``.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

# Depth of wrapped functions being warmed up or captured on this thread.
_inside = threading.local()


def _flatten(tree, tensors: List[torch.Tensor]):
    """The key of ``tree``, with its tensors appended to ``tensors`` in
    order: a tensor is its shape, dtype and device; lists and tuples
    become tuples, dicts tuples of items; anything else is itself (and
    must be hashable)."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (list, tuple)):
        return tuple(_flatten(x, tensors) for x in tree)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _flatten(v, tensors)) for k, v in tree.items())
    hash(tree)
    return tree


def _rebuild(tree, tensors):
    """``tree`` with each of its tensors replaced by the next of the
    iterator ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, tensors) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, tensors) for k, v in tree.items()}
    return tree


def graph_key(fn: Callable, args: tuple, kwargs: dict) -> Tuple[Any, List[torch.Tensor]]:
    """(the key of the call ``fn(*args, **kwargs)``, its tensor arguments in
    order). Calls of one key differ only in the values of those tensors."""
    tensors: List[torch.Tensor] = []
    return (fn, _flatten(args, tensors), _flatten(kwargs, tensors)), tensors


@dataclasses.dataclass
class _Captured:
    """One captured call: the graph, its static inputs, its static outputs
    (the result's tree), for each output tensor the index of the argument
    it is (or None), and the launch counts its capture recorded."""

    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    outputs: Any
    output_tensors: List[torch.Tensor]
    aliases: List[Optional[int]]
    launches: Dict[str, int]
    plain_calls: Dict[str, int]


def _depth() -> int:
    return getattr(_inside, "depth", 0)


def _take_back(counter: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    """Resets ``counter`` to ``before`` and returns what was added since."""
    added = {k: v - before.get(k, 0) for k, v in counter.items() if v != before.get(k, 0)}
    for k in added:
        counter[k] = before.get(k, 0)
    return added


def _capture(fn, args, kwargs, tensors: List[torch.Tensor]):
    """Warms ``fn`` up on a side stream and captures it. Returns (the
    warm-up's result, the :class:`_Captured` call)."""
    device = tensors[0].device
    with torch.cuda.device(device):
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        _inside.depth = _depth() + 1
        try:
            with torch.cuda.stream(side):
                result = fn(*args, **kwargs)
            current.wait_stream(side)
            out_tensors: List[torch.Tensor] = []
            _flatten(result, out_tensors)
            for t in out_tensors:
                t.record_stream(current)

            inputs = [t.clone() for t in tensors]
            s_args, s_kwargs = _rebuild((args, kwargs), iter(inputs))
            launches, plain = dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                    outputs = fn(*s_args, **s_kwargs)
            finally:
                launches = _take_back(cb.LAUNCHES, launches)
                plain = _take_back(cb.PLAIN_CUDA_CALLS, plain)
        finally:
            _inside.depth -= 1
    static: List[torch.Tensor] = []
    _flatten(outputs, static)
    by_id = {id(t): i for i, t in enumerate(inputs)}
    aliases = [by_id.get(id(t)) for t in static]
    return result, _Captured(graph, inputs, outputs, static, aliases, launches, plain)


def _replay(c: _Captured, tensors: List[torch.Tensor]):
    for s, t in zip(c.inputs, tensors):
        s.copy_(t)
    c.graph.replay()
    for counter, added in ((cb.LAUNCHES, c.launches), (cb.PLAIN_CUDA_CALLS, c.plain_calls)):
        for k, v in added.items():
            counter[k] += v
    fresh = [tensors[a] if a is not None else t.clone()
             for t, a in zip(c.output_tensors, c.aliases)]
    return _rebuild(c.outputs, iter(fresh))


def graphed(fn: Callable) -> Callable:
    """``fn`` replayed as a CUDA graph per key on CUDA tensors under
    inference mode, and called as it is elsewhere (see the module's
    docstring). The wrapper's ``graphs`` holds its captured calls by key."""
    graphs: Dict[Any, _Captured] = {}

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not torch.is_inference_mode_enabled() or _depth():
            return fn(*args, **kwargs)
        key, tensors = graph_key(fn, args, kwargs)
        if not tensors or not all(t.is_cuda for t in tensors) \
                or torch.cuda.is_current_stream_capturing():
            return fn(*args, **kwargs)
        captured = graphs.get(key)
        if captured is None:
            result, graphs[key] = _capture(fn, args, kwargs, tensors)
            return result
        return _replay(captured, tensors)

    wrapper.graphs = graphs
    return wrapper
