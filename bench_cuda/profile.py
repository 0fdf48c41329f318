"""The traced window: what the device did, from ``torch.profiler``.

:func:`trace` runs the window's calls under the profiler (CPU and CUDA
activities) and returns a :class:`Trace`:

  * ``by_name``: each device operation's total seconds and count, by its
    name (a kernel's demangled ``__global__`` name, a memcpy or memset);
  * ``busy_s``: the union of the device's operation intervals, and
    ``window_s`` the window's wall time (ended by a synchronise);
  * ``launches``: kernel launches by the host (``cudaLaunchKernel``,
    ``cudaLaunchKernelExC``, ``cuLaunchKernel``, ``cuLaunchKernelEx``);
  * ``top_ops``: the ten device operations that took most time;
  * ``idle_gaps``: the ten longest idle gaps of the device, each named by
    the host op running at its middle (innermost), or where none does, "no
    op (Python) after" the op that ended last before it.

Kernels are booked to layers by the metric readers under ``metrics/``,
each with its own name fragments. A ``record_function`` range on the
device's timeline (an optimizer step, a collective) is no work of its own
and is left out.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
NO_OP = "no op (Python)"


@dataclasses.dataclass
class Trace:
    by_name: Dict[str, Tuple[float, int]]
    busy_s: float
    window_s: float
    launches: int
    top_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def seconds(self, include, exclude=()) -> float:
        """Device seconds of the operations whose name holds any fragment of
        ``include`` and none of ``exclude``, letter case ignored."""
        inc = [k.lower() for k in include]
        exc = [k.lower() for k in exclude]
        return sum(s for name, (s, _) in self.by_name.items()
                   if any(k in name.lower() for k in inc)
                   and not any(k in name.lower() for k in exc))


def _merge(intervals):
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _ops(host):
    """Host ops that name what the host did: no CUDA API call, not the
    profiler's step range."""
    return [e for e in host if not e.name.startswith(("cu", "ProfilerStep"))]


def _host_op_at(ops, t: float) -> str:
    """The innermost host op running at ``t``; where none is, the Python
    between ops, named by the op that ended last before ``t``."""
    spans = [(e.time_range.end - e.time_range.start, e.name) for e in ops
             if e.time_range.start <= t <= e.time_range.end]
    if spans:
        return min(spans)[1]
    before = [e for e in ops if e.time_range.end < t]
    return f"{NO_OP} after {max(before, key=lambda e: e.time_range.end).name}" if before else NO_OP


def trace(warm: Callable[[], None], run: Callable[[], None], device,
          align: Callable[[], None] = lambda: None) -> Trace:
    """Runs ``warm()`` with the profiler warming up (its own start-up,
    CUPTI's module loading, falls there and is not recorded), then
    ``run()`` traced, between two synchronises; ``align()`` runs before the
    window starts (the ranks' barrier)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        torch.cuda.synchronize(device)
        prof.step()
        align()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        prof.step()
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = {e.name for e in host}
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and e.name not in ranges]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e6
        by_name[e.name][1] += 1
    busy = _merge([(e.time_range.start, e.time_range.end) for e in dev])
    gaps = sorted(((busy[i + 1][0] - busy[i][1], (busy[i][1] + busy[i + 1][0]) / 2)
                   for i in range(len(busy) - 1)), reverse=True)[:10]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    ops = _ops(host)
    return Trace(by_name={k: (v[0], v[1]) for k, v in by_name.items()},
                 busy_s=sum(e - s for s, e in busy) / 1e6, window_s=window_s,
                 launches=sum(e.name in LAUNCH_EVENTS for e in host),
                 top_ops=[(name[:160], v[0]) for name, v in top],
                 idle_gaps=[(_host_op_at(ops, mid), us / 1e6) for us, mid in gaps])
