"""Device time and device idle of a traced window, booked to the port's spans.

The port marks its layer boundaries with spans (``utils/spans.py`` of the
port: ``record_function`` ranges, on while a profiler runs; its docstring
lists them). :func:`book` takes the events of a ``torch.profiler`` trace
and gives each span name a :class:`Booked` record:

  * ``count``: how many times the span ran;
  * ``host_s``: its host duration, summed; ``self_s`` that less the part
    its child spans cover;
  * ``device_s``: the device seconds of the operations launched inside it.
    Each kernel, memcpy or memset is matched to the CUDA API call
    (``cuda*``, ``cu*``) that launched it by correlation id (a graph
    replay's kernels to its ``cudaGraphLaunch``), and booked to the
    innermost span whose host
    interval holds that call, on any host thread: autograd's device thread
    launches the backward while the caller waits in ``train.backward``;
  * ``idle_s``: the device's idle time between its busy intervals (merged
    as ``profile.py`` merges them) that falls in the span's host
    intervals, booked to the innermost span.

``OUTSIDE`` holds the rest: device time launched outside every span (or
by no call the trace holds, also counted in ``Booking.unmatched_s``), and
the idle time of the window outside every span, the window's edges
included. So the spans' ``device_s`` and ``OUTSIDE``'s add up to every
device operation's time, as ``profile.Trace.by_name`` sums it, and their
``idle_s`` to ``window_s - busy_s``. The ten longest idle gaps are named
``<innermost span> / <host op>``, the op part chosen among the host ops
that are not spans, as ``profile.py`` names a gap.

``profile.trace`` keeps no events, so the benchmark's result line does not
carry this booking yet. ``python -m bench_cuda.spans --workload <cell>
--seed <n> [--seconds <s>]`` makes one traced run of a cell as ``python -m
bench_cuda --trace 1`` does (``harness.run``), keeps the profiler's events,
and prints the harness's line, then a line of the booking a batch or step
(milliseconds; counts a batch).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Iterable, List, Optional, Tuple  # noqa: E402

OUTSIDE = "(outside)"


@dataclasses.dataclass
class Booked:
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0


@dataclasses.dataclass
class Booking:
    spans: Dict[str, Booked]
    device_s: float             # every device operation's time
    busy_s: float               # the union of the operations' intervals
    unmatched_s: float          # device time with no launching call in the trace
    idle_gaps: List[Tuple[str, float]]


def _innermost(spans, t: float) -> Optional[str]:
    """The name of the shortest span whose interval holds ``t``."""
    best = None
    for s, e, name, _ in spans:
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else None


def book(events: Iterable, names: Iterable[str], window_s: float) -> Booking:
    """The booking of a trace's ``events`` (``torch.profiler``'s
    ``FunctionEvent``s, times in microseconds) to the spans ``names``;
    ``window_s`` is the traced window's wall time."""
    from torch.autograd import DeviceType

    from bench_cuda import profile

    names = set(names)
    events = list(events)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = {e.name for e in host}
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and e.name not in ranges]
    spans = sorted(((e.time_range.start, e.time_range.end, e.name, e.thread)
                    for e in host if e.name in names), key=lambda s: (s[0], -s[1]))
    out = {name: Booked() for name in dict.fromkeys(s[2] for s in spans)}
    out[OUTSIDE] = Booked()

    # Host time, and each span's time less its children's, on its thread.
    stacks: Dict[int, List[tuple]] = {}
    for sp in spans:
        s, e, name, thread = sp
        rec = out[name]
        rec.count += 1
        rec.host_s += (e - s) / 1e6
        rec.self_s += (e - s) / 1e6
        stack = stacks.setdefault(thread, [])
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            out[stack[-1][2]].self_s -= (e - s) / 1e6
        stack.append(sp)

    # Device time, by the span that holds the launching call.
    calls = {e.id: e.time_range.start for e in host if e.name.startswith("cu")}
    unmatched = 0.0
    for d in dev:
        dur = (d.time_range.end - d.time_range.start) / 1e6
        t = calls.get(d.id)
        if t is None:
            unmatched += dur
        out[(_innermost(spans, t) if t is not None else None) or OUTSIDE].device_s += dur

    # Idle time between busy intervals, split at the spans' edges.
    busy = profile._merge([(d.time_range.start, d.time_range.end) for d in dev])
    edges = sorted({x for s, e, _, _ in spans for x in (s, e)})
    for (_, a), (b, _) in zip(busy, busy[1:]):
        cuts = [a] + [x for x in edges if a < x < b] + [b]
        for lo, hi in zip(cuts, cuts[1:]):
            name = _innermost(spans, (lo + hi) / 2)
            if name is not None:
                out[name].idle_s += (hi - lo) / 1e6
    busy_s = sum(e - s for s, e in busy) / 1e6
    device_s = sum((d.time_range.end - d.time_range.start) for d in dev) / 1e6
    out[OUTSIDE].device_s = device_s - sum(r.device_s for k, r in out.items() if k != OUTSIDE)
    out[OUTSIDE].idle_s = (window_s - busy_s) - sum(r.idle_s for k, r in out.items()
                                                    if k != OUTSIDE)

    ops = profile._ops([e for e in host if e.name not in names])
    gaps = sorted(((b - a, (a + b) / 2) for (_, a), (b, _) in zip(busy, busy[1:])),
                  reverse=True)[:10]
    named = [(f"{_innermost(spans, mid) or OUTSIDE} / {profile._host_op_at(ops, mid)}", us / 1e6)
             for us, mid in gaps]
    return Booking(spans=out, device_s=device_s, busy_s=busy_s, unmatched_s=unmatched,
                   idle_gaps=named)


def per_batch(b: Booking, batches: int, window_s: float) -> Dict:
    """The booking as a line: milliseconds (counts) a batch or step."""
    ms = 1e3 / batches
    return {"batches": batches, "window_ms": window_s * ms, "busy_ms": b.busy_s * ms,
            "device_ms": b.device_s * ms, "unmatched_ms": b.unmatched_s * ms,
            "spans": {name: {"count": r.count / batches, "host_ms": r.host_s * ms,
                             "self_ms": r.self_s * ms, "device_ms": r.device_s * ms,
                             "idle_ms": r.idle_s * ms} for name, r in b.spans.items()},
            "idle_gaps": [[name, s * 1e3] for name, s in b.idle_gaps]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bench_cuda.spans", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="weights and inputs")
    ap.add_argument("--seconds", type=float, default=10.0, help="as the harness takes it")
    args = ap.parse_args(argv)

    import torch
    import torch.profiler

    from bench_cuda import harness
    from snn_automotive_object_detection_tpu_torch.utils.spans import NAMES

    kept = []
    base = torch.profiler.profile

    class Keeping(base):
        """The profiler that ``profile.trace`` takes, kept when it ends."""

        def __exit__(self, *exc):
            try:
                return super().__exit__(*exc)
            finally:
                kept.append(self)

    # ``profile.trace`` imports the profiler's class when it runs.
    torch.profiler.profile = Keeping
    try:
        line = harness.run(args.workload, args.seed, args.seconds, True, T_START)
    except harness.RunError as e:
        print(f"bench_cuda.spans: {e}; no result", file=sys.stderr)
        return 3
    finally:
        torch.profiler.profile = base
    if not kept:
        print("bench_cuda.spans: the run traced nothing; no result", file=sys.stderr)
        return 3
    window_s = line["device"]["window_s"]
    b = book(kept[-1].events(), NAMES, window_s)
    print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **per_batch(b, line["attempted"], window_s)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
