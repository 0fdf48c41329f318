"""The booking of device time and device idle to the port's spans
(``spans.py``) on synthetic traces, and ``profile.trace``'s fields and the
readers with spans in the trace and without."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from bench_cuda import harness, profile, spans

MAIN, AUTOGRAD = 1, 2
NAMES = ("detector", "detector.rpn_select", "detector.postprocess", "train.step",
         "train.backward")


def _ev(name, start, end, kind=DeviceType.CPU, id=0, thread=MAIN, annotation=False):
    return SimpleNamespace(name=name, device_type=kind, id=id, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def _span(name, start, end, thread=MAIN):
    return _ev(name, start, end, thread=thread, annotation=True)


def _launch(start, id, name="cudaLaunchKernel", thread=MAIN):
    return _ev(name, start, start + 2, id=id, thread=thread)


def _kernel(name, start, end, id):
    return _ev(name, start, end, kind=DeviceType.CUDA, id=id)


def _eval_trace():
    """One evaluation call, 0-1000 us: the selection (100-400) and the
    postprocess (500-900) inside ``detector``; two launches in the
    selection, a graph replay of two kernels in the postprocess, the
    harness's check after the call. The device is idle 300-600 (over the
    selection's end, ``detector``'s own time and the postprocess's start),
    700-750 and 800-1020."""
    return [
        _span("detector", 0, 1000), _span("detector.rpn_select", 100, 400),
        _span("detector.postprocess", 500, 900),
        _ev("aten::topk", 110, 150), _launch(120, 1), _launch(200, 2),
        _launch(510, 3, "cudaGraphLaunch"), _launch(1010, 4),
        _kernel("sort_kernel", 130, 250, 1), _kernel("topk_kernel", 250, 300, 2),
        _kernel("nms_kernel", 600, 700, 3), _kernel("gather_kernel", 750, 800, 3),
        _kernel("isfinite_kernel", 1020, 1030, 4),
        # The device's record of a range: no work of its own.
        _ev("detector.postprocess", 600, 800, kind=DeviceType.CUDA, annotation=True),
    ]


def _book(events, window_us):
    return spans.book(events, NAMES, window_us / 1e6)


def test_launch_booked_to_the_innermost_span():
    b = _book(_eval_trace(), 1100)
    assert b.spans["detector.rpn_select"].device_s == pytest.approx(170e-6)
    assert b.spans["detector"].device_s == 0.0
    assert b.spans[spans.OUTSIDE].device_s == pytest.approx(10e-6)
    assert b.unmatched_s == 0.0


def test_replay_booked_to_the_span_around_its_graph_launch():
    b = _book(_eval_trace(), 1100)
    assert b.spans["detector.postprocess"].device_s == pytest.approx(150e-6)


def test_backward_thread_booked_to_train_backward():
    events = [_span("train.step", 0, 1000), _span("train.backward", 200, 800),
              _launch(100, 1), _launch(300, 2, thread=AUTOGRAD), _launch(900, 3),
              _kernel("fwd", 110, 200, 1), _kernel("bwd", 310, 700, 2),
              _kernel("adamw", 910, 950, 3)]
    b = _book(events, 1000)
    assert b.spans["train.backward"].device_s == pytest.approx(390e-6)
    assert b.spans["train.step"].device_s == pytest.approx(130e-6)
    assert b.spans["train.backward"].count == 1
    assert b.spans["train.step"].self_s == pytest.approx(400e-6)


def test_idle_split_between_spans():
    b = _book(_eval_trace(), 1100)
    # 300-600: 300-400 in the selection, 400-500 in detector itself, 500-600
    # and 700-750 in the postprocess; 800-1020 is 800-900 in the
    # postprocess, 900-1000 in detector and 1000-1020 outside.
    assert b.spans["detector.rpn_select"].idle_s == pytest.approx(100e-6)
    assert b.spans["detector.postprocess"].idle_s == pytest.approx(250e-6)
    assert b.spans["detector"].idle_s == pytest.approx(200e-6)
    assert b.spans["detector"].host_s == pytest.approx(1000e-6)
    assert b.spans["detector"].self_s == pytest.approx(300e-6)


def test_spans_and_outside_add_up():
    events = _eval_trace()
    b = _book(events, 1100)
    by_name = sum((e.time_range.end - e.time_range.start) / 1e6 for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    assert sum(r.device_s for r in b.spans.values()) == pytest.approx(by_name, abs=1e-12)
    assert b.device_s == pytest.approx(by_name)
    assert b.busy_s == pytest.approx(330e-6)
    assert sum(r.idle_s for r in b.spans.values()) == pytest.approx(1100e-6 - b.busy_s)
    assert b.idle_gaps[0] == ("detector / no op (Python) after aten::topk",
                              pytest.approx(300e-6))


def test_unmatched_device_time_goes_outside():
    events = _eval_trace() + [_kernel("nccl_kernel", 950, 960, 99)]
    b = _book(events, 1100)
    assert b.unmatched_s == pytest.approx(10e-6)
    assert b.spans[spans.OUTSIDE].device_s == pytest.approx(20e-6)


class _Recorded:
    """``torch.profiler.profile`` replaying a fixed list of events."""

    def __init__(self, events):
        self._events = events

    def __call__(self, *args, **kw):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step(self):
        pass

    def events(self):
        return self._events


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def run(events):
        monkeypatch.setattr(torch.profiler, "profile", _Recorded(events))
        return profile.trace(lambda: None, lambda: None, "cpu")

    return run


def test_profile_trace_unchanged_by_spans(traced):
    """``profile.trace`` with the port's spans in the events (host ranges
    and their device records) and without them: every field but the idle
    gaps' names is the same, and so is every reader of the traced window
    but the derived shares that read the wall clock. A gap in Python inside
    a span is named by the span, where it was named by the op before it."""
    events = _eval_trace()
    with_spans = traced(events)
    without = traced([e for e in events if e.name not in NAMES])
    for field in ("by_name", "busy_s", "launches", "top_ops"):
        assert getattr(with_spans, field) == getattr(without, field)
    assert [s for _, s in with_spans.idle_gaps] == [s for _, s in without.idle_gaps]
    assert without.idle_gaps[0][0] == "no op (Python) after aten::topk"
    assert with_spans.idle_gaps[0][0] == "detector"
    man = harness.manifest()
    for cell in ("r50_eval_b8", "r50_train_frozen_b16_dp4"):
        for m in harness.per_layer(man, cell):
            if "idle_share" in m["name"] or m["name"].startswith("mfu"):
                continue
            read = harness.reader(m["name"]).read
            got = [read(harness.Context(trace=t, cfg={}, batch=8, batches=2,
                                        allreduce_alone_s=1e-3))
                   for t in (with_spans, without)]
            assert got[0] == got[1]
