"""CUDA graphs of the evaluation's box postprocess (``utils/graphs.py``).

Five functions replay as CUDA graphs on the card under inference mode:
``rpn.filter_proposals``, ``nms.nms_mask``, the body of
``nms.nms_mask_pruned`` (``nms._pruned_keep``),
``roi_heads._postproc_groups`` and ``roi_heads._postproc_outputs``. On the
CPU, in training and under autograd the wrapper calls its function as it
is.

On the CPU: the wrapper is a plain call; the graph key tells shapes,
dtypes, ``training``, configurations and other arguments apart; each
wrapped function equals its original (``__wrapped__``) on seeded inputs at
the flagship's shapes (five levels of up to 1000 rows, 1000 proposals of 9
classes) and reads nothing back to the host.

On the card (marked ``cuda``; they skip without one): four seeded inputs in
turn replay bit-equal to the original, and the inputs give different
outputs, so that a stale static input fails; a returned tensor is not
overwritten by the next call; ``filter_proposals`` captures its own
``nms_mask`` call; replays of the five leave the launch counters as they
are, and a replay adds back what a captured kernel counted; a host read in
a wrapped function raises at capture; a landscape and a portrait batch of
the detector leave each function one graph per distinct key, at most one
per bucket, and replay to the eager originals' bits. The module imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py

Tolerance: none; every comparison is bit for bit (the same operations on
the same values).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from snn_automotive_object_detection_tpu_torch.models import roi_heads as roi_mod
from snn_automotive_object_detection_tpu_torch.models import rpn as rpn_mod
from snn_automotive_object_detection_tpu_torch.ops import nms as nms_ops
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.graphs import graph_key, graphed

ROOT = Path(__file__).resolve().parent.parent
# The flagship's pre-NMS rows per level at 768 x 1536 (P2-P5 capped at
# 1000, the pool level's 12 x 24 x 3 anchors), its proposals and classes.
LEVELS = [1000, 1000, 1000, 1000, 864]
P, C, N = 1000, 9, 2
HOST_READS = ("aten._local_scalar_dense", "aten.item", "aten.is_nonzero", "aten.equal",
              "aten.nonzero")


def _boxes(rng, shape, extent=(1536.0, 768.0)):
    xy = rng.uniform(-40.0, 1.0, shape + (2,)) + rng.uniform(0.0, 1.0, shape + (2,)) * extent
    wh = rng.uniform(2.0, 300.0, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _filter_inputs(rng, dev):
    s = sum(LEVELS)
    obj = np.concatenate([-np.sort(-rng.normal(0.0, 2.0, (N, k)), axis=1) for k in LEVELS], 1)
    return ((torch.from_numpy(_boxes(rng, (N, s))).to(dev),
             torch.from_numpy(obj.astype(np.float32)).to(dev), list(LEVELS),
             torch.tensor([[768, 1536]] * N, device=dev), rpn_mod.RPNConfig(), False), {})


def _nms_inputs(rng, dev):
    return ((torch.from_numpy(_boxes(rng, (N, P))).to(dev),
             torch.from_numpy(rng.uniform(0.0, 1.0, (N, P)).astype(np.float32)).to(dev),
             torch.from_numpy(rng.uniform(size=(N, P)) < 0.9).to(dev), 0.5), {})


def _pruned_inputs(rng, dev, k=roi_mod.PRUNED_NMS_K):
    rows = N * (C - 1)
    valid = np.zeros((rows, P), bool)
    for r in range(rows):
        valid[r, rng.choice(P, size=int(rng.integers(0, k + 1)), replace=False)] = True
    return ((torch.from_numpy(_boxes(rng, (rows, P))).to(dev),
             torch.from_numpy(rng.uniform(0.0, 1.0, (rows, P)).astype(np.float32)).to(dev),
             torch.from_numpy(valid).to(dev), 0.5, k), {})


def _groups_inputs(rng, dev):
    logits = rng.normal(0.0, 1.5, (N, P, C)).astype(np.float32)
    logits[:, :, 0] += 1.0
    return ((torch.from_numpy(logits).to(dev),
             torch.from_numpy(rng.normal(0.0, 0.5, (N, P, 4 * C)).astype(np.float32)).to(dev),
             torch.from_numpy(_boxes(rng, (N, P))).to(dev),
             torch.from_numpy(rng.uniform(size=(N, P)) < 0.95).to(dev),
             torch.tensor([[768, 1536]] * N, device=dev), roi_mod.RoIConfig()), {})


def _outputs_inputs(rng, dev):
    args, _ = _groups_inputs(rng, dev)
    with torch.inference_mode():
        (gb, gs, gv), inter = roi_mod._postproc_groups.__wrapped__(*args)
        keep, bg_order = roi_mod._batched_group_nms(gb, gs, gv, 0.5)
    return (inter, keep, bg_order, roi_mod.RoIConfig()), {}


# (name, the wrapped function, what the caller calls, inputs from (rng, device))
CASES = {
    "filter_proposals": (rpn_mod.filter_proposals, rpn_mod.filter_proposals, _filter_inputs),
    "nms_mask": (nms_ops.nms_mask, nms_ops.nms_mask, _nms_inputs),
    "nms_mask_pruned": (nms_ops._pruned_keep, nms_ops.nms_mask_pruned, _pruned_inputs),
    "postproc_groups": (roi_mod._postproc_groups, roi_mod._postproc_groups, _groups_inputs),
    "postproc_outputs": (roi_mod._postproc_outputs, roi_mod._postproc_outputs,
                         _outputs_inputs),
}


def _tensors(tree):
    _, tensors = graph_key(None, (tree,), {})
    return tensors


def _assert_same(got, want):
    """The same nesting and every tensor bit-equal, of the same dtype."""
    assert graph_key(None, (got,), {})[0] == graph_key(None, (want,), {})[0]
    for a, b in zip(_tensors(got), _tensors(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


# --------------------------------------------------------------------------
# On the CPU


@pytest.mark.parametrize("mode", ["inference", "no_grad", "autograd"])
def test_plain_call_off_the_card(mode):
    calls = []

    @graphed
    def double(x, scale: float):
        calls.append(x.shape)
        return {"y": x * scale, "x": x}

    x = torch.arange(6.0).reshape(2, 3).requires_grad_(mode == "autograd")
    ctx = {"inference": torch.inference_mode, "no_grad": torch.no_grad,
           "autograd": torch.enable_grad}[mode]
    for _ in range(3):
        with ctx():
            out = double(x, 2.0)
    assert len(calls) == 3 and not double.graphs
    assert out["x"] is x and torch.equal(out["y"], torch.arange(6.0).reshape(2, 3) * 2)
    assert double.__wrapped__.__name__ == "double"
    if mode == "autograd":
        out["y"].sum().backward()
        assert torch.equal(x.grad, torch.full((2, 3), 2.0))


def _key(*args, **kwargs):
    return graph_key(nms_ops.nms_mask, args, kwargs)[0]


def test_graph_key_tells_calls_apart():
    rpn, roi = rpn_mod.RPNConfig(), roi_mod.RoIConfig()
    x = torch.zeros((2, 10, 4))
    base = _key(x, [3, 7], rpn, False)
    # Other values of the same shapes share the key.
    assert base == _key(torch.ones((2, 10, 4)), [3, 7], rpn, False)
    assert base == _key(x, (3, 7), rpn, False)
    assert graph_key(nms_ops.nms_mask, (x,), {})[1][0] is x
    others = [_key(torch.zeros((2, 11, 4)), [3, 7], rpn, False),
              _key(torch.zeros((2, 10, 4), dtype=torch.float64), [3, 7], rpn, False),
              _key(x, [3, 7], rpn, True),
              _key(x, [3, 7], rpn_mod.RPNConfig(nms_thresh=0.6), False),
              _key(x, [3, 7], roi, False),
              _key(x, [4, 6], rpn, False),
              _key(x, [3, 7], rpn, training=False),
              _key(x, {"a": x}, rpn, False),
              graph_key(nms_ops.nms_mask_pruned, (x, [3, 7], rpn, False), {})[0]]
    assert len({base, *others}) == len(others) + 1
    with pytest.raises(TypeError):
        _key(x, {1, 2})


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapped_equals_original(name):
    wrapped, call, make = CASES[name]
    args, kwargs = make(np.random.default_rng(7), "cpu")
    captured = set(wrapped.graphs)
    with torch.inference_mode():
        with _Ops() as ops:
            want = wrapped.__wrapped__(*args, **kwargs)
        got = call(*args, **kwargs)
    _assert_same(got, want)
    assert set(wrapped.graphs) == captured
    assert not ops.seen & set(HOST_READS), f"{name} reads a device value back to the host"
    assert any(bool(t.any()) for t in _tensors(want) if t.dtype == torch.bool)


# --------------------------------------------------------------------------
# On the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_replays_bit_equal_on_card(dev, name):
    wrapped, call, make = CASES[name]
    rng = np.random.default_rng(11)
    inputs = [make(rng, dev) for _ in range(4)]
    with torch.inference_mode():
        want = [wrapped.__wrapped__(*a, **kw) for a, kw in inputs]
        got = [call(*a, **kw) for _ in range(2) for a, kw in inputs]
    torch.cuda.synchronize()
    assert graph_key(wrapped.__wrapped__, *inputs[0])[0] in wrapped.graphs
    # Every result, kept across the later calls, is its own input's.
    for i, g in enumerate(got):
        _assert_same(g, want[i % 4])
    # The four inputs give four different results: a replay on a stale
    # static input could not pass.
    firsts = [torch.cat([t.flatten().float() for t in _tensors(w)]) for w in want]
    assert all(not torch.equal(firsts[0], f) for f in firsts[1:])


@pytest.mark.cuda
def test_result_not_overwritten_on_card(dev):
    rng = np.random.default_rng(3)
    (a, _), (b, _) = _nms_inputs(rng, dev), _nms_inputs(rng, dev)
    with torch.inference_mode():
        nms_ops.nms_mask(*a)                       # captures
        first = nms_ops.nms_mask(*a)
        kept = [t.clone() for t in first]
        second = nms_ops.nms_mask(*b)
    assert not torch.equal(second[0], kept[0])
    assert all(torch.equal(t, k) for t, k in zip(first, kept))
    assert first[0].data_ptr() != second[0].data_ptr()


@pytest.mark.cuda
def test_nested_capture_on_card(dev):
    """filter_proposals captures its own nms_mask call: the inner call
    joins the outer graph and leaves no graph of its own."""
    rng = np.random.default_rng(5)
    levels = [300, 200, 120]
    s = sum(levels)
    obj = np.concatenate([-np.sort(-rng.normal(0.0, 2.0, (N, k)), axis=1) for k in levels], 1)

    def inputs():
        return (torch.from_numpy(_boxes(rng, (N, s))).to(dev),
                torch.from_numpy(obj.astype(np.float32)).to(dev), levels,
                torch.tensor([[768, 1536]] * N, device=dev), rpn_mod.RPNConfig(), False)

    before = set(nms_ops.nms_mask.graphs)
    runs = [inputs() for _ in range(3)]
    with torch.inference_mode():
        got = [rpn_mod.filter_proposals(*a) for a in runs]
    # Outside inference mode the original's nms_mask runs as it is too.
    with torch.no_grad():
        want = [rpn_mod.filter_proposals.__wrapped__(*a) for a in runs]
    assert set(nms_ops.nms_mask.graphs) == before
    key = graph_key(rpn_mod.filter_proposals.__wrapped__, runs[0], {})[0]
    assert key in rpn_mod.filter_proposals.graphs
    for a, g, w in zip(runs, got, want):
        _assert_same(g, w)
        # An output that is an argument comes back as the caller's tensor.
        assert g["pre_nms_proposals"] is a[0]


@pytest.mark.cuda
def test_launch_counts_on_card(dev):
    from snn_automotive_object_detection_tpu_torch.ops import cuda_roi_align as k2

    rng = np.random.default_rng(9)
    cases = {name: CASES[name][2](rng, dev) for name in CASES}
    with torch.inference_mode():
        for name, (args, kwargs) in cases.items():
            CASES[name][1](*args, **kwargs)        # captures, or replays
        counts = (dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS))
        for name, (args, kwargs) in cases.items():
            CASES[name][1](*args, **kwargs)
    assert (dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS)) == counts

    @graphed
    def pooled(features, boxes):
        cb.note_plain("roi_align", boxes)
        return k2.roi_align(features, boxes, (128, 192))

    g = torch.Generator(device=dev).manual_seed(5)
    feats = [torch.randn((2, a, b, 64), generator=g, device=dev).to(torch.bfloat16)
             for a, b in ((32, 48), (16, 24), (8, 12), (4, 6))]

    def boxes():
        ctr = torch.rand((2, 20, 2), generator=g, device=dev) * torch.tensor(
            [192.0, 128.0], device=dev)
        wh = torch.rand((2, 20, 2), generator=g, device=dev) * 100 + 1
        return torch.cat([ctr - wh / 2, ctr + wh / 2], -1).contiguous()

    seen = []
    with torch.inference_mode():
        for _ in range(3):
            b = boxes()
            launches, plain = cb.LAUNCHES[k2.NAME], cb.PLAIN_CUDA_CALLS[k2.NAME]
            out = pooled(feats, b)
            seen.append((cb.LAUNCHES[k2.NAME] - launches, cb.PLAIN_CUDA_CALLS[k2.NAME] - plain))
            assert torch.equal(out, k2.roi_align(feats, b, (128, 192)))
    assert len(pooled.graphs) == 1
    assert seen == [(1, 1)] * 3


HOST_READ_SCRIPT = """
import torch
from snn_automotive_object_detection_tpu_torch.utils.graphs import graphed

@graphed
def reads(x):
    return x * float(x.sum())

x = torch.ones(4, device="cuda")
with torch.inference_mode():
    try:
        reads(x)
    except RuntimeError as e:
        print("raised:", str(e).splitlines()[0])
    else:
        print("no error")
"""


@pytest.mark.cuda
def test_host_read_raises_at_capture(dev):
    """In a process of its own: a failed capture leaves the CUDA context
    unusable for what follows."""
    out = subprocess.run([sys.executable, "-c", HOST_READ_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "raised:" in out.stdout, out.stdout


@pytest.mark.cuda
def test_two_buckets_graph_count_on_card(dev, monkeypatch):
    """A landscape and a portrait batch of one configuration, twice each,
    through ``detector_apply``: every graphed function holds one graph per
    distinct key it was called with and at most one per bucket (no key
    varies from batch to batch), and every batch's outputs are the eager
    originals' bits."""
    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.utils import graphs as graphs_mod

    cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12, min_size=128, max_size=256)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    graphed_fns = {(rpn_mod, "filter_proposals"), (nms_ops, "nms_mask"),
                   (nms_ops, "_pruned_keep"), (roi_mod, "_postproc_groups"),
                   (roi_mod, "_postproc_outputs")}
    for mod, name in graphed_fns:
        getattr(mod, name).graphs.clear()
    keys = {name: set() for _, name in graphed_fns}
    real_key = graphs_mod.graph_key

    def recorded(fn, args, kwargs):
        key, tensors = real_key(fn, args, kwargs)
        keys[fn.__name__].add(key)
        return key, tensors

    monkeypatch.setattr(graphs_mod, "graph_key", recorded)
    g = torch.Generator(device=dev).manual_seed(1)
    batches = []
    for h, w in ((128, 256), (256, 128)) * 2:
        batches.append({"images": torch.rand((2, h, w, 3), generator=g, device=dev),
                        "image_sizes": torch.tensor([[h, w]] * 2, device=dev),
                        "original_sizes": torch.tensor([[2 * h, 2 * w]] * 2, device=dev)})
    outs = [detector_apply(params, b, cfg)[0] for b in batches]
    counts = {name: len(getattr(mod, name).graphs) for mod, name in graphed_fns}
    assert counts == {name: len(k) for name, k in keys.items()}
    assert all(1 <= c <= 2 for c in counts.values()), counts
    for mod, name in graphed_fns:
        monkeypatch.setattr(mod, name, getattr(mod, name).__wrapped__)
    for b, out in zip(batches, outs):
        eager = detector_apply(params, b, cfg)[0]
        assert sorted(eager) == sorted(out)
        for k, v in eager.items():
            assert torch.equal(v, out[k]), k
