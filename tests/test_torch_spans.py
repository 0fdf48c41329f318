"""The port's spans (``utils/spans.py``) at its layer boundaries.

Under a CPU-only ``torch.profiler``, one ``detector_apply`` call records
each evaluation span once, nested directly under its root span
``detector``; one frozen training step records the training spans under
``train.step``, the detector's under ``detector`` under ``train.forward``.
With no profiler running a span makes no ``record_function`` call. The
spans change nothing else: outputs, losses, updated leaves, the kernels'
wrappers called and ``cuda_build``'s launch counters are the same with the
profiler on and off. On the card, a first call under the profiler, which
captures the box postprocess's CUDA graphs with the spans on, matches the
replays that follow it. A tiny bucket (64 x 128, T = 2) keeps the module to
a few seconds; it imports no JAX, so it runs on the card as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from snn_automotive_object_detection_tpu_torch.models import detector, roi_heads
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig, init_params
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.train import optim
from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils import spans
from snn_automotive_object_detection_tpu_torch.utils.weights import tree_leaves
from tests.test_torch_eval_routes import _count_wrappers
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

N, G = 2, 3
EVAL = {"detector.backbone", "detector.rpn_head", "detector.rpn_select", "detector.roi_align",
        "detector.box_head", "detector.postprocess", "detector.outputs"}
TRAIN_DETECTOR = {"detector.backbone", "detector.rpn_head", "detector.rpn_select",
                  "detector.rpn_loss", "detector.roi_sample", "detector.roi_align",
                  "detector.box_head", "detector.roi_loss"}
TRAIN_STEP = {"train.forward", "train.backward", "train.grad_allreduce", "train.optimizer",
              "train.losses"}
CONFIGS = {
    "resnet": {},
    "mobilenet": {"backbone": "mobilenet_v3_large_fpn"},
    "ann_box_head": {"detector_snn": False},
}


def _config(bucket=(64, 128), **kw):
    return DetectorConfig(num_classes=3, t_rpn=2, t_det=2, min_size=bucket[0],
                          max_size=bucket[1],
                          rpn=RPNConfig(pre_nms_top_n_test=40, post_nms_top_n_test=16,
                                        pre_nms_top_n_train=40, post_nms_top_n_train=16,
                                        batch_size_per_image=32),
                          roi=RoIConfig(batch_size_per_image=16), **kw)


def _params(cfg, device="cpu"):
    return init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)


def _batch(bucket=(64, 128), device="cpu"):
    h, w = bucket
    g = torch.Generator().manual_seed(1)
    ctr = torch.rand((N, G, 2), generator=g) * torch.tensor([w / 2, h / 2]) + torch.tensor(
        [w / 4, h / 4])
    half = 4 + 8 * torch.rand((N, G, 2), generator=g)
    batch = {"images": torch.rand((N, h, w, 3), generator=g),
             "image_sizes": torch.tensor([[h, w]] * N),
             "original_sizes": torch.tensor([[2 * h, 2 * w]] * N),
             "targets": {"boxes": torch.cat([ctr - half, ctr + half], -1),
                         "labels": torch.randint(1, 3, (N, G), generator=g),
                         "valid": torch.tensor([[True, True, False], [True, False, False]])}}
    return {k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(device)) for k, v in batch.items()}


def _eval_batch(**kw):
    return {k: v for k, v in _batch(**kw).items() if k != "targets"}


def _recorded(prof):
    """The spans of the trace: name -> list of their parents' names (None
    for a root)."""
    out = {}
    for e in prof.events():
        if e.name in spans.NAMES:
            out.setdefault(e.name, []).append(e.cpu_parent.name if e.cpu_parent else None)
    return out


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _train_step(cfg, params, optimizer=None):
    trainable, frozen = optim.split_trainable(params)
    if optimizer is None:
        optimizer, _ = optim.build_optimizer(trainable, "AdamW", 1e-3)
    else:
        optimizer = optimizer(tree_leaves(trainable))
    step = make_train_step(cfg, optimizer)
    return lambda batch: step(trainable, frozen, batch, torch.Generator().manual_seed(2)), trainable


class _PlainSGD:
    """Plain SGD over ``leaves``: ``torch.optim`` opens a ``record_function``
    of its own in every step, profiler or not."""

    def __init__(self, leaves):
        self.leaves = leaves

    def zero_grad(self, set_to_none=True):
        for p in self.leaves:
            p.grad = None

    def step(self):
        with torch.no_grad():
            for p in self.leaves:
                if p.grad is not None:
                    p -= 1e-3 * p.grad


def _launches():
    return dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS)


def _delta(before, after):
    return tuple({k: a[k] - b[k] for k in a} for b, a in zip(before, after))


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_eval_records_the_evaluation_spans(monkeypatch, kind):
    """One evaluation call: each evaluation span once, directly under the
    root ``detector``; the postprocess of either box head inside
    ``detector.postprocess``."""
    cfg = _config(**CONFIGS[kind])
    params = _params(cfg)
    post = "postprocess_detections_ann" if kind == "ann_box_head" else "_batched_group_nms"

    def probed(*args, _f=getattr(roi_heads, post), **kw):
        with record_function("probe"):
            return _f(*args, **kw)

    monkeypatch.setattr(roi_heads, post, probed)
    with _cpu_profile() as prof:
        detector.detector_apply(params, _eval_batch(), cfg)
    got = _recorded(prof)
    assert got == {"detector": [None], **{name: ["detector"] for name in EVAL}}
    probes = [e for e in prof.events() if e.name == "probe"]
    assert [e.cpu_parent.name for e in probes] == ["detector.postprocess"]


def test_train_step_records_the_training_spans():
    """One frozen training step: the step's spans under ``train.step``, the
    detector's root under ``train.forward`` and the detector's training
    spans under it."""
    cfg = _config()
    step, _ = _train_step(cfg, _params(cfg))
    with _cpu_profile() as prof:
        losses = step(_batch())
    assert torch.isfinite(losses["loss_total"])
    got = _recorded(prof)
    assert got == {"train.step": [None], "detector": ["train.forward"],
                   **{name: ["train.step"] for name in TRAIN_STEP},
                   **{name: ["detector"] for name in TRAIN_DETECTOR}}


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler running, an evaluation call and a training step
    (with an optimizer that opens no range of its own) never enter a
    ``record_function``; under a profiler the same patch is reached."""
    def refused(*args, **kw):
        raise RuntimeError("record_function entered")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refused)
    cfg = _config()
    params = _params(cfg)
    detector.detector_apply(params, _eval_batch(), cfg)
    step, _ = _train_step(cfg, params, _PlainSGD)
    assert torch.isfinite(step(_batch())["loss_total"])
    with _cpu_profile(), pytest.raises(RuntimeError, match="record_function entered"):
        with spans.span("detector"):
            pass


def test_eval_unchanged_under_the_profiler(monkeypatch):
    """Outputs, the kernels' wrappers called and the launch counters of one
    evaluation call, profiler off and on."""
    cfg = _config()
    params = _params(cfg)
    calls = _count_wrappers(monkeypatch)
    runs = []
    for traced in (False, True):
        before = _launches()
        for k in calls:
            calls[k] = 0
        if traced:
            with _cpu_profile():
                out = detector.detector_apply(params, _eval_batch(), cfg)
        else:
            out = detector.detector_apply(params, _eval_batch(), cfg)
        runs.append((out, dict(calls), _delta(before, _launches())))
    assert runs[0][1]["rpn_level"] > 0 and runs[0][1]["encoder_fc6"] > 0
    _assert_same(runs[1], runs[0])


def test_train_step_unchanged_under_the_profiler():
    """Losses, gradients, updated leaves and launch counters of one training
    step from the same state, profiler off and on."""
    cfg = _config()
    runs = []
    for traced in (False, True):
        step, trainable = _train_step(cfg, _params(cfg))
        before = _launches()
        if traced:
            with _cpu_profile():
                losses = step(_batch())
        else:
            losses = step(_batch())
        leaves = tree_leaves(trainable)
        runs.append((losses, [p.detach().clone() for p in leaves],
                     [p.grad.clone() for p in leaves if p.grad is not None],
                     _delta(before, _launches())))
    assert runs[0][2]
    _assert_same(runs[1], runs[0])


@pytest.mark.cuda
def test_card_capture_under_the_profiler_matches_the_replays():
    """On the card, bf16: the first call of a new bucket, which captures the
    box postprocess's graphs, made under the profiler with the spans on,
    then a replay with it off and one with it on. Outputs and launch counts
    agree, and the trace holds the spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    bucket = (64, 160)      # a bucket no other test captures
    cfg = _config(bucket)
    params = _params(cfg, dev)
    batch = _eval_batch(bucket=bucket, device=dev)
    runs = []
    for traced in (True, False, True):
        before = _launches()
        if traced:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = detector.detector_apply(params, batch, cfg)
                torch.cuda.synchronize(dev)
            assert set(_recorded(prof)) == EVAL | {"detector"}
        else:
            out = detector.detector_apply(params, batch, cfg)
        torch.cuda.synchronize(dev)
        runs.append((out, _delta(before, _launches())))
    assert sum(runs[0][1][0].values()) > 0
    _assert_same(runs[1], runs[0])
    _assert_same(runs[2], runs[0])
