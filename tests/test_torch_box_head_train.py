"""The box head's training route: the encoder and fc6 as one autograd node
(``snn/cuda_fc6.EncoderFc6Train``: K3's training instance forward, the
spike-code weight-gradient kernel backward; here their plain versions),
then the tail as a scan under autograd.

  * The training code pass (``encoder_codes_train_plain``) gives exactly the
    spikes of ``snnf.lif_current_encoder`` carried in float32, for every
    finite non-negative bf16 value; K3's evaluation code pass (the threshold
    count) differs from it at exactly x = 2.5, where the membrane reaches
    0.25 exactly after one step and spikes every second step, not every
    step. The evaluation reference counts thresholds too.
  * The forward is float32 sums of the carried spikes times bf16(w6),
    rounded once to bf16, bit for bit; without the value 2.5 in x that is
    ``encoder_fc6_plain``'s currents rounded. It saves the code planes
    alone.
  * The plain weight gradient against autograd through the scan's fc6 on
    the same cotangent: the scan rounds each step's product to bf16 before
    summing the steps in f32, the new sum rounds once, so every element lies
    within 2^-8 (bf16's unit roundoff, half an ulp of a value's binade) of
    the sum over steps of |that step's product|, plus 1e-6 of the largest
    element for the f32 sums.
  * The whole head on the new route against ``fastrcnn_snn_scan_apply``
    under autograd and against the JAX package's bf16 scan through
    ``jax.value_and_grad``, by tests/test_torch_train_heads.py's measures:
    logits and deltas to 1e-5 (the same spikes; the JAX side's dots round
    where the port's do); fc7's and the readouts' gradients within 1e-4 of
    their largest element; fc6's, whose sum rounds once here and per step
    there, by the measures for a bf16 gap (share beyond 6e-2 of the largest
    element, largest and mean residual, correlation).
  * Which route each configuration takes, read from ``PLAIN_CUDA_CALLS``,
    where every plain version's run is counted here (on the card only
    those on a CUDA tensor are).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import heads as jheads
from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
from snn_automotive_object_detection_tpu_torch.models import heads as theads
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6 as k3
from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

BF = torch.bfloat16
STEPS = [8, 12, 20]
KEYS = ("fc6", "fc7", "cls_score", "bbox_pred")
D_IN, REP, N_CLS, R = 7 * 7 * 16, 64, 5, 40
# XLA on the CPU keeps f32 between fused operations unless told not to; the
# program, as written, rounds each product to bf16 (tests/test_torch_state16.py).
NO_EXCESS = {"xla_allow_excess_precision": False}


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / (np.abs(want).max() + 1e-30))


def _bf16_gap_ok(got, want):
    """tests/test_torch_train_heads.py's measures for a gradient one bf16
    rounding apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want) / (np.abs(want).max() + 1e-12)
    corr = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-12))
    return (d > 6e-2).mean() < 0.01 and d.max() < 0.3 and d.mean() < 2e-3 and corr > 0.999


def _x(seed, r=R, d=D_IN, with_25=True):
    x = torch.from_numpy(np.random.default_rng(seed).uniform(0, 3.0, (r, d)).astype(np.float32))
    x = x.to(BF)
    if with_25:
        x[0, :5] = 2.5
    else:
        x[x == 2.5] = 2.484375
    return x


@pytest.fixture(scope="module")
def head():
    params = jheads.init_fastrcnn_snn(jax.random.PRNGKey(2), D_IN, REP, N_CLS)
    params = jax.tree.map(lambda a: a * 3.0, params)        # so that fc7 fires too
    rng = np.random.default_rng(5)
    return (params, rng.normal(size=(R, N_CLS)).astype(np.float32),
            rng.normal(size=(R, 4 * N_CLS)).astype(np.float32))


def _torch_params(params):
    tp = from_numpy_tree(jax.tree.map(np.asarray, params), device="cpu")
    for v in tp.values():
        v["w"].requires_grad_()
    return tp


def test_training_code_pass_is_the_carried_membrane_for_every_bf16_value():
    x = torch.arange(0x7F80, dtype=torch.int32).to(torch.int16).view(BF).reshape(1, -1)
    for t in (8, 12, 20, 32):
        codes = k3.encoder_codes_train_plain(x, t)
        assert codes.shape == (k3.planes(t), 1, 0x7F80) and codes.dtype == torch.int16
        threshold, _ = k3.encoder_codes_plain(x, t)
        v = torch.zeros(x.shape)
        parted = torch.zeros(x.shape, dtype=torch.bool)
        for s in range(t):
            with torch.no_grad():
                z, v = snnf.lif_current_encoder(x.float(), v)
            assert torch.equal(k3.step_spikes(codes, s), z), (t, s)
            parted |= ((threshold >> s) & 1).float() != z
        assert x[parted].float().tolist() == [2.5], t


@pytest.mark.parametrize("t", STEPS)
def test_train_forward_is_f32_sums_of_the_carried_spikes_rounded(head, t):
    params, _, _ = head
    w6 = torch.tensor(np.asarray(params["fc6"]["w"]))
    x = _x(t)
    cur6 = k3.EncoderFc6Train.apply(x, w6, t)
    codes = k3.encoder_codes_train_plain(x, t)
    wf = w6.to(BF).float()
    want = torch.stack([torch.matmul(k3.step_spikes(codes, s), wf) for s in range(t)]).to(BF)
    assert cur6.dtype == BF and torch.equal(cur6, want)
    # The value 2.5 parts the two encoders; without it the threshold count's
    # currents, rounded, are the same bits.
    assert not torch.equal(cur6, k3.encoder_fc6_plain(x, w6, t)[0].to(BF))
    x = _x(t, with_25=False)
    assert torch.equal(k3.EncoderFc6Train.apply(x, w6, t),
                       k3.encoder_fc6_plain(x, w6, t)[0].to(BF))


@pytest.mark.parametrize("t", [12, 20])
def test_train_forward_saves_the_codes_alone(head, t):
    w6 = torch.tensor(np.asarray(head[0]["fc6"]["w"])).requires_grad_()
    x = _x(t)
    cur6 = k3.EncoderFc6Train.apply(x, w6, t)
    saved = cur6.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.int16
    assert torch.equal(saved[0], k3.encoder_codes_train_plain(x, t))


@pytest.mark.parametrize("t", STEPS)
def test_wgrad_plain_matches_autograd_through_the_scans_fc6(head, t):
    w6 = torch.tensor(np.asarray(head[0]["fc6"]["w"]))
    x = _x(t)
    g = torch.from_numpy(np.random.default_rng(t).normal(size=(t, R, REP)).astype(np.float32))
    g = g.to(BF)
    codes = k3.encoder_codes_train_plain(x, t)
    trains = [k3.step_spikes(codes, s) for s in range(t)]

    w_scan = w6.clone().requires_grad_()
    torch.stack([theads._linear(z.to(BF), w_scan) for z in trains]).backward(g)
    w_new = w6.clone().requires_grad_()
    k3.EncoderFc6Train.apply(x, w_new, t).backward(g)
    terms = sum(torch.matmul(z.t(), gs.float()).abs() for z, gs in zip(trains, g))
    gap = (w_new.grad - w_scan.grad).abs()
    assert bool((gap <= 2.0 ** -8 * terms + 1e-6 * float(terms.max())).all())
    assert float(gap.max()) > 0 and w_new.grad.dtype == torch.float32
    assert torch.equal(w_new.grad, k3.encoder_fc6_wgrad_plain(codes, g, t))


@pytest.mark.parametrize("t", STEPS)
def test_train_route_matches_the_scan_and_the_jax_gradient(head, t):
    params, rc, rr = head
    x = _x(t)

    def loss(p):
        c, b, _ = jheads.fastrcnn_snn_apply(p, jnp.asarray(x.float().numpy()), t,
                                            compute_dtype=jnp.bfloat16,
                                            state_dtype=jnp.float32)
        return (c * rc).sum() + (b * rr).sum(), (c, b)

    (_, (jc, jb)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
        params).compile(compiler_options=NO_EXCESS)(params)
    got = {}
    for name, apply in (("scan", theads.fastrcnn_snn_scan_apply),
                        ("route", theads.fastrcnn_snn_train_apply)):
        tp = _torch_params(params)
        c, b, rates = apply(tp, x, t)
        ((c * torch.from_numpy(rc)).sum() + (b * torch.from_numpy(rr)).sum()).backward()
        got[name] = (c.detach().numpy(), b.detach().numpy(),
                     {k: tp[k]["w"].grad.numpy() for k in KEYS})
        assert rates is None
    for want in (got["scan"], (np.asarray(jc), np.asarray(jb),
                               {k: np.asarray(jg[k]["w"]) for k in KEYS})):
        c, b, g = got["route"]
        np.testing.assert_allclose(c, want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b, want[1], rtol=1e-5, atol=1e-5)
        for k in KEYS[1:]:
            assert _rel(g[k], want[2][k]) <= 1e-4, k
        assert _bf16_gap_ok(g["fc6"], want[2]["fc6"])
    assert np.abs(got["route"][2]["fc7"]).max() > 0


@pytest.mark.parametrize("case,route", [
    ({}, "route"), ({"trainable_backbone_layers": 3}, "scan"),
    ({"compute_dtype": torch.float32}, "scan"), ({"snn_state_dtype": None}, "scan"),
    ({"collect_rates": True}, "scan"), ({"t_det": 40}, "scan"),
    ({"training": False}, "eval")])
def test_box_head_route_rule(monkeypatch, head, case, route):
    """The route by the configuration: K3's training instance and the
    weight-gradient kernel for a bf16 step with float32 states and frozen
    features; the scan for trainable stages (the features need a gradient),
    float32, bf16 states, rate collection and t_det > 32; evaluation takes
    K3 and K4 as it did, and none of the training kernels. The plain
    versions count their runs in ``PLAIN_CUDA_CALLS`` on a CUDA tensor
    only, so here every run counts."""
    monkeypatch.setattr(cb, "note_plain", lambda name, t: cb.PLAIN_CUDA_CALLS.update(
        {name: cb.PLAIN_CUDA_CALLS[name] + 1}))
    case = dict(case)
    training = case.pop("training", True)
    collect = case.pop("collect_rates", False)
    cfg = DetectorConfig(num_classes=N_CLS, t_rpn=3, t_det=case.pop("t_det", 4),
                         min_size=64, max_size=128, **case)
    scans = []
    real_scan = theads.fastrcnn_snn_scan_apply
    monkeypatch.setattr(theads, "fastrcnn_snn_scan_apply",
                        lambda *a, **k: scans.append(1) or real_scan(*a, **k))
    tp = _torch_params(head[0])
    flat = _x(1, r=8).to(cfg.compute_dtype)
    if cfg.backbone_trainable_stages:   # the features of trainable stages carry a gradient
        flat = flat.float().requires_grad_().to(cfg.compute_dtype)
    cb.reset_counts()
    try:
        _, box_apply = t_detector.make_head_applies(cfg, {"box_head": tp}, collect, training)
        with torch.set_grad_enabled(training):
            cls, box, _ = box_apply(flat)
        if training:
            (cls.sum() + box.sum()).backward()
        calls = {k: v for k, v in cb.PLAIN_CUDA_CALLS.items() if v}
    finally:
        cb.reset_counts()
    want = {"route": {"encoder_fc6": 1, "encoder_fc6_wgrad": 1}, "scan": {},
            "eval": {"encoder_fc6": 1, "box_tail": 1}}[route]
    assert calls == want and scans == ([1] if route == "scan" else [])
