"""Port vs JAX: the RPN head's training route and its paired kernel with bf16
neuron states (the reference's --no-amp), on the CPU.

Small levels of 2 images (3 rows, widths 13 and 40), T = 4 and 8, 15 and 75
readout channels, inputs from numpy seeds, as tests/test_torch_rpn_train.py.

  * K1's bf16-state training instance as its plain version
    (``rpn_level_plain(..., save=True, bf16_states=True)``) gives the
    readout, counts and spike sums of the bf16-state evaluation instance's
    plain version bit for bit and saves the currents as the LIF took them;
    K7's bf16-state plain version on those saved tensors
    (``rpn_level_bwd_from_saved_plain(..., bf16_states=True)``) equals the
    replaying ``rpn_level_bwd_plain(..., bf16_states=True)`` bit for bit.
  * ``RpnLevelTrain(..., bf16_states=True)`` forward and backward against
    the JAX package's custom VJP ``_level_train(t, a, bf16, True, bf16,
    ...)`` through ``jax.vjp`` (the Pallas kernels ``_run_level`` and
    ``_run_level_bwd`` in interpret mode), jitted. Compiled with
    ``xla_allow_excess_precision`` off the readout is bit for bit and each
    weight gradient within 2e-5 of its largest element (the f32 test's
    bound: the same products, summed in another order). As XLA compiles it
    by default it keeps f32 between fused bf16 operations, so a few LIF
    spikes flip (tests/test_torch_state16.py): their net count, against the
    JAX kernel's own spike rates, is printed and held to 1e-3 of the
    spikes, and the gradients are held by tests/test_torch_rpn_train.py's
    measures for a forward with flipped spikes.
  * K8's bf16-state plain version equals K1's bf16-state plain version bit
    for bit and, with excess precision off, the JAX ``_run_level_x2(...,
    lif_dtype=bf16, interpret=True)``.
  * Routes: ``make_head_applies`` with bf16 states takes
    ``rpn_head_snn_train_apply(..., bf16_states=True)`` in training and,
    with the pairing switch on, ``rpn_level_x2(..., bf16_states=True)`` in
    evaluation; one bf16-state training step at 64 x 128 has finite,
    nonzero RPN gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import heads as jheads
from snn_automotive_object_detection_tpu.snn import pallas_rpn as jk
from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
from snn_automotive_object_detection_tpu_torch.models import heads as theads
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig, init_params
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
from snn_automotive_object_detection_tpu_torch.train import optim as t_optim
from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

BF = torch.bfloat16
H = 3
# (width, steps, anchors per location): 15 and 75 readout channels.
CASES = [(13, 4, 3), (40, 8, 15), (13, 8, 15), (40, 4, 3)]
NO_EXCESS = {"xla_allow_excess_precision": False}


def _setup(w, anchors, seed=0):
    rng = np.random.default_rng(seed + w + anchors)
    params = jheads.init_rpn_head_snn(jax.random.PRNGKey(7), 256, anchors)
    tp = from_numpy_tree(jax.tree.map(np.asarray, params), device="cpu")
    feat = rng.uniform(0, 2.0, (2, H, w, 256)).astype(np.float32)
    cot = rng.normal(size=(2, H, w, 5 * anchors)).astype(np.float32)
    return params, tp, feat, cot


def _rel(got, want):
    """max |got - want| as a share of max |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("w,t,anchors", CASES)
def test_bf16_state_training_plain_versions_bit_for_bit(w, t, anchors):
    _, tp, feat, cot = _setup(w, anchors)
    w_out, _ = theads._fused_readout(tp)
    w_shared = tp["shared_conv"]["w"]
    x = torch.from_numpy(feat).to(BF)
    g = torch.from_numpy(cot)
    *fwd, saved = cuda_rpn.rpn_level_plain(x, w_shared, w_out, t, spike_sum=True, save=True,
                                           bf16_states=True)
    want = cuda_rpn.rpn_level_plain(x, w_shared, w_out, t, spike_sum=True, bf16_states=True)
    assert all(torch.equal(a, b) for a, b in zip(fwd, want))
    assert torch.equal(saved.ssum, want[3]) and int(want[2].sum()) > 0
    assert saved.cur.shape == (2, H, w, t, 256) and saved.cur.dtype == BF
    assert saved.per.dtype == torch.uint8 and int(saved.per.max()) <= t + 1
    keep = saved.cur.clone()
    got = cuda_rpn.rpn_level_bwd_from_saved(saved, w_out, g, t, spike_sum=True,
                                            bf16_states=True)
    replay = cuda_rpn.rpn_level_bwd_plain(x, w_shared, w_out, g, t, spike_sum=True,
                                          bf16_states=True)
    assert got[0].shape == (3, 3, 256, 256) and got[1].shape == (256, 5 * anchors)
    for a, b in zip(got, replay):
        assert torch.equal(a, b)
    assert torch.equal(got[2], saved.ssum)
    assert float(replay[0].abs().max()) > 0 and float(replay[1].abs().max()) > 0
    assert torch.equal(saved.cur, keep)
    # bf16 states are another function than f32 states on the same inputs.
    f32 = cuda_rpn.rpn_level_bwd_plain(x, w_shared, w_out, g, t, spike_sum=True)
    assert not torch.equal(f32[0], replay[0])


def test_rpn_level_train_bf16_states_forward_and_single_backward():
    w, t, anchors = CASES[1]
    _, tp, feat, cot = _setup(w, anchors)
    w_out, _ = theads._fused_readout(tp)
    w_shared = tp["shared_conv"]["w"].clone().requires_grad_()
    x = torch.from_numpy(feat).to(BF)
    out, enc, lif = cuda_rpn.RpnLevelTrain.apply(x, w_shared, w_out, t, True)
    want = cuda_rpn.rpn_level(x, w_shared.detach(), w_out, t, save=True, bf16_states=True)
    assert torch.equal(out, want[0]) and torch.equal(enc, want[1]) and torch.equal(lif, want[2])
    assert all(torch.equal(a, b) for a, b in zip(out.grad_fn.saved_tensors[:3], want[3]))
    out.backward(torch.from_numpy(cot), retain_graph=True)
    dw = cuda_rpn.rpn_level_bwd_plain(x, w_shared.detach(), w_out, torch.from_numpy(cot), t,
                                      bf16_states=True)[0]
    assert torch.equal(w_shared.grad, dw)
    with pytest.raises(RuntimeError):
        out.backward(torch.from_numpy(cot))


def _jax_level_train(params, feat, cot, t, anchors, excess):
    """The JAX custom VJP of one level with bf16 planes and states, jitted:
    (readout [N, H, W, 5A], dw9, dwout)."""
    c = 256
    w9 = params["shared_conv"]["w"].reshape(9, c, c)
    wout = jnp.concatenate([params["conv_cls"]["w"], params["conv_bbox"]["w"]], -1)
    wout = jnp.pad(wout.reshape(c, 5 * anchors), ((0, 0), (0, 128 - 5 * anchors)))

    def vjp(x, w9, wo, g):
        (o, b), back = jax.vjp(lambda w9, wo: jk._level_train(
            t, anchors, jnp.bfloat16, True, jnp.bfloat16, x.astype(jnp.bfloat16), w9, wo),
            w9, wo)
        return (o, b) + back((g[..., :anchors], g[..., anchors:]))

    args = (jnp.asarray(feat), w9, wout, jnp.asarray(cot))
    lowered = jax.jit(vjp).lower(*args)
    o, b, dw9, dwout = (lowered.compile() if excess
                        else lowered.compile(compiler_options=NO_EXCESS))(*args)
    return (np.concatenate([np.asarray(o, np.float32), np.asarray(b, np.float32)], -1),
            np.asarray(dw9, np.float32), np.asarray(dwout, np.float32)[:, :5 * anchors])


def _jax_lif_spikes(params, feat, t, excess):
    """The JAX kernel's LIF spike count per image with bf16 states."""
    def run(f):
        return jk.rpn_head_snn_pallas_apply(params, [f], t, state_dtype=jnp.bfloat16,
                                            interpret=True, collect_rates=True)[2]["shared"]

    lowered = jax.jit(run).lower(jnp.asarray(feat))
    rate = (lowered.compile() if excess else lowered.compile(compiler_options=NO_EXCESS))(
        jnp.asarray(feat))
    return np.rint(np.asarray(rate, np.float64)[0] * (t * feat[0].size))


@pytest.mark.parametrize("excess", [False, True])
@pytest.mark.parametrize("w,t,anchors", CASES[:2])
def test_rpn_level_train_bf16_states_matches_jax_level_train(w, t, anchors, excess):
    params, tp, feat, cot = _setup(w, anchors)
    want = _jax_level_train(params, feat, cot, t, anchors, excess)
    w_out, _ = theads._fused_readout(tp)
    w_shared = tp["shared_conv"]["w"].clone().requires_grad_()
    w_out = w_out.detach().clone().requires_grad_()
    out, _, lif = cuda_rpn.RpnLevelTrain.apply(torch.from_numpy(feat).to(BF), w_shared, w_out,
                                               t, True)
    out.backward(torch.from_numpy(cot))
    got = (out.detach().numpy(), w_shared.grad.reshape(9, 256, 256).numpy(),
           w_out.grad.numpy())
    jlif = _jax_lif_spikes(params, feat, t, excess)
    flips = np.abs(jlif - lif.numpy()).sum()
    print(f"XLA excess precision {'on' if excess else 'off'}, [2, {H}, {w}, 256], T = {t}, "
          f"{5 * anchors} readout channels: LIF spikes {lif.tolist()} (port) vs "
          f"{jlif.tolist()} (JAX kernel), {flips:.0f} flipped (net); "
          f"{int((got[0] != want[0]).sum())} readout elements differ; dw9 {_rel(got[1], want[1]):.3g},"
          f" dwout {_rel(got[2], want[2]):.3g} of the largest element")
    assert np.abs(want[1]).max() > 0 and np.abs(want[2]).max() > 0 and lif.sum() > 0
    if not excess:
        assert flips == 0
        np.testing.assert_array_equal(got[0], want[0])
        assert _rel(got[1], want[1]) <= 2e-5 and _rel(got[2], want[2]) <= 2e-5
        return
    assert flips <= 1e-3 * lif.sum().item()
    assert np.abs(got[0] - want[0]).max() <= 0.05
    for a, b in ((got[1], want[1]), (got[2], want[2])):
        d = np.abs(a - b) / (np.abs(b).max() + 1e-12)
        assert (d > 6e-2).mean() < 0.01 and d.max() < 0.3 and d.mean() < 2e-3
        corr = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        assert corr > 0.999


@pytest.mark.parametrize("n", [2, 4])
def test_k8_bf16_states_plain_equals_k1_and_the_paired_pallas_kernel(n):
    params, tp, _, _ = _setup(24, 3, seed=n)
    feat = np.random.default_rng(n).uniform(0, 2.0, (n, 4, 24, 256)).astype(np.float32)
    w_out, a = theads._fused_readout(tp)
    x = torch.from_numpy(feat).to(BF)
    one = cuda_rpn.rpn_level_plain(x, tp["shared_conv"]["w"], w_out, 8, spike_sum=True,
                                   bf16_states=True)
    out, ssum = cuda_rpn.rpn_level_x2(x, tp["shared_conv"]["w"], w_out, 8, spike_sum=True,
                                      bf16_states=True)
    assert torch.equal(out, one[0]) and torch.equal(ssum, one[3]) and int(one[2].sum()) > 0
    assert not torch.equal(out, cuda_rpn.rpn_level_x2_plain(x, tp["shared_conv"]["w"], w_out, 8))
    w9 = jnp.asarray(params["shared_conv"]["w"]).reshape(9, 256, 256)
    wout = jnp.pad(jnp.concatenate([params["conv_cls"]["w"], params["conv_bbox"]["w"]],
                                   -1).reshape(256, 15), ((0, 0), (0, 113)))
    assert jk._x2_feasible(feat.shape, jnp.bfloat16, jnp.bfloat16)

    def run(f):
        return jk._run_level_x2(f, w9, wout, 8, a, jnp.bfloat16, True, lif_dtype=jnp.bfloat16)

    o, b = jax.jit(run).lower(jnp.asarray(feat)).compile(compiler_options=NO_EXCESS)(
        jnp.asarray(feat))
    want = np.concatenate([np.asarray(o, np.float32), np.asarray(b, np.float32)], -1)
    np.testing.assert_array_equal(out.numpy(), want)


def _config(**kw):
    return DetectorConfig(num_classes=4, t_rpn=8, t_det=4, min_size=64, max_size=128,
                          snn_state_dtype=None,
                          rpn=RPNConfig(pre_nms_top_n_train=64, post_nms_top_n_train=32,
                                        pre_nms_top_n_test=64, post_nms_top_n_test=32,
                                        batch_size_per_image=64),
                          roi=RoIConfig(batch_size_per_image=16, detections_per_img=8), **kw)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def run(*a, **kw):
        calls.append((name, a[4:], kw))
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, run)


def test_bf16_state_routes(monkeypatch):
    cfg = _config()
    tp = {"rpn_head": from_numpy_tree(jax.tree.map(np.asarray, jheads.init_rpn_head_snn(
        jax.random.PRNGKey(7), 256, 3)), device="cpu")}
    feats = [torch.from_numpy(np.random.default_rng(1).uniform(0, 2.0, (2, 4, 8, 256))
                              .astype(np.float32))]
    calls = []
    for name in ("rpn_head_snn_train_apply", "rpn_head_snn_scan_apply"):
        _spy(monkeypatch, theads, name, calls)
    _spy(monkeypatch, cuda_rpn, "rpn_level_x2", calls)
    _spy(monkeypatch, cuda_rpn, "rpn_level", calls)
    rpn_apply, _ = t_detector.make_head_applies(cfg, tp, False, training=True)
    rpn_apply(feats)
    assert [c[0] for c in calls] == ["rpn_head_snn_train_apply", "rpn_level"]
    assert calls[0][1] == (True,) and calls[1][2] == {"save": True, "bf16_states": True}
    calls.clear()
    monkeypatch.setattr(cuda_rpn, "PAIR_IMAGES", True)
    rpn_apply, _ = t_detector.make_head_applies(cfg, tp, False, training=False)
    out = rpn_apply(feats)
    assert calls == [("rpn_level_x2", (), {"bf16_states": True})]
    want = theads.rpn_head_snn_apply(tp["rpn_head"], feats, 8, bf16_states=True)
    monkeypatch.setattr(cuda_rpn, "PAIR_IMAGES", False)
    assert all(torch.equal(a, b) for a, b in zip(out[0] + out[1], want[0] + want[1]))


def test_bf16_state_training_step_moves_the_rpn_head():
    cfg = _config()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for k in ("shared_conv", "conv_cls"):
        params["rpn_head"][k]["w"].mul_(6.0)
    trainable, frozen = t_optim.split_trainable(params)
    optimizer, scheduler = t_optim.build_optimizer(trainable, "SGD", 0.01, momentum=0.9)
    rng = np.random.default_rng(3)
    ctr = rng.uniform(30, 90, (2, 3, 2)) * np.array([1.0, 0.5])
    half = rng.uniform(8, 20, (2, 3, 2))
    batch = {"images": torch.from_numpy(rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)),
             "image_sizes": torch.tensor([[64, 128]] * 2),
             "original_sizes": torch.tensor([[64, 128]] * 2),
             "targets": {"boxes": torch.from_numpy(np.concatenate([ctr - half, ctr + half],
                                                                  -1).astype(np.float32)),
                         "labels": torch.from_numpy(rng.integers(1, 4, (2, 3))),
                         "valid": torch.tensor([[True, True, False], [True, True, True]])}}
    before = trainable["rpn_head"]["shared_conv"]["w"].clone()
    losses = make_train_step(cfg, optimizer, scheduler)(trainable, frozen, batch,
                                                        torch.Generator().manual_seed(4))
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    for k in ("shared_conv", "conv_cls", "conv_bbox"):
        grad = trainable["rpn_head"][k]["w"].grad
        assert grad is not None and bool(torch.isfinite(grad).all()) and bool((grad != 0).any()), k
    assert not torch.equal(trainable["rpn_head"]["shared_conv"]["w"], before)
