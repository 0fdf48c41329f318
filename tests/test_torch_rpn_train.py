"""Port vs JAX: the RPN head's training route after the forward became K1's
training instance and the backward K7 from the forward's saved tensors.

Small levels of 2 images, widths 13 and 40 (so that the kernels' 16- and
32-pixel edges show), T = 4 and 8, 15 and 75 readout channels (3 and 15
anchors per location); inputs from numpy seeds.

  * ``rpn_level_bwd_from_saved_plain`` (the plain version of K7) on what
    ``rpn_level_plain(..., save=True)`` saved equals the replaying
    ``rpn_level_bwd_plain`` bit for bit, with f32 and with bf16 planes: the
    saved currents are the conv currents the replay computes, rounded to
    the plane dtype as the forward rounds them, and the LIF rerun from them
    gives the replay's decayed membranes.
  * ``RpnLevelTrain``'s forward equals ``rpn_level`` bit for bit, and what it
    keeps for the backward is the currents, the periods, the spike sums and
    the readout weight: not the features.
  * ``RpnLevelTrain`` forward and backward against the JAX package's custom
    VJP ``_level_train`` (``jax.vjp``; the Pallas kernels ``_run_level`` and
    ``_run_level_bwd`` in interpret mode, as tests/test_torch_train_heads.py
    runs ``_run_level_bwd``): with f32 planes the readouts to 1e-5 and each
    weight gradient within 2e-5 of its largest element; with bf16 planes
    and f32 neuron states (the mixed mode) the readouts to 0.05 absolute
    (tests/test_torch_rpn_head.py's bound: a conv current one bf16 ulp
    apart can flip a LIF spike) and the gradients by
    tests/test_torch_train_heads.py's measures for that mode (share of
    outliers beyond 6e-2, largest and mean residual, correlation), with the
    net count of LIF spikes that differ between the two forwards printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import heads as jheads
from snn_automotive_object_detection_tpu.snn import pallas_rpn as jk
from snn_automotive_object_detection_tpu_torch.models import heads as theads
from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

H = 3
# (width, steps, anchors per location): 15 and 75 readout channels.
CASES = [(13, 4, 3), (40, 8, 15), (13, 8, 15), (40, 4, 3)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("w,t,anchors", CASES)
def test_bwd_from_saved_equals_the_replay_bit_for_bit(dtype, w, t, anchors):
    _, tp, feat, cot = _setup(w, anchors)
    w_out, _ = theads._fused_readout(tp)
    w_shared = tp["shared_conv"]["w"]
    x = torch.from_numpy(feat).to(DTYPES[dtype])
    g = torch.from_numpy(cot)
    *_, saved = cuda_rpn.rpn_level_plain(x, w_shared, w_out, t, save=True)
    assert saved.cur.shape == (2, H, w, t, 256) and saved.cur.dtype == x.dtype
    assert saved.per.dtype == torch.uint8 and int(saved.per.max()) <= t + 1
    keep = saved.cur.clone()
    got = cuda_rpn.rpn_level_bwd_from_saved(saved, w_out, g, t, spike_sum=True)
    want = cuda_rpn.rpn_level_bwd_plain(x, w_shared, w_out, g, t, spike_sum=True)
    assert got[0].shape == (3, 3, 256, 256) and got[1].shape == (256, 5 * anchors)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[2], saved.ssum) and float(got[2].max()) > 0
    assert float(want[0].abs().max()) > 0 and float(want[1].abs().max()) > 0
    # The plain version leaves the saved currents as they are.
    assert torch.equal(saved.cur, keep)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rpn_level_train_forward_is_rpn_level_and_keeps_no_features(dtype):
    w, t, anchors = CASES[1]
    _, tp, feat, _ = _setup(w, anchors)
    w_out, _ = theads._fused_readout(tp)
    w_shared = tp["shared_conv"]["w"].requires_grad_()
    x = torch.from_numpy(feat).to(DTYPES[dtype]).requires_grad_()
    out, enc, lif = cuda_rpn.RpnLevelTrain.apply(x, w_shared, w_out, t)
    want = cuda_rpn.rpn_level(x.detach(), w_shared.detach(), w_out.detach(), t, save=True)
    assert torch.equal(out, want[0]) and torch.equal(enc, want[1]) and torch.equal(lif, want[2])
    kept = out.grad_fn.saved_tensors
    assert [tuple(k.shape) for k in kept] == [(2, H, w, t, 256), (2, H, w, 256),
                                              (2, H, w, 256), (256, 5 * anchors)]
    assert all(torch.equal(a, b) for a, b in zip(kept[:3], want[3]))
    assert not any(k.shape == x.shape and k.dtype == x.dtype and torch.equal(k, x.detach())
                   for k in kept)


def _jax_level_train(params, feat, cot, t, anchors, state_dtype, lif_dtype):
    """The JAX custom VJP of one level: (readout [N, H, W, 5A], dw9, dwout)."""
    c = 256
    w9 = params["shared_conv"]["w"].reshape(9, c, c)
    wout = jnp.concatenate([params["conv_cls"]["w"], params["conv_bbox"]["w"]], -1)
    wout = jnp.pad(wout.reshape(c, 5 * anchors), ((0, 0), (0, 128 - 5 * anchors)))
    x = jnp.asarray(feat).astype(state_dtype)
    (o, b), vjp = jax.vjp(
        lambda w9, wo: jk._level_train(t, anchors, state_dtype, True, lif_dtype, x, w9, wo),
        w9, wout)
    dw9, dwout = vjp((jnp.asarray(cot[..., :anchors]), jnp.asarray(cot[..., anchors:])))
    return (np.concatenate([np.asarray(o, np.float32), np.asarray(b, np.float32)], -1),
            np.asarray(dw9, np.float32), np.asarray(dwout, np.float32)[:, :5 * anchors])


def _port_level_train(tp, feat, cot, t, dtype):
    w_out, _ = theads._fused_readout(tp)
    w_shared = tp["shared_conv"]["w"].clone().requires_grad_()
    w_out = w_out.detach().clone().requires_grad_()
    out, _, _ = cuda_rpn.RpnLevelTrain.apply(torch.from_numpy(feat).to(dtype), w_shared,
                                             w_out, t)
    out.backward(torch.from_numpy(cot))
    return (out.detach().numpy(), w_shared.grad.reshape(9, 256, 256).numpy(),
            w_out.grad.numpy())


@pytest.mark.parametrize("w,t,anchors", CASES[:2])
def test_rpn_level_train_matches_jax_level_train_f32(w, t, anchors):
    params, tp, feat, cot = _setup(w, anchors)
    want = _jax_level_train(params, feat, cot, t, anchors, jnp.float32, None)
    got = _port_level_train(tp, feat, cot, t, torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert _rel(got[1], want[1]) <= 2e-5 and _rel(got[2], want[2]) <= 2e-5
    assert np.abs(want[1]).max() > 0 and np.abs(want[2]).max() > 0


@pytest.mark.parametrize("w,t,anchors", CASES[:2])
def test_rpn_level_train_mixed_close_to_jax_level_train(w, t, anchors):
    params, tp, feat, cot = _setup(w, anchors)
    want = _jax_level_train(params, feat, cot, t, anchors, jnp.bfloat16, jnp.float32)
    got = _port_level_train(tp, feat, cot, t, torch.bfloat16)
    assert np.abs(got[0] - want[0]).max() <= 0.05
    # Flipped spikes, counted net through the two forwards' LIF spike rates.
    _, _, jr = jk.rpn_head_snn_pallas_apply(
        params, [jnp.asarray(feat)], t, state_dtype=jnp.bfloat16, interpret=True,
        collect_rates=True, lif_state_dtype=jnp.float32)
    _, _, tr = theads.rpn_head_snn_apply(tp, [torch.from_numpy(feat)], t, collect_rates=True,
                                         compute_dtype=torch.bfloat16)
    neurons = t * feat[0].size
    flips = np.abs(np.asarray(jr["shared"][0], np.float64) - tr["shared"][0].numpy()) * neurons
    print(f"mixed mode [2, {H}, {w}, 256], T = {t}, {5 * anchors} readout channels: LIF spike "
          f"counts differ by {flips.round().tolist()} (net, per image) of "
          f"{(tr['shared'][0].numpy() * neurons).round().tolist()}; dw9 residual "
          f"{_rel(got[1], want[1]):.3g}, dwout {_rel(got[2], want[2]):.3g} of the largest element")
    for a, b in ((got[1], want[1]), (got[2], want[2])):
        d = np.abs(a - b) / (np.abs(b).max() + 1e-12)
        assert (d > 6e-2).mean() < 0.01 and d.max() < 0.3 and d.mean() < 2e-3
        corr = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        assert corr > 0.999
