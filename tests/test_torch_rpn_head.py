"""Port vs JAX: the spiking RPN head (plain version of kernel K1).

The port's head (models/heads.py -> snn/cuda_rpn.py, plain version on the
CPU) against the JAX Pallas kernel in interpret mode and the JAX XLA scan
(fast_encoder=True), at the shapes of tests/test_pallas_rpn.py.

Tolerances:
  * f32: 1e-5 absolute and relative. Both sides compute the same spikes;
    only the reduction order of the conv and readout sums differs.
  * bf16 planes with f32 neuron states (the production numerics): outputs
    to 0.05 absolute (spike scale, as tests/test_pallas_rpn.py), and at most
    1% of the LIF spikes may flip, because a conv current one bf16 ulp
    apart can move a membrane across the threshold. The flip count (net
    difference of LIF spike counts) is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import heads as jheads
from snn_automotive_object_detection_tpu.snn.pallas_rpn import rpn_head_snn_pallas_apply
from snn_automotive_object_detection_tpu_torch.models import heads as theads
from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree

SHAPES = [(10, 18), (5, 9)]
T = 8


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    params = jheads.init_rpn_head_snn(jax.random.PRNGKey(0), 256, 3)
    feats = [rng.uniform(0, 2.0, (2, h, w, 256)).astype(np.float32)
             for h, w in SHAPES]
    tparams = from_numpy_tree(jax.tree.map(np.asarray, params), device="cpu")
    return params, tparams, feats


def _port(tparams, feats, dtype):
    return theads.rpn_head_snn_apply(
        tparams, [torch.from_numpy(f) for f in feats], T, collect_rates=True,
        compute_dtype=dtype)


def test_rpn_head_f32_matches_pallas_and_xla(setup):
    params, tparams, feats = setup
    jf = [jnp.asarray(f) for f in feats]
    o_k, b_k, r_k = rpn_head_snn_pallas_apply(
        params, jf, T, state_dtype=jnp.float32, interpret=True,
        collect_rates=True)
    o_x, b_x, r_x = jheads.rpn_head_snn_apply(
        params, jf, T, collect_rates=True, compute_dtype=jnp.float32,
        fast_encoder=True)
    o_t, b_t, r_t = _port(tparams, feats, torch.float32)
    for lvl in range(len(SHAPES)):
        for got, want in ((o_t[lvl], o_k[lvl]), (b_t[lvl], b_k[lvl]),
                          (o_t[lvl], o_x[lvl]), (b_t[lvl], b_x[lvl])):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
    for key in ("encoder", "shared"):
        np.testing.assert_allclose(r_t[key].numpy(), np.asarray(r_k[key]),
                                   rtol=1e-6)
        np.testing.assert_allclose(r_t[key].numpy(), np.asarray(r_x[key]),
                                   rtol=1e-6)
    print(f"spike rates: encoder {r_t['encoder'].mean():.3f}, "
          f"LIF {r_t['shared'].mean():.3f}")
    assert float(r_t["shared"].min()) > 0.01


def test_rpn_head_mixed_bf16_close_to_pallas(setup):
    params, tparams, feats = setup
    o_k, b_k, r_k = rpn_head_snn_pallas_apply(
        params, [jnp.asarray(f) for f in feats], T, state_dtype=jnp.bfloat16,
        interpret=True, collect_rates=True, lif_state_dtype=jnp.float32)
    o_t, b_t, r_t = _port(tparams, feats, torch.bfloat16)
    for lvl, (h, w) in enumerate(SHAPES):
        np.testing.assert_allclose(o_t[lvl].numpy(), np.asarray(o_k[lvl]), atol=0.05)
        np.testing.assert_allclose(b_t[lvl].numpy(), np.asarray(b_k[lvl]), atol=0.05)
        denom = T * h * w * 256
        enc_t = np.rint(r_t["encoder"][lvl].double().numpy() * denom)
        enc_k = np.rint(np.asarray(r_k["encoder"][lvl], np.float64) * denom)
        np.testing.assert_array_equal(enc_t, enc_k)
        lif_t = np.rint(r_t["shared"][lvl].double().numpy() * denom)
        lif_k = np.rint(np.asarray(r_k["shared"][lvl], np.float64) * denom)
        flips = np.abs(lif_t - lif_k).sum()
        print(f"level {lvl}: {int(flips)} of {int(lif_k.sum())} LIF spikes "
              f"flipped (net)")
        assert flips <= 0.01 * lif_k.sum()


def test_rpn_wrapper_dispatch_by_device(setup):
    _, tparams, feats = setup
    x = torch.from_numpy(feats[1]).to(torch.bfloat16)
    w = tparams["shared_conv"]["w"]
    w_out = torch.zeros(256, 15)
    out, enc, lif = cuda_rpn.rpn_level(x, w, w_out, 4)
    assert out.shape == (2, 5, 9, 15) and enc.dtype == torch.int64
    with pytest.raises(ValueError):
        cuda_rpn.rpn_level(x.to("meta"), w, w_out, 4)


def test_rpn_spike_sum_feeds_the_readout(setup):
    _, tparams, feats = setup
    x = torch.from_numpy(feats[1]).to(torch.bfloat16)
    w_out = torch.from_numpy(
        np.random.default_rng(1).normal(0, 0.05, (256, 15)).astype(np.float32))
    out, enc, lif, ssum = cuda_rpn.rpn_level(
        x, tparams["shared_conv"]["w"], w_out, T, spike_sum=True)
    assert ssum.shape == (2, 5, 9, 256)
    # Every spike adds a positive LI coefficient, so a neuron that never
    # spiked has a zero sum, and the readout is the rounded product.
    spiked = (ssum > 0).sum(dim=(1, 2, 3))
    assert int(spiked.sum()) > 0 and bool((spiked <= lif).all())
    want = torch.matmul(ssum, w_out.to(torch.bfloat16).float())
    torch.testing.assert_close(out, want.to(torch.bfloat16).float(), rtol=0, atol=0)
