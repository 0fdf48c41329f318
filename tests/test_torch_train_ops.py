"""Port vs JAX: the small pieces of the training path.

``heaviside_super`` (forward and SuperSpike gradient), ``encode_boxes``,
``match_boxes`` and the balanced sampler, on inputs made with numpy seeds.
Tolerances: the matcher and the sampler are integer and boolean functions
and must agree exactly; the spike's forward is exact and its gradient, one
division, agrees to 1e-6 relative; ``encode_boxes`` to 1e-6 (an ulp of
``log``).

The two libraries' generators give different numbers from one seed, so the
sampler is split: its pure part takes the uniform draws as arguments and is
held exactly against the JAX sampler by feeding it that sampler's own draws
(``jax.random.split`` then ``jax.random.uniform``, as ops/sampler.py makes
them); the caller that draws from a ``torch.Generator`` is held to its
invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.ops import boxes as j_boxes
from snn_automotive_object_detection_tpu.ops import matcher as j_matcher
from snn_automotive_object_detection_tpu.ops import sampler as j_sampler
from snn_automotive_object_detection_tpu.snn import functional as j_snnf
from snn_automotive_object_detection_tpu_torch.ops import boxes as t_boxes
from snn_automotive_object_detection_tpu_torch.ops import matcher as t_matcher
from snn_automotive_object_detection_tpu_torch.ops import sampler as t_sampler
from snn_automotive_object_detection_tpu_torch.snn import functional as t_snnf
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)


def _boxes(rng, n, size=200.0):
    ctr = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(4, size / 2, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


def test_heaviside_super_forward_and_gradient():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.05, (64, 33)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    g = rng.normal(size=x.shape).astype(np.float32)
    jz, vjp = jax.vjp(lambda v: j_snnf.heaviside_super(v, 100.0), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tz = t_snnf.heaviside_super(tx, 100.0)
    tz.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tz.detach().numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tz.detach().numpy(), t_snnf.heaviside(tx.detach()).numpy())
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=0)


def test_lif_steps_carry_the_surrogate():
    """The LIF step and the encoder are differentiable through their spikes."""
    x = torch.full((4,), 0.3, requires_grad=True)
    z, _ = t_snnf.lif_current_encoder(x, torch.full((4,), 0.24))
    z.sum().backward()
    assert float(x.grad.abs().min()) > 0
    i = torch.full((4,), 1.05, requires_grad=True)
    z, _ = t_snnf.lif_feed_forward_step(torch.zeros(4), t_snnf.LIFState(torch.zeros(4), i))
    z.sum().backward()
    assert float(i.grad.abs().min()) > 0


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_encode_boxes(weights):
    rng = np.random.default_rng(1)
    ref, prop = _boxes(rng, 50), _boxes(rng, 50)
    want = np.asarray(j_boxes.encode_boxes(jnp.asarray(ref), jnp.asarray(prop), weights))
    got = t_boxes.encode_boxes(torch.from_numpy(ref), torch.from_numpy(prop), weights)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # Decoding the encoding gives the box back.
    back = t_boxes.decode_boxes(got, torch.from_numpy(prop), weights)
    np.testing.assert_allclose(back.numpy(), ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("hi,lo,low_quality", [(0.7, 0.3, True), (0.5, 0.5, False)])
@pytest.mark.parametrize("case", ["random", "ties", "no_valid_gt"])
def test_match_boxes(hi, lo, low_quality, case):
    rng = np.random.default_rng(2)
    g, k = 6, 300
    quality = np.asarray(j_boxes.box_iou(jnp.asarray(_boxes(rng, g)), jnp.asarray(_boxes(rng, k))))
    valid = np.array([True, True, False, True, True, False])
    if case == "ties":
        # Equal IoUs down a column (two GT rows tie for an anchor) and along a
        # row (two anchors tie for a GT's best): argmax takes the first.
        quality = np.round(quality * 4) / 4
        quality[1] = quality[0]
        quality[:, 10] = 0.75
    if case == "no_valid_gt":
        valid[:] = False
    want = np.asarray(j_matcher.match_boxes(jnp.asarray(quality), jnp.asarray(valid),
                                            hi, lo, low_quality))
    got = t_matcher.match_boxes(torch.from_numpy(quality), torch.from_numpy(valid),
                                hi, lo, low_quality)
    np.testing.assert_array_equal(got.numpy(), want)
    # Batched: the same rows again with another mask.
    valid2 = ~valid
    want2 = np.asarray(j_matcher.match_boxes(jnp.asarray(quality), jnp.asarray(valid2),
                                             hi, lo, low_quality))
    both = t_matcher.match_boxes(torch.from_numpy(np.stack([quality, quality])),
                                 torch.from_numpy(np.stack([valid, valid2])),
                                 hi, lo, low_quality)
    np.testing.assert_array_equal(both.numpy(), np.stack([want, want2]))


def jax_sampler_draws(key, n):
    """The two uniform draws that the JAX sampler makes from ``key``."""
    kp, kn = jax.random.split(key)
    return np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,)))


@pytest.mark.parametrize("n_pos,n_neg,batch,frac", [
    (40, 300, 64, 0.5),     # enough of both
    (5, 300, 64, 0.5),      # few positives: negatives fill up
    (40, 10, 64, 0.25),     # few negatives
    (0, 0, 16, 0.5),        # nothing to sample
    (30, 30, 512, 0.25),    # batch larger than the pool
])
def test_sampler_pure_part_on_jax_draws(n_pos, n_neg, batch, frac):
    n = 400
    rng = np.random.default_rng(n_pos + n_neg)
    perm = rng.permutation(n)
    pos = np.zeros(n, bool)
    neg = np.zeros(n, bool)
    pos[perm[:n_pos]] = True
    neg[perm[n_pos:n_pos + n_neg]] = True
    key = jax.random.PRNGKey(3)
    jp, jn = j_sampler.balanced_sample(key, jnp.asarray(pos), jnp.asarray(neg), batch, frac)
    rp, rn = jax_sampler_draws(key, n)
    tp, tn = t_sampler.balanced_sample_from_draws(
        torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(rp),
        torch.from_numpy(rn), batch, frac)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_sampler_caller_invariants():
    rng = np.random.default_rng(4)
    labels = rng.integers(-1, 2, (3, 500))
    labels[2, labels[2] == 1] = 0         # an image without positives
    pos, neg = torch.from_numpy(labels == 1), torch.from_numpy(labels == 0)
    batch, frac = 128, 0.5
    a = t_sampler.balanced_sample(torch.Generator().manual_seed(9), pos, neg, batch, frac)
    b = t_sampler.balanced_sample(torch.Generator().manual_seed(9), pos, neg, batch, frac)
    c = t_sampler.balanced_sample(torch.Generator().manual_seed(10), pos, neg, batch, frac)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])     # same seed, same sample
    assert not torch.equal(a[1], c[1])
    sp, sn = a
    assert not (sp & ~pos).any() and not (sn & ~neg).any()         # subsets of the masks
    for i in range(3):
        want_pos = min(int(pos[i].sum()), int(batch * frac))
        assert int(sp[i].sum()) == want_pos
        assert int(sn[i].sum()) == min(int(neg[i].sum()), batch - want_pos)
