"""Port vs JAX: target assignment, sampling and the four losses.

``assign_targets_to_anchors``, ``rpn_loss``, ``select_training_samples`` and
``fastrcnn_loss`` on inputs made with numpy seeds. The JAX functions work on
one image and are vmapped by their callers; the port's are batched, so the
JAX side is looped over the images here. Labels, masks and sampled indices
must agree exactly; regression targets and losses to 1e-6 (ulps of ``log``,
``exp`` and ``log_softmax`` and the order of a sum over a few hundred
terms).

The samplers get the JAX package's own uniform draws: ``rpn_loss`` splits
its key per image and ``balanced_sample`` splits that in two;
``select_training_samples`` adds a third draw from ``fold_in(key, 1)`` that
orders the packed slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from snn_automotive_object_detection_tpu.models import roi_heads as j_roi
from snn_automotive_object_detection_tpu.models import rpn as j_rpn
from snn_automotive_object_detection_tpu.ops.anchors import generate_anchors as j_anchors
from snn_automotive_object_detection_tpu.ops.anchors import AnchorSpec as JAnchorSpec
from snn_automotive_object_detection_tpu_torch.models import roi_heads as t_roi
from snn_automotive_object_detection_tpu_torch.models import rpn as t_rpn

from tests.test_torch_train_ops import jax_sampler_draws

IMG = (128, 256)


def _gt(rng, n, g):
    ctr = rng.uniform(30, 220, (n, g, 2)) * np.array([1.0, 0.45])
    wh = rng.uniform(16, 90, (n, g, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    valid = rng.uniform(size=(n, g)) < 0.7
    valid[0, 0] = True
    valid[-1] = False                     # an image without ground truth
    labels = rng.integers(1, 5, (n, g))
    return boxes, labels, valid


def _anchor_grid():
    shapes = [(IMG[0] // s, IMG[1] // s) for s in (4, 8, 16, 32, 64)]
    return np.concatenate([np.asarray(a) for a in j_anchors(shapes, IMG, JAnchorSpec())])


def rpn_draws(key, n, k):
    """The draws of ``rpn_loss``: (rp, rn), each [n, k]."""
    pairs = [jax_sampler_draws(kk, k) for kk in jax.random.split(key, n)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def roi_draws(key, n, k):
    """The draws of ``roi_heads_forward`` in training: (rp, rn, r_pack)."""
    keys = jax.random.split(key, n)
    pairs = [jax_sampler_draws(kk, k) for kk in keys]
    pack = [np.asarray(jax.random.uniform(jax.random.fold_in(kk, 1), (k,))) for kk in keys]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]), np.stack(pack)


def test_assign_targets_to_anchors():
    rng = np.random.default_rng(0)
    anchors = _anchor_grid()
    boxes, _, valid = _gt(rng, 3, 5)
    boxes[0, 1] = anchors[1000]           # an exact match, IoU 1
    valid[0, 1] = True
    jcfg, tcfg = j_rpn.RPNConfig(), t_rpn.RPNConfig()
    want = [j_rpn.assign_targets_to_anchors(jnp.asarray(anchors), jnp.asarray(b),
                                            jnp.asarray(v), jcfg)
            for b, v in zip(boxes, valid)]
    labels, targets = t_rpn.assign_targets_to_anchors(
        torch.from_numpy(anchors), torch.from_numpy(boxes), torch.from_numpy(valid), tcfg)
    np.testing.assert_array_equal(labels.numpy(), np.stack([np.asarray(w[0]) for w in want]))
    np.testing.assert_allclose(targets.numpy(), np.stack([np.asarray(w[1]) for w in want]),
                               rtol=1e-6, atol=1e-6)
    assert int((labels[0] == 1).sum()) > 0 and int((labels[0] == -1).sum()) > 0
    assert bool((labels[-1] == 0).all())


def test_rpn_loss_on_jax_draws():
    rng = np.random.default_rng(1)
    anchors = _anchor_grid()
    n, k = 3, anchors.shape[0]
    boxes, _, valid = _gt(rng, n, 5)
    cfg_kw = dict(batch_size_per_image=64)
    jcfg, tcfg = j_rpn.RPNConfig(**cfg_kw), t_rpn.RPNConfig(**cfg_kw)
    labels, targets = t_rpn.assign_targets_to_anchors(
        torch.from_numpy(anchors), torch.from_numpy(boxes), torch.from_numpy(valid), tcfg)
    obj = rng.normal(0, 2, (n, k)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (n, k, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = j_rpn.rpn_loss(key, jnp.asarray(obj), jnp.asarray(deltas),
                          jnp.asarray(labels.numpy()), jnp.asarray(targets.numpy()), jcfg)
    rp, rn = rpn_draws(key, n, k)
    got = t_rpn.rpn_loss(torch.from_numpy(obj), torch.from_numpy(deltas), labels, targets,
                         tcfg, draws=(torch.from_numpy(rp), torch.from_numpy(rn)))
    np.testing.assert_allclose([float(got[0]), float(got[1])],
                               [float(want[0]), float(want[1])], rtol=1e-6)
    assert float(got[1]) > 0
    # From a generator: finite, and the same seed gives the same loss.
    a = t_rpn.rpn_loss(torch.from_numpy(obj), torch.from_numpy(deltas), labels, targets,
                       tcfg, generator=torch.Generator().manual_seed(1))
    b = t_rpn.rpn_loss(torch.from_numpy(obj), torch.from_numpy(deltas), labels, targets,
                       tcfg, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(a[0]) and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_select_training_samples_on_jax_draws():
    rng = np.random.default_rng(2)
    n, p, g = 3, 120, 5
    boxes, labels, valid = _gt(rng, n, g)
    ctr = rng.uniform(20, 230, (n, p, 2)) * np.array([1.0, 0.5])
    wh = rng.uniform(10, 100, (n, p, 2))
    props = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    props[:, :g] = boxes + rng.normal(0, 2, boxes.shape).astype(np.float32)   # near the GT
    pvalid = rng.uniform(size=(n, p)) < 0.9
    cfg_kw = dict(batch_size_per_image=64)
    jcfg, tcfg = j_roi.RoIConfig(**cfg_kw), t_roi.RoIConfig(**cfg_kw)
    key = jax.random.PRNGKey(6)
    keys = jax.random.split(key, n)
    want = [j_roi.select_training_samples(
        keys[i], jnp.asarray(props[i]), jnp.asarray(pvalid[i]), jnp.asarray(boxes[i]),
        jnp.asarray(labels[i]), jnp.asarray(valid[i]), jcfg) for i in range(n)]
    draws = tuple(torch.from_numpy(d) for d in roi_draws(key, n, p + g))
    got = t_roi.select_training_samples(
        torch.from_numpy(props), torch.from_numpy(pvalid), torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(valid), tcfg, draws=draws)
    for j, name in enumerate(("boxes", "labels", "reg_targets", "valid")):
        w = np.stack([np.asarray(x[j]) for x in want])
        if name in ("labels", "valid"):
            np.testing.assert_array_equal(got[j].numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(got[j].numpy(), w, rtol=1e-6, atol=1e-6, err_msg=name)
    lab, val = got[1].numpy(), got[3].numpy()
    assert (lab[0] > 0).sum() > 0 and val[0].sum() == 64
    # Positives come first; slots that the sample did not fill hold a unit box.
    first_bg = int(np.argmax(lab[0] == 0))
    assert (lab[0][:first_bg] > 0).all() and (lab[0][first_bg:] == 0).all()
    assert (lab[-1] == 0).all()
    if (~val).any():
        np.testing.assert_array_equal(got[0].numpy()[~val], np.tile([0., 0, 1, 1], ((~val).sum(), 1)))


def test_fastrcnn_loss():
    rng = np.random.default_rng(3)
    s, c = 96, 5
    logits = rng.normal(0, 2, (s, c)).astype(np.float32)
    reg = rng.normal(0, 0.4, (s, 4 * c)).astype(np.float32)
    labels = rng.integers(0, c, s)
    targets = rng.normal(0, 0.4, (s, 4)).astype(np.float32)
    valid = rng.uniform(size=s) < 0.8
    want = j_roi.fastrcnn_loss(jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(labels),
                               jnp.asarray(targets), jnp.asarray(valid))
    got = t_roi.fastrcnn_loss(torch.from_numpy(logits), torch.from_numpy(reg),
                              torch.from_numpy(labels), torch.from_numpy(targets),
                              torch.from_numpy(valid))
    np.testing.assert_allclose([float(got[0]), float(got[1])],
                               [float(want[0]), float(want[1])], rtol=1e-6)
    none = t_roi.fastrcnn_loss(torch.from_numpy(logits), torch.from_numpy(reg),
                               torch.from_numpy(labels), torch.from_numpy(targets),
                               torch.zeros(s, dtype=torch.bool))
    assert float(none[0]) == 0.0 and float(none[1]) == 0.0
