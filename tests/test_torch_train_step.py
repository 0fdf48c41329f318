"""Port vs JAX: one training step of the slice as a whole, in float32.

Setup of tests/test_torch_detector_e2e.py (128x256 bucket, T_rpn = T_det =
6, 5 classes, the weights scaled so that every spiking layer fires), two
images with seeded targets (one of them padded), RPN 100/100 proposals and
64 sampled anchors, 32 sampled RoIs. Both stacks get the same weights
through ``utils/weights.py``, the same numpy images and targets, and the
same sampler draws: the JAX package's own, remade from its key as
``detector_apply`` splits it (tests/test_torch_train_losses.py).

The port's float32 step takes the scans under autograd for both heads, the
JAX package its XLA scans. The backbone is frozen and its features are
shared (both stacks run on one jitted run of the JAX backbone, as
``test_outputs_exact_on_shared_backbone_features`` shares them), since the
two libraries' float32 convolutions differ by ulps there, which flips
encoder spikes downstream. From the features on nothing is shared. The RPN
head's own float32 conv sums differ by ulps too, and on most image seeds
that moves one to four LIF spikes of level 0 by a step (3 million
neuron-steps, weights scaled up sixfold), each of which moves one pixel's
objectness by 1e-3 and ``loss_objectness`` by 5e-5. The seed used is one of
those without such a spike (8 and 16 of 7..18); ``test_no_spike_moved``
counts them first, so a failure there says why the others fail.

Tolerances: the four losses 1e-5 relative; every gradient of ``rpn_head``
and ``box_head`` within 1e-4 of its largest element; the parameters after
one SGD step (momentum 0.9, weight decay 1e-4, rate 0.01; its update is
linear in the gradient, while AdamW's first step is the gradient's sign)
within 1e-6 relative plus rate x 1e-4 of the largest gradient element. The
frozen leaves are bit-equal after the step and have no gradient. The spike
rates of the training forward agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snn_automotive_object_detection_tpu.models import detector as j_detector
from snn_automotive_object_detection_tpu.models import heads as j_heads
from snn_automotive_object_detection_tpu.models import resnet_fpn as j_resnet
from snn_automotive_object_detection_tpu.models import transform as j_transform
from snn_automotive_object_detection_tpu.models.detector import detector_apply as j_apply
from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
from snn_automotive_object_detection_tpu.models.roi_heads import RoIConfig as JRoI
from snn_automotive_object_detection_tpu.models.rpn import RPNConfig as JRPN
from snn_automotive_object_detection_tpu.train import optim as j_optim
from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
from snn_automotive_object_detection_tpu_torch.models import heads as t_heads
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.train import optim as t_optim
from snn_automotive_object_detection_tpu_torch.train import steps as t_steps
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.weights import (
    flatten_tree,
    from_numpy_tree,
    to_numpy_tree,
    tree_leaves,
)

from tests.test_torch_detector_e2e import IMG, MEAN, STD, T_STEPS, _scaled_params
from tests.test_torch_train_losses import roi_draws, rpn_draws

N_IMAGES, N_GT, LR = 2, 4, 0.01
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")
RPN_KW = dict(pre_nms_top_n_train=100, post_nms_top_n_train=100, batch_size_per_image=64)
ROI_KW = dict(batch_size_per_image=32)


def _batch():
    rng = np.random.default_rng(8)
    images = rng.uniform(0, 1, (N_IMAGES, *IMG, 3)).astype(np.float32)
    ctr = rng.uniform(0.25, 0.75, (N_IMAGES, N_GT, 2)) * np.array([IMG[1], IMG[0]])
    half = rng.uniform(8, 30, (N_IMAGES, N_GT, 2))
    targets = {"boxes": np.concatenate([ctr - half, ctr + half], -1).astype(np.float32),
               "labels": rng.integers(1, 5, (N_IMAGES, N_GT)),
               "valid": np.array([[True, True, True, False], [True, True, False, False]])}
    return {"images": images, "image_sizes": np.asarray([IMG] * N_IMAGES, np.int32),
            "original_sizes": np.asarray([[256, 512]] * N_IMAGES, np.int32), "targets": targets}


@pytest.fixture(scope="module")
def both():
    common = dict(num_classes=5, t_rpn=T_STEPS, t_det=T_STEPS, min_size=IMG[0],
                  max_size=IMG[1], image_mean=MEAN, image_std=STD)
    jcfg = JConfig(rpn=JRPN(**RPN_KW), roi=JRoI(**ROI_KW), compute_dtype=jnp.float32, **common)
    tcfg = DetectorConfig(rpn=RPNConfig(**RPN_KW), roi=RoIConfig(**ROI_KW),
                          compute_dtype=torch.float32, **common)
    params, batch = _scaled_params(jcfg), _batch()
    key = jax.random.PRNGKey(11)

    # JAX: losses, gradients and one SGD step, on the features of one
    # jitted run of its backbone.
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jt, jf = j_optim.split_trainable(jparams)
    jfeats = jax.jit(lambda x: j_resnet.resnet50_fpn_apply(
        jparams["backbone"], j_transform.normalize_images(x, MEAN, STD), jnp.float32)
    )(jbatch["images"])
    tfeats = [torch.from_numpy(np.array(f)) for f in jfeats]

    def loss_fn(trainable):
        out, losses = j_apply(j_optim.merge_params(trainable, jf), jbatch, jcfg,
                              training=True, rng=key, collect_rates=True)
        return sum(losses.values()), (losses, out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_detector, "resnet50_fpn_apply", lambda *args, **kw: list(jfeats))
        (_, (jlosses, jrates)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jt)
        jax.block_until_ready(jgrads)
    jopt = j_optim.build_optimizer("SGD", LR, momentum=0.9, weight_decay=1e-4)
    updates, _ = jopt.update(jgrads, jopt.init(jt), jt)
    jnew = optax.apply_updates(jt, updates)
    key_rpn, key_roi = jax.random.split(key)
    n_anchors = sum((IMG[0] // s) * (IMG[1] // s) * 3 for s in (4, 8, 16, 32, 64))
    draws = {"rpn": tuple(torch.from_numpy(d) for d in rpn_draws(key_rpn, N_IMAGES, n_anchors)),
             "roi": tuple(torch.from_numpy(d) for d in roi_draws(
                 key_roi, N_IMAGES, RPN_KW["post_nms_top_n_train"] + N_GT))}
    tparams = from_numpy_tree(params, device="cpu")
    tbatch = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v)) for k, v in batch.items()}
    # Pixels whose RPN readout differs: a LIF spike moved between the stacks.
    jo, _, _ = j_heads.rpn_head_snn_apply(jparams["rpn_head"], list(jfeats), T_STEPS,
                                          compute_dtype=jnp.float32)
    to, _, _ = t_heads.rpn_head_snn_scan_apply(tparams["rpn_head"], tfeats, T_STEPS,
                                               compute_dtype=torch.float32)
    moved = [int((np.abs(np.asarray(a) - b.numpy()) > 1e-6).any(-1).sum())
             for a, b in zip(jo, to)]
    tt, tf = t_optim.split_trainable(tparams)
    frozen_before = [leaf.clone() for leaf in tree_leaves(tf)]
    opt, sched = t_optim.build_optimizer(tt, "SGD", LR, momentum=0.9, weight_decay=1e-4)
    cb.reset_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_detector, "resnet50_fpn_apply", lambda *args: tfeats)
        trates, _ = t_detector.detector_apply(
            t_optim.merge_params(tt, tf), tbatch, tcfg, training=True, draws=draws,
            collect_rates=True)
        tlosses = t_steps.make_train_step(tcfg, opt, sched)(tt, tf, tbatch, None, draws)
        val = t_steps.make_val_loss_step(tcfg)(tparams, tbatch, None, draws)
    return dict(moved=moved, jlosses=jax.tree.map(float, jlosses), jgrads=jax.tree.map(np.asarray, jgrads),
                jnew=jax.tree.map(np.asarray, jnew), jrates=jax.tree.map(np.asarray, jrates),
                tlosses={k: float(v) for k, v in tlosses.items()},
                trates=jax.tree.map(lambda t: t.detach().numpy(), trates),
                tgrads=to_numpy_tree(tt, grads=True), tnew=to_numpy_tree(tt),
                frozen=(frozen_before, tf), val={k: float(v) for k, v in val.items()},
                launches=dict(cb.LAUNCHES))


def test_no_spike_moved(both):
    print(f"pixels per level whose RPN readout differs by more than 1e-6: {both['moved']}")
    assert sum(both["moved"]) == 0, "a LIF spike moved between the stacks: take another seed"


def test_training_forward_spike_rates(both):
    for group in ("rpn_rates", "det_rates"):
        for k, want in both["jrates"][group].items():
            np.testing.assert_allclose(both["trates"][group][k], want, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{group}/{k}")
            assert float(np.mean(want)) > 0.005, (group, k)


@pytest.mark.parametrize("name", LOSSES)
def test_losses(both, name):
    got, want = both["tlosses"][name], both["jlosses"][name]
    print(f"{name}: port {got:.7f} jax {want:.7f}")
    assert np.isfinite(got) and want > 0
    assert got == pytest.approx(want, rel=1e-5)


def test_loss_total_and_float32_route(both):
    assert both["tlosses"]["loss_total"] == pytest.approx(
        sum(both["tlosses"][k] for k in LOSSES), rel=1e-6)
    # float32 takes the scans: no kernel's plain version is on this route.
    assert all(v == 0 for v in both["launches"].values())


@pytest.mark.parametrize("group", ["rpn_head", "box_head"])
def test_gradients(both, group):
    got, want = flatten_tree(both["tgrads"][group]), flatten_tree(both["jgrads"][group])
    assert sorted(got) == sorted(want)
    for k in want:
        top = np.abs(want[k]).max()
        err = np.abs(got[k] - want[k]).max()
        print(f"{group}/{k}: max |grad| {top:.4g}, max |diff| {err:.3g} ({err / top:.3g})")
        assert top > 0 and err <= 1e-4 * top, k


@pytest.mark.parametrize("group", ["rpn_head", "box_head"])
def test_parameters_after_one_sgd_step(both, group):
    got, want = flatten_tree(both["tnew"][group]), flatten_tree(both["jnew"][group])
    grads = flatten_tree(both["jgrads"][group])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                   atol=LR * 1e-4 * np.abs(grads[k]).max(), err_msg=k)


def test_frozen_leaves_stay(both):
    before, frozen = both["frozen"]
    leaves = tree_leaves(frozen)
    assert sorted(frozen) == ["backbone", "backbone_fpn"] and len(leaves) == len(before)
    assert all(torch.equal(a, b) and b.grad is None for a, b in zip(before, leaves))


def test_val_loss_step_is_the_training_loss_after_the_update(both):
    # Other parameters than the step saw (it ran after the update), the same
    # draws: finite, and not the losses before the update.
    assert all(np.isfinite(v) for v in both["val"].values())
    assert sorted(both["val"]) == sorted(LOSSES + ("loss_total",))
    assert both["val"]["loss_total"] != both["tlosses"]["loss_total"]
