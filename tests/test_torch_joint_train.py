"""Port vs JAX: training with trainable backbone stages (the reference's
FPN fine-tune and the joint phase of the bench recipe), split where the two
libraries' float32 convolutions part.

Those convolutions differ by ulps, and the encoder's threshold turns ulps
into moved spikes (tests/test_torch_train_step.py), so the step is held in
three pieces, each on shared inputs:

  (a) the heads' gradient into the features, from shared seeded features:
      the RPN head's scan (the feature gradient through the encoder's
      SuperSpike surrogate), RoIAlign's gradient into the levels and the box
      head's scan into its RoI features, each against ``jax.vjp`` of the JAX
      function for one seeded cotangent, within 1e-4 of the largest element,
      with the readouts compared first (a moved spike shows there);
  (b) the backbone's VJP for one shared cotangent on the levels, for N = 2
      and N = 5 trainable ResNet-50 stages and for MobileNetV3-Large with
      ``train_backbone``: each leaf's gradient within reduction-order
      tolerance of its largest element, and the stages that are not trained
      with no gradient at all (zeros on the JAX side, whose stop_gradient
      passes zeros). ResNet-50 runs in float64 on both sides (1e-10; 1e-14
      measured): in float32 the two forwards' ulps put a few of layer 1's
      ReLU inputs on the other side of zero, which moves layer 1's and the
      stem's gradients by up to 1.6e-3 of their largest element (layers 2-4
      1e-5). MobileNet in float32 (1e-4);
  (c) one whole step of the port with N = 2 on the bf16 route (the fused
      stem's plain version, the unfused FPN and both scans): the split's
      trainable leaves, the two top stages and the FPN among them, moved,
      and every frozen leaf bit-equal with no gradient.

64 x 128 bucket, T = 3, two images; weights drawn by the port's init and
scaled as in tests/test_torch_detector_e2e.py so that every spiking layer
fires.
"""

import dataclasses

import jax
import jax.numpy as jnp
from jax import enable_x64
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import heads as j_heads
from snn_automotive_object_detection_tpu.models import mobilenet_fpn as j_mobilenet
from snn_automotive_object_detection_tpu.models import resnet_fpn as j_resnet
from snn_automotive_object_detection_tpu.ops.roi_align import multiscale_roi_align as j_msra
from snn_automotive_object_detection_tpu.train import optim as j_optim
from snn_automotive_object_detection_tpu_torch.models import heads as t_heads
from snn_automotive_object_detection_tpu_torch.models import mobilenet_fpn as t_mobilenet
from snn_automotive_object_detection_tpu_torch.models import resnet_fpn as t_resnet
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig, init_params
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.ops import roi_align as t_roi_align
from snn_automotive_object_detection_tpu_torch.train import optim as t_optim
from snn_automotive_object_detection_tpu_torch.train import steps as t_steps
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.weights import (
    flatten_tree,
    from_numpy_tree,
    to_numpy_tree,
    tree_leaves,
)

from tests.test_torch_detector_e2e import MEAN, STD, _scale


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

IMG, T, N = (64, 128), 3, 2
GRAD_REL = 1e-4
GRAD_REL_F64 = 1e-10
LEVELS = [(IMG[0] // s, IMG[1] // s) for s in (4, 8, 16, 32, 64)]


def _common():
    return dict(num_classes=5, t_rpn=T, t_det=T, min_size=IMG[0], max_size=IMG[1],
                image_mean=MEAN, image_std=STD)


def _numpy_params(backbone="resnet50_fpn"):
    """Seeded weights as numpy trees for both stacks, drawn by the port's
    init on the CPU (the JAX init's distributions, tests/test_torch_factory.py)."""
    cfg = DetectorConfig(backbone=backbone, **_common())
    return to_numpy_tree(init_params(cfg, torch.Generator().manual_seed(1), device="cpu"))


@pytest.fixture(scope="module")
def params():
    return _scale(_numpy_params())


def _hold(got, want, what):
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    print(f"{what}: max |grad| {top:.4g}, max |diff| {err:.3g} ({err / top:.3g})")
    assert top > 0 and err <= GRAD_REL * top, what


def _moved(got, want):
    return int((np.abs(np.asarray(got) - np.asarray(want)) > 1e-6).sum())


# (a) the heads' gradient into the features

def test_rpn_head_scan_feature_gradient(params):
    rng = np.random.default_rng(3)
    feats = [rng.uniform(0, 3, (N, h, w, 256)).astype(np.float32) for h, w in LEVELS]
    jp = jax.tree.map(jnp.asarray, params["rpn_head"])

    def j_fn(fs):
        lo, reg, _ = j_heads.rpn_head_snn_apply(jp, fs, T, compute_dtype=jnp.float32)
        return lo, reg

    (jlo, jreg), vjp = jax.vjp(jax.jit(j_fn), [jnp.asarray(f) for f in feats])
    cots = (tuple(rng.normal(size=a.shape).astype(np.float32) for a in jlo),
            tuple(rng.normal(size=a.shape).astype(np.float32) for a in jreg))
    (jgrads,) = vjp(tuple(list(c) for c in cots))

    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    tlo, treg, _ = t_heads.rpn_head_snn_scan_apply(
        from_numpy_tree(params["rpn_head"], device="cpu"), tf, T,
        compute_dtype=torch.float32)
    moved = [_moved(a.detach().numpy(), b) + _moved(c.detach().numpy(), d)
             for a, b, c, d in zip(tlo, jlo, treg, jreg)]
    print(f"readout elements per level that differ by more than 1e-6: {moved}")
    assert sum(moved) == 0, "a spike moved between the stacks"
    torch.autograd.backward(list(tlo) + list(treg),
                            [torch.from_numpy(c) for c in cots[0] + cots[1]])
    for i, (t, j) in enumerate(zip(tf, jgrads)):
        _hold(t.grad.numpy(), np.asarray(j), f"RPN head dL/dP{i + 2}")


def test_roi_align_feature_gradient():
    rng = np.random.default_rng(4)
    feats = [rng.normal(size=(N, h, w, 8)).astype(np.float32) for h, w in LEVELS[:4]]
    r = 40
    xy = rng.uniform(0, 1, (N, r, 2)) * np.array([IMG[1], IMG[0]])
    wh = np.exp(rng.uniform(np.log(8), np.log(900), (N, r, 2)))   # every level gets boxes
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    out, vjp = jax.vjp(lambda fs: j_msra(
        fs, jnp.asarray(boxes), IMG), [jnp.asarray(f) for f in feats])
    cot = rng.normal(size=out.shape).astype(np.float32)
    (jgrads,) = vjp(jnp.asarray(cot))
    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    got = t_roi_align.multiscale_roi_align(tf, torch.from_numpy(boxes), IMG)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(cot))
    for i, (t, j) in enumerate(zip(tf, jgrads)):
        _hold(t.grad.numpy(), np.asarray(j), f"RoIAlign dL/dP{i + 2}")


def test_box_head_scan_input_gradient(params):
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 2, (24, 256 * 49)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params["box_head"])
    (jc, jb), vjp = jax.vjp(jax.jit(lambda a: j_heads.fastrcnn_snn_apply(
        jp, a, T, compute_dtype=jnp.float32)[:2]), jnp.asarray(x))
    cots = [rng.normal(size=a.shape).astype(np.float32) for a in (jc, jb)]
    (jgrad,) = vjp(tuple(jnp.asarray(c) for c in cots))
    tx = torch.from_numpy(x).requires_grad_(True)
    tc, tb, _ = t_heads.fastrcnn_snn_scan_apply(
        from_numpy_tree(params["box_head"], device="cpu"), tx, T,
        compute_dtype=torch.float32)
    moved = _moved(tc.detach().numpy(), jc) + _moved(tb.detach().numpy(), jb)
    print(f"box-head readout elements that differ by more than 1e-6: {moved}")
    assert moved == 0, "a spike moved between the stacks"
    torch.autograd.backward([tc, tb], [torch.from_numpy(c) for c in cots])
    _hold(tx.grad.numpy(), np.asarray(jgrad), "box head dL/dx")


# (b) the backbone's VJP

def _cotangents(shapes, dtype):
    """One seeded cotangent on levels of these shapes."""
    rng = np.random.default_rng(6)
    return [rng.normal(size=tuple(s)).astype(dtype) for s in shapes]


def _jax_vjps(j_apply, bb, x, variants, dtype):
    """The JAX levels and leaf gradients, as numpy, of ``j_apply(p, x, v)``
    for each ``v`` in ``variants`` and the seeded cotangent of
    ``_cotangents``, all in one compile."""
    with enable_x64(dtype == np.float64):
        jbb = jax.tree.map(jnp.asarray, bb)
        shapes = [f.shape for f in jax.eval_shape(
            lambda p: j_apply(p, jnp.asarray(x), variants[0]), jbb)]
        cots = _cotangents(shapes, dtype)

        def run(p):
            out = {}
            for v in variants:
                feats, vjp = jax.vjp(lambda q: j_apply(q, jnp.asarray(x), v), p)
                out[v] = (feats, vjp([jnp.asarray(c) for c in cots])[0])
            return out
        return jax.tree.map(np.asarray, jax.jit(run)(jbb))


def _backbone_vjp(jax_vjp, t_apply, bb, x, trained, dtype=np.float32):
    """Each leaf's gradient of the port for the cotangent of ``_cotangents``
    against ``jax_vjp`` (the JAX levels and gradients), in ``dtype``;
    ``trained(path)`` says whether a leaf should get one."""
    tol = GRAD_REL if dtype == np.float32 else GRAD_REL_F64
    jfeats, jgrads = jax_vjp
    tbb = from_numpy_tree(bb, device="cpu", dtype=torch.float64 if dtype == np.float64 else torch.float32)
    for leaf in tree_leaves(tbb):
        leaf.requires_grad_(True)
    tfeats = t_apply(tbb, torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(tfeats, jfeats)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()), err_msg=f"level {i}")
    cots = _cotangents([f.shape for f in jfeats], dtype)
    torch.autograd.backward(list(tfeats), [torch.from_numpy(c) for c in cots])
    want = flatten_tree(jgrads)
    got = flatten_tree(tbb)
    assert sorted(got) == sorted(want)
    n_trained = 0
    for k in sorted(want):
        if trained(k):
            n_trained += 1
            assert got[k].grad is not None, k
            top = float(np.abs(want[k]).max())
            err = float(np.abs(got[k].grad.numpy() - want[k]).max())
            assert top > 0 and err <= tol * top, (k, err, top)
        else:
            assert got[k].grad is None and not want[k].any(), k
    print(f"{n_trained} of {len(want)} leaves trained, each within {tol} of its "
          f"largest element")
    return n_trained


RESNET_STAGES = (2, 5)


@pytest.fixture(scope="module")
def resnet_case(params):
    """The float64 backbone, its input and the JAX VJPs for every N of
    ``RESNET_STAGES`` (one compile)."""
    bb = jax.tree.map(lambda a: a.astype(np.float64), params["backbone"])
    x = np.random.default_rng(7).normal(size=(N, *IMG, 3))
    return bb, x, _jax_vjps(
        lambda p, a, n: j_resnet.resnet50_fpn_apply(p, a, jnp.float64, trainable_layers=n),
        bb, x, RESNET_STAGES, np.float64)


@pytest.mark.parametrize("n_stages", RESNET_STAGES)
def test_resnet_backbone_vjp(resnet_case, n_stages):
    bb, x, jax_vjps = resnet_case
    first = 5 - n_stages   # layer{i} trains when i >= 5 - N; N = 5: the stem too

    def trained(k):
        top = k.split("/")[0]
        return top == "fpn" or (top == "stem" and n_stages == 5) or (
            top.startswith("layer") and int(top[5:]) >= first)

    n = _backbone_vjp(
        jax_vjps[n_stages],
        lambda p, a: t_resnet.resnet50_fpn_apply(p, a, torch.float64, n_stages,
                                                 fused_fpn=False),
        bb, x, trained, np.float64)
    assert n > 0


def test_mobilenet_backbone_vjp_train_backbone():
    bb = _numpy_params("mobilenet_v3_large_fpn")["backbone"]
    x = np.random.default_rng(8).normal(size=(N, *IMG, 3)).astype(np.float32)
    n = _backbone_vjp(
        _jax_vjps(lambda p, a, _: j_mobilenet.mobilenet_v3_fpn_apply(p, a, jnp.float32),
                  bb, x, (None,), np.float32)[None],
        lambda p, a: t_mobilenet.mobilenet_v3_fpn_apply(p, a, torch.float32),
        bb, x, lambda k: True)
    assert n == len(flatten_tree(bb))
    # The split trains all of it, as the JAX split does.
    jt, _ = j_optim.split_trainable({"backbone": bb, "rpn_head": {}, "box_head": {}},
                                    train_backbone=True)
    tt, tf = t_optim.split_trainable(from_numpy_tree(
        {"backbone": bb, "rpn_head": {}, "box_head": {}}, device="cpu"), train_backbone=True)
    assert sorted(flatten_tree(tt)) == sorted(flatten_tree(jt)) and not tree_leaves(tf)


# (c) one whole step of the port

def test_whole_step_two_trainable_stages(params):
    cfg = DetectorConfig(rpn=RPNConfig(pre_nms_top_n_train=100, post_nms_top_n_train=100,
                                       batch_size_per_image=64),
                         roi=RoIConfig(batch_size_per_image=32),
                         compute_dtype=torch.bfloat16, trainable_backbone_layers=2,
                         **_common())
    assert cfg.backbone_trainable_stages == 2
    rng = np.random.default_rng(9)
    ctr = rng.uniform(0.3, 0.7, (N, 3, 2)) * np.array([IMG[1], IMG[0]])
    half = rng.uniform(6, 20, (N, 3, 2))
    batch = {"images": torch.from_numpy(rng.uniform(0, 1, (N, *IMG, 3)).astype(np.float32)),
             "image_sizes": torch.tensor([IMG] * N), "original_sizes": torch.tensor([IMG] * N),
             "targets": {"boxes": torch.from_numpy(np.concatenate(
                 [ctr - half, ctr + half], -1).astype(np.float32)),
                 "labels": torch.from_numpy(rng.integers(1, 5, (N, 3))),
                 "valid": torch.ones((N, 3), dtype=torch.bool)}}
    tparams = from_numpy_tree(params, device="cpu")
    trainable, frozen = t_optim.split_trainable(tparams, trainable_backbone_layers=2)
    assert sorted(trainable["backbone"]) == ["layer3", "layer4"]
    assert sorted(frozen["backbone"]) == ["layer1", "layer2", "stem"]
    assert "backbone_fpn" in trainable
    t_leaves, f_leaves = flatten_tree(trainable), tree_leaves(frozen)
    t_before = {k: v.clone() for k, v in t_leaves.items()}
    f_before = [v.clone() for v in f_leaves]
    opt, sched = t_optim.build_optimizer(trainable, "AdamW", 1e-3)
    cb.reset_counts()
    losses = t_steps.make_train_step(cfg, opt, sched)(
        trainable, frozen, batch, torch.Generator().manual_seed(0))
    print({k: round(float(v), 5) for k, v in losses.items()})
    assert all(np.isfinite(float(v)) for v in losses.values())
    unmoved = [k for k, v in t_leaves.items() if torch.equal(v, t_before[k])]
    assert not unmoved, unmoved
    assert all(torch.equal(a, b) and b.grad is None for a, b in zip(f_before, f_leaves))
    # Only the fused stem's plain version ran of the kernels' routes; none
    # counts on the CPU.
    assert not any(cb.LAUNCHES.values()) and not any(cb.PLAIN_CUDA_CALLS.values())


def test_joint_route_rule():
    """Trainable stages send the RPN head to the scan in training, as the
    JAX package does (its VJP kernel passes no feature gradient)."""
    from snn_automotive_object_detection_tpu_torch.models import detector as t_detector

    calls = []
    cfg = DetectorConfig(compute_dtype=torch.bfloat16, **_common())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_heads, "rpn_head_snn_scan_apply", lambda *a, **k: calls.append("scan"))
        mp.setattr(t_heads, "rpn_head_snn_train_apply", lambda *a, **k: calls.append("k1k7"))
        for n in (0, 3, 5):
            c = dataclasses.replace(cfg, trainable_backbone_layers=n)
            t_detector.make_head_applies(c, {"rpn_head": None}, False, training=True)[0]([])
    assert calls == ["k1k7", "scan", "scan"]


def test_training_cli_trains_the_top_stages(tmp_path):
    """``cli/train.py --trainable-backbone-layers 2`` for one epoch on the
    mini COCO set (bf16: the fused stem's plain version, the scans): the
    checkpoint's layer3, layer4, FPN and RPN head moved from the initial
    weights, the stem, layer1 and layer2 bit-equal."""
    from snn_automotive_object_detection_tpu_torch.cli import train as t_cli
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import load_checkpoint

    from tests.mini_dataset import make_mini_env

    _, ds_yaml, model_yaml = make_mini_env(tmp_path)
    args = t_cli.get_args_parser().parse_args(
        ["-d", ds_yaml, "--model-config", model_yaml, "--rpn-snn", "--detector-snn",
         "-t-rpn", "2", "-t-det", "2", "-b", "2", "-j", "1", "--device", "cpu", "--epochs", "1",
         "--opt", "SGD", "--lr", "0.01", "--trainable-backbone-layers", "2",
         "--out-dir", str(tmp_path / "out")])
    _, _, config, init, _ = t_cli.build_everything(args)
    assert config.backbone_trainable_stages == 2
    init = {k: v.clone() for k, v in flatten_tree(init).items()}
    t_cli.main(args)
    saved = flatten_tree(load_checkpoint(str(tmp_path / "out" / "model_cityscapes_1.pth"))["params"])
    assert sorted(saved) == sorted(init)
    for k, v in saved.items():
        top = k.split("/")[1] if k.startswith("backbone/") else k.split("/")[0]
        if top in ("layer3", "layer4", "fpn", "rpn_head"):
            assert not torch.equal(v, init[k]), k
        elif top in ("stem", "layer1", "layer2"):
            assert torch.equal(v, init[k]), k
