"""Port vs JAX: the MobileNetV3-Large-FPN family.

  * Factory: leaf shapes of ``init_params`` equal the JAX tree's for all
    three backbones; the MobileNet anchor spec (3 levels x 5 sizes x 3
    ratios) gives the same anchors; ``fpn_strides``, the stage-count rule
    and the 320 preset equal the JAX package's.
  * ``utils/weights.py`` carries the MobileNet tree (block lists, optional
    ``expand`` and ``se``, depthwise [k, k, 1, C] weights) both ways.
  * ``mobilenet_v3_fpn_apply`` against the JAX function in float32 on
    carried weights: each of the three levels within 2e-5 of the level's
    largest element (some 60 float32 convolutions in a row, whose sums the
    two libraries take in another order; 3e-6 measured), and the depthwise conv, the SE
    block and the activations one by one to 1e-6.
  * RoIAlign over two levels of the same stride 32: every box goes to level
    0 on both sides, and the pooled values agree to 1e-5.
  * The detector end to end in float32 at a 128x256 bucket, from the JAX
    backbone's own features on (the two libraries' convolutions differ by
    ulps there, which moves borderline spikes): every output element by
    element at the tolerances of tests/test_torch_detector_e2e.py (scores
    1e-4 relative / 1e-5 absolute, boxes 1e-3 / 5e-2, labels and validity
    exact, spike rates 1e-6), with the pairing switch on and off; and the
    four training losses of one float32 step with a frozen backbone within
    1e-5 relative, with the JAX sampler's own draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import factory as j_factory
from snn_automotive_object_detection_tpu.models import mobilenet_fpn as j_mobilenet
from snn_automotive_object_detection_tpu.models.detector import detector_apply as j_apply
from snn_automotive_object_detection_tpu.models.roi_heads import RoIConfig as JRoI
from snn_automotive_object_detection_tpu.models.rpn import RPNConfig as JRPN
from snn_automotive_object_detection_tpu.ops import anchors as j_anchors
from snn_automotive_object_detection_tpu.ops.roi_align import (
    assign_fpn_levels as j_assign_fpn_levels,
    multiscale_roi_align as j_multiscale_roi_align,
)
from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
from snn_automotive_object_detection_tpu_torch.models import factory as t_factory
from snn_automotive_object_detection_tpu_torch.models import mobilenet_fpn as t_mobilenet
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.ops import anchors as t_anchors
from snn_automotive_object_detection_tpu_torch.ops import roi_align as t_roi_align
from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
from snn_automotive_object_detection_tpu_torch.utils.weights import (
    flatten_tree,
    from_numpy_tree,
    to_numpy_tree,
)

from tests.test_torch_detector_e2e import IMG, MEAN, STD, T_STEPS, _jax_eval, _scaled_params
from tests.test_torch_train_losses import roi_draws, rpn_draws
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

MOBILE = "mobilenet_v3_large_fpn"
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")


# ---- factory, anchors, weights

@pytest.mark.parametrize("backbone", t_factory.BACKBONES)
def test_init_params_leaf_shapes_equal_the_jax_tree(backbone):
    want = {k: v.shape for k, v in flatten_tree(jax.eval_shape(
        lambda: j_factory.init_params(j_factory.DetectorConfig(backbone=backbone),
                                      jax.random.PRNGKey(0)))).items()}
    cfg = t_factory.DetectorConfig(backbone=backbone)
    got = flatten_tree(t_factory.init_params(cfg, torch.Generator().manual_seed(0),
                                             device="cpu"))
    assert sorted(got) == sorted(want)
    for k, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[k]), k
        assert leaf.dtype == torch.float32 and bool(torch.isfinite(leaf).all())
    assert (cfg.anchor_spec.num_anchors_per_location[0] ==
            (3 if backbone == "resnet50_fpn" else 15))


def test_mobilenet_anchors_and_config_rules_equal_the_jax_package():
    jcfg, tcfg = j_factory.DetectorConfig(backbone=MOBILE), t_factory.DetectorConfig(
        backbone=MOBILE)
    assert tcfg.fpn_strides == jcfg.fpn_strides == (32, 32, 64)
    assert t_factory.DetectorConfig().fpn_strides == j_factory.DetectorConfig().fpn_strides
    assert tcfg.anchor_spec.sizes == jcfg.anchor_spec.sizes
    assert tcfg.anchor_spec.aspect_ratios == jcfg.anchor_spec.aspect_ratios
    shapes = [(4, 8), (4, 8), (2, 4)]
    want = j_anchors.generate_anchors(shapes, IMG, jcfg.anchor_spec)
    got = t_anchors.generate_anchors(shapes, IMG, tcfg.anchor_spec)
    assert [tuple(a.shape) for a in got] == [(480, 4), (480, 4), (120, 4)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # A stage count is for ResNet; the whole-backbone switch serves MobileNet.
    for cfg_cls in (j_factory.DetectorConfig, t_factory.DetectorConfig):
        with pytest.raises(ValueError):
            cfg_cls(backbone=MOBILE, trainable_backbone_layers=2).backbone_trainable_stages
        assert cfg_cls(backbone=MOBILE, train_backbone=True).backbone_trainable_stages == 5
    with pytest.raises(ValueError):
        t_factory.DetectorConfig(backbone="mobilenet_v2")


def test_320_preset_equals_create_model(monkeypatch):
    # Only the config is compared: the JAX draws of the weights are stubbed.
    monkeypatch.setattr(j_factory, "init_params", lambda *args, **kw: None)
    jcfg, _ = j_factory.create_model("cityscapes", 9, True, True,
                                     backbone="mobilenet_v3_large_320_fpn")
    tcfg = t_factory.DetectorConfig(**t_factory.mobilenet_320_preset())
    assert tcfg.backbone == jcfg.backbone and tcfg.bucket == jcfg.bucket == (320, 640)
    assert dataclasses.asdict(tcfg.rpn) == dataclasses.asdict(jcfg.rpn)
    assert tcfg.rpn.pre_nms_top_n_test == tcfg.rpn.post_nms_top_n_test == 150


@pytest.fixture(scope="module")
def backbone_params():
    """The JAX MobileNet tree as numpy, BN affines and biases drawn so that
    none of them is the identity."""
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda a: np.array(a, np.float32),
                     j_mobilenet.init_mobilenet_v3_fpn(jax.random.PRNGKey(0)))
    for k, leaf in flatten_tree(p).items():
        if k.endswith("bn/scale"):
            leaf[...] = rng.uniform(0.75, 1.3, leaf.shape)
        elif k.endswith("bn/bias") or k.endswith("/b"):
            leaf[...] = rng.normal(0, 0.05, leaf.shape)
    return p


def test_weights_carry_the_mobilenet_tree(backbone_params):
    tree = from_numpy_tree(backbone_params, device="cpu")
    blocks = tree["blocks"]
    assert isinstance(blocks, list) and len(blocks) == len(t_mobilenet.V3_LARGE) == 15
    assert "expand" not in blocks[0] and "expand" in blocks[1]
    assert "se" not in blocks[0] and "se" in blocks[3]
    assert tuple(blocks[3]["dw"]["w"].shape) == (5, 5, 1, 72)
    back = flatten_tree(to_numpy_tree(tree))
    want = flatten_tree(backbone_params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


# ---- the backbone

def test_mobilenet_ops_match(backbone_params):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2.5, (2, 9, 11, 72)).astype(np.float32)
    for got, want in ((t_mobilenet.hardswish(torch.from_numpy(x)), j_mobilenet.hardswish(x)),
                      (t_mobilenet.hardsigmoid(torch.from_numpy(x)), j_mobilenet.hardsigmoid(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert [t_mobilenet._make_divisible(v) for v in (18, 30, 168, 240, 7)] == \
        [j_mobilenet._make_divisible(v) for v in (18, 30, 168, 240, 7)]
    # Block 3: 5x5 depthwise at stride 2 with squeeze-excitation, odd sizes.
    spec, p = t_mobilenet.V3_LARGE[3], backbone_params["blocks"][3]
    xin = rng.normal(0, 1, (2, 9, 11, 24)).astype(np.float32)
    want = j_mobilenet._block(jnp.asarray(xin), jax.tree.map(jnp.asarray, p), spec)
    got = t_mobilenet._block(torch.from_numpy(xin), from_numpy_tree(p, device="cpu"), spec)
    assert got.shape == (2, 5, 6, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for stride in (1, 2):
        w = rng.normal(0, 0.3, (5, 5, 1, 72)).astype(np.float32)
        want = j_mobilenet._dw_conv(jnp.asarray(x), jnp.asarray(w), stride)
        got = t_mobilenet._dw_conv(torch.from_numpy(x), torch.from_numpy(w), stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_mobilenet_v3_fpn_apply_matches_f32(backbone_params):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 128, 256, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: j_mobilenet.mobilenet_v3_fpn_apply(p, x, jnp.float32))(
        jax.tree.map(jnp.asarray, backbone_params), jnp.asarray(x))
    got = t_mobilenet.mobilenet_v3_fpn_apply(from_numpy_tree(backbone_params, device="cpu"),
                                             torch.from_numpy(x), torch.float32)
    assert [tuple(g.shape) for g in got] == [(2, 4, 8, 256), (2, 4, 8, 256), (2, 2, 4, 256)]
    for lvl, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        top = np.abs(w).max()
        err = np.abs(g.numpy() - w).max()
        print(f"level {lvl}: max |value| {top:.4g}, max |diff| {err:.3g} ({err / top:.3g})")
        assert top > 0.1 and err <= 2e-5 * top


def test_roi_align_over_two_levels_of_one_stride():
    rng = np.random.default_rng(3)
    feats = [rng.normal(0, 1, (2, 4, 8, 16)).astype(np.float32) for _ in range(2)]
    ctr = rng.uniform(0, 1, (2, 20, 2)) * np.array([IMG[1], IMG[0]])
    wh = rng.uniform(4, 250, (2, 20, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    tf = [torch.from_numpy(f) for f in feats]
    levels, scales = t_roi_align.level_geometry(tf, torch.from_numpy(boxes), IMG)
    want_levels = j_assign_fpn_levels(jnp.asarray(boxes), 2, k_min=5, k_max=5)
    assert scales == [1 / 32, 1 / 32] and int(levels.abs().sum()) == 0
    np.testing.assert_array_equal(levels.numpy(), np.asarray(want_levels))
    want = jax.jit(lambda f, b: j_multiscale_roi_align(f, b, IMG))(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes))
    got = t_roi_align.multiscale_roi_align(tf, torch.from_numpy(boxes), IMG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---- the detector

@dataclasses.dataclass(frozen=True)
class FastEncoderConfig(j_factory.DetectorConfig):
    fast_encoder: bool = True


N_IMAGES, N_GT = 2, 4
COMMON = dict(num_classes=5, t_rpn=T_STEPS, t_det=T_STEPS, min_size=IMG[0], max_size=IMG[1],
              image_mean=MEAN, image_std=STD, backbone=MOBILE)
RPN_KW = dict(pre_nms_top_n_test=100, post_nms_top_n_test=50, pre_nms_top_n_train=100,
              post_nms_top_n_train=100, batch_size_per_image=64)
ROI_KW = dict(detections_per_img=100, batch_size_per_image=32)


FPN_GAIN = 4.0


def _detector_params(cfg):
    """``_scaled_params`` of the flagship test on the MobileNet tree; the
    backbone's last maps are small, so its FPN outputs are scaled further
    into the encoder's range."""
    p = _scaled_params(cfg)
    for layer in p["backbone"]["fpn"]["layer"]:
        layer["w"] *= FPN_GAIN
    return p


@pytest.fixture(scope="module")
def both():
    jcfg = FastEncoderConfig(rpn=JRPN(**RPN_KW), roi=JRoI(**ROI_KW),
                             compute_dtype=jnp.float32, **COMMON)
    jcfg_train = j_factory.DetectorConfig(rpn=JRPN(**RPN_KW), roi=JRoI(**ROI_KW),
                                          compute_dtype=jnp.float32, **COMMON)
    tcfg = t_factory.DetectorConfig(rpn=RPNConfig(**RPN_KW), roi=RoIConfig(**ROI_KW),
                                    compute_dtype=torch.float32, **COMMON)
    params = _detector_params(jcfg)
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (N_IMAGES, *IMG, 3)).astype(np.float32)
    ctr = rng.uniform(0.25, 0.75, (N_IMAGES, N_GT, 2)) * np.array([IMG[1], IMG[0]])
    half = rng.uniform(10, 40, (N_IMAGES, N_GT, 2))
    batch = {"images": images, "image_sizes": np.asarray([IMG] * N_IMAGES, np.int32),
             "original_sizes": np.asarray([[256, 512]] * N_IMAGES, np.int32),
             "targets": {"boxes": np.concatenate([ctr - half, ctr + half], -1).astype(np.float32),
                         "labels": rng.integers(1, 5, (N_IMAGES, N_GT)),
                         "valid": np.array([[True, True, True, False],
                                            [True, True, False, False]])}}
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jdet = _jax_eval(jparams, jbatch, jcfg, j_mobilenet, "mobilenet_v3_fpn_apply")
    jfeats = jdet.pop("features")
    tfeats = [torch.from_numpy(np.array(f)) for f in jfeats]
    tparams = from_numpy_tree(params, device="cpu")
    tbatch = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v)) for k, v in batch.items()}

    key = jax.random.PRNGKey(11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_mobilenet, "mobilenet_v3_fpn_apply", lambda *a, **kw: list(jfeats))
        _, jlosses = jax.jit(lambda p: j_apply(p, jbatch, jcfg_train, training=True,
                                               rng=key))(jparams)
    key_rpn, key_roi = jax.random.split(key)
    n_anchors = sum(a.shape[0] for a in t_anchors.generate_anchors(
        [tuple(f.shape[1:3]) for f in tfeats], IMG, tcfg.anchor_spec))
    draws = {"rpn": tuple(torch.from_numpy(d) for d in rpn_draws(key_rpn, N_IMAGES, n_anchors)),
             "roi": tuple(torch.from_numpy(d) for d in roi_draws(
                 key_roi, N_IMAGES, RPN_KW["post_nms_top_n_train"] + N_GT))}
    tdet = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_detector, "mobilenet_v3_fpn_apply", lambda *args: tfeats)
        tdet["rates"], _ = t_detector.detector_apply(tparams, tbatch, tcfg, collect_rates=True)
        for pair in (True, False):
            mp.setattr(cuda_rpn, "PAIR_IMAGES", pair)
            tdet[pair], _ = t_detector.detector_apply(tparams, tbatch, tcfg)
        _, tlosses = t_detector.detector_apply(tparams, tbatch, tcfg, training=True,
                                               draws=draws)
    # The port's own backbone, for the shapes and the launch-free float32 route.
    own, _ = t_detector.detector_apply(tparams, tbatch, tcfg)
    to_np = lambda tree: jax.tree.map(lambda t: t.detach().numpy(), tree)  # noqa: E731
    return dict(jdet=jax.tree.map(np.asarray, jdet), jlosses=jax.tree.map(float, jlosses),
                tdet={k: to_np(v) for k, v in tdet.items()}, own=to_np(own),
                tlosses={k: float(v) for k, v in tlosses.items()}, n_anchors=n_anchors)


OUTPUTS = ("boxes", "scores", "labels", "valid", "proposals", "objectness", "all_scores",
           "all_boxes")


def test_mobilenet_detector_output_shapes(both):
    assert both["n_anchors"] == 2 * 4 * 8 * 15 + 2 * 4 * 15
    for k in OUTPUTS:
        assert both["own"][k].shape == both["jdet"][k].shape, k
        assert np.isfinite(both["own"][k]).all()
    assert both["jdet"]["objectness"].shape == (N_IMAGES, 300)
    assert "rpn_rates" not in both["own"]


@pytest.mark.parametrize("run", ["rates", True, False], ids=["rates_on", "paired", "unpaired"])
def test_mobilenet_outputs_exact_on_shared_backbone_features(both, run):
    jdet, tdet = both["jdet"], both["tdet"][run]
    np.testing.assert_array_equal(tdet["valid"], jdet["valid"])
    np.testing.assert_array_equal(tdet["labels"], jdet["labels"])
    for k in ("scores", "objectness", "all_scores"):
        np.testing.assert_allclose(tdet[k], jdet[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("boxes", "proposals", "all_boxes"):
        np.testing.assert_allclose(tdet[k], jdet[k], rtol=1e-3, atol=5e-2, err_msg=k)
    if run == "rates":
        for group in ("rpn_rates", "det_rates"):
            for k, v in jdet[group].items():
                np.testing.assert_allclose(tdet[group][k], v, atol=1e-6, err_msg=k)
        assert tdet["rpn_rates"]["shared"].shape == (3, N_IMAGES)
        print("rates: RPN shared", tdet["rpn_rates"]["shared"].mean(axis=1), "box head",
              {k: float(v.mean()) for k, v in tdet["det_rates"].items()})
        assert tdet["rpn_rates"]["shared"].max() > 0.05
        assert tdet["det_rates"]["fc6"].mean() > 0.02
    else:
        assert "rpn_rates" not in tdet
        for k in OUTPUTS:   # pairing changes no bit
            np.testing.assert_array_equal(tdet[k], both["tdet"]["rates"][k], err_msg=k)
    assert (jdet["valid"] & (jdet["labels"] > 0)).sum() >= 10


@pytest.mark.parametrize("name", LOSSES)
def test_mobilenet_training_losses(both, name):
    got, want = both["tlosses"][name], both["jlosses"][name]
    print(f"{name}: port {got:.7f} jax {want:.7f}")
    assert np.isfinite(got) and want > 0
    assert got == pytest.approx(want, rel=1e-5)
