"""Port vs JAX: ``create_model`` and the parameter trees of every head
combination.

  * The configuration ``create_model`` builds, field by field, against the
    JAX package's for each dataset's image statistics (Cityscapes' own,
    ImageNet's for the others), each of the four (rpn_snn, detector_snn)
    switches with their RoI operating points (SNN 0.4 / 0.5, ANN 0.10 /
    0.45), the model.yaml key maps (RPN, ROIHeads, transform sections; an
    unknown key ignored), the 320 MobileNet preset, and the state dtype
    (unset: float32 states; None: the compute dtype). Both sides' parameter
    draws are stubbed out here: only the configuration is compared.
  * ``init_params``' tree against the JAX tree's shapes (``jax.eval_shape``)
    for every (rpn_snn, detector_snn, only_one_bbox): the same keys and
    shapes, float32 and finite; the ANN box head carries ``box_predictor``
    with per-class boxes, a spiking head of one box 4 deltas.
  * ``create_model`` draws its parameters from a generator seeded with
    ``seed`` on the device it is given: the same seed, the same tree.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch

from snn_automotive_object_detection_tpu.models import factory as j_factory
from snn_automotive_object_detection_tpu_torch.models import factory as t_factory
from snn_automotive_object_detection_tpu_torch.utils.weights import flatten_tree


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs these files in parallel
    workers, where more threads a process only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

YAML = {"RPN": {"rpn_pre_nms_top_n_test": 500, "rpn_post_nms_top_n_train": 1000,
                "rpn_nms_thresh": 0.6, "rpn_score_thresh": 0.01,
                "rpn_batch_size_per_image": 128, "not_a_key": 3},
        "ROIHeads": {"box_score_thresh": 0.3, "box_nms_thresh": 0.4,
                     "box_detections_per_img": 50, "box_batch_size_per_image": 256,
                     "box_positive_fraction": 0.5},
        "transform": {"min_size": 512, "max_size": 1024}}
DTYPES = {None: None, jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
UNSET = object()

CASES = [
    # dataset, rpn_snn, detector_snn, backbone, yaml, compute dtype, state dtype
    ("cityscapes", True, True, "resnet50_fpn", None, jnp.bfloat16, UNSET),
    ("bdd", True, True, "resnet50_fpn", None, jnp.bfloat16, None),
    ("idd", False, True, "resnet50_fpn", YAML, jnp.float32, UNSET),
    ("cityscapes", True, False, "mobilenet_v3_large_fpn", None, jnp.bfloat16, jnp.float32),
    ("coco", False, False, "resnet50_fpn", YAML, jnp.bfloat16, UNSET),
    ("cityscapes", True, True, "mobilenet_v3_large_320_fpn", None, jnp.bfloat16, UNSET),
    ("pascal", False, False, "mobilenet_v3_large_320_fpn", YAML, jnp.float32, None),
]


@pytest.mark.parametrize("case", CASES)
def test_create_model_config_equals_the_jax_one(monkeypatch, case):
    dataset, rpn_snn, det_snn, backbone, yaml, cd, sd = case
    monkeypatch.setattr(j_factory, "init_params", lambda config, key: {})
    monkeypatch.setattr(t_factory, "init_params", lambda config, g, device=None: {})
    kw = dict(num_steps_rpn=8, num_steps_detector=12, only_one_bbox=not det_snn,
              model_yaml=yaml, backbone=backbone)
    jcfg, _ = j_factory.create_model(
        dataset, 9, rpn_snn, det_snn, compute_dtype=cd,
        **kw, **({} if sd is UNSET else {"snn_state_dtype": sd}))
    tcfg, params = t_factory.create_model(
        dataset, 9, rpn_snn, det_snn, compute_dtype=DTYPES[cd], device="cpu",
        **kw, **({} if sd is UNSET else {"snn_state_dtype": DTYPES[sd]}))
    assert params == {}
    for f in ("num_classes", "backbone", "rpn_snn", "detector_snn", "t_rpn", "t_det",
              "only_one_bbox", "image_mean", "image_std", "min_size", "max_size",
              "fpn_channels", "representation_size", "train_backbone",
              "trainable_backbone_layers"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(tcfg.rpn) == dataclasses.asdict(jcfg.rpn)
    assert dataclasses.asdict(tcfg.roi) == dataclasses.asdict(jcfg.roi)
    assert tcfg.compute_dtype == DTYPES[jcfg.compute_dtype]
    assert tcfg.snn_state_dtype == DTYPES[jcfg.snn_state_dtype]
    state = jcfg.snn_state_dtype or jcfg.compute_dtype
    assert tcfg.state_dtype == DTYPES[state]
    assert tcfg.anchor_spec.num_anchors_per_location == jcfg.anchor_spec.num_anchors_per_location
    assert tcfg.fpn_strides == jcfg.fpn_strides


def test_320_preset_alias_is_create_models(monkeypatch):
    monkeypatch.setattr(t_factory, "init_params", lambda config, g, device=None: {})
    cfg, _ = t_factory.create_model("cityscapes", 9, True, True,
                                    backbone="mobilenet_v3_large_320_fpn", device="cpu")
    preset = t_factory.DetectorConfig(**t_factory.mobilenet_320_preset())
    assert cfg.bucket == preset.bucket == (320, 640) and cfg.rpn == preset.rpn


@pytest.mark.parametrize("rpn_snn,det_snn,one_box",
                         list(itertools.product((True, False), repeat=3)))
def test_init_params_tree_equals_the_jax_tree(rpn_snn, det_snn, one_box):
    # The heads' trees do not depend on the backbone: the lighter one here.
    kw = dict(num_classes=9, rpn_snn=rpn_snn, detector_snn=det_snn, only_one_bbox=one_box,
              backbone="mobilenet_v3_large_fpn")
    want = {k: v.shape for k, v in flatten_tree(jax.eval_shape(
        lambda: j_factory.init_params(j_factory.DetectorConfig(**kw),
                                      jax.random.PRNGKey(0)))).items()}
    cfg = t_factory.DetectorConfig(**kw)
    got = flatten_tree(t_factory.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert sorted(got) == sorted(want)
    for k, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[k]), k
        assert leaf.dtype == torch.float32 and bool(torch.isfinite(leaf).all()), k
    assert ("box_predictor/bbox_pred/w" in got) == (not det_snn)
    if det_snn:
        assert got["box_head/bbox_pred/w"].shape[1] == (4 if one_box else 36)
    else:
        assert got["box_predictor/bbox_pred/w"].shape[1] == 36
        assert float(got["box_predictor/cls_score/b"].abs().max()) > 0
    if not rpn_snn:
        assert float(got["rpn_head/conv/b"].abs().max()) == 0


def test_create_model_seeds_its_draws():
    kw = dict(backbone="mobilenet_v3_large_fpn", device="cpu")
    _, a = t_factory.create_model("bdd", 5, False, False, seed=3, **kw)
    _, b = t_factory.create_model("bdd", 5, False, False, seed=3, **kw)
    _, c = t_factory.create_model("bdd", 5, False, False, seed=4, **kw)
    fa, fb, fc = flatten_tree(a), flatten_tree(b), flatten_tree(c)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert not torch.equal(fa["box_head/fc6/w"], fc["box_head/fc6/w"])
    assert all(v.device.type == "cpu" for v in fa.values())
