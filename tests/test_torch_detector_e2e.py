"""Port vs JAX, end to end: ``detector_apply`` eval of the whole slice.

Setup of tests/test_parity_e2e.py: 128x256 bucket, T_rpn = T_det = 6,
5 classes, pre/post-NMS 100/50, 30 detections per image, float32, weights
scaled so that every spiking layer fires at realistic rates and the class
scores are well separated. Both stacks get the same weights (the JAX
``init_params`` tree, scaled in numpy, through ``utils/weights.py``) and
the same numpy images. In float32 both stacks run the reference's own
scans (step encoder, LI readout at every step) and the gather RoIAlign:
the port launches no kernel and runs no kernel's plain version.

Tolerances are test_parity_e2e.py:148-277's: detection scores 1e-4,
boxes 1e-3 relative / 5e-2 absolute, labels exact; pre-NMS scores 1e-4 /
1e-5, proposals 1e-3 / 5e-2; spike rates 1e-3. In float32 the stacks
differ by summation order and by ulps of exp/log/sigmoid/softmax, and that
moves a few borderline values: an encoder input across a period threshold,
a membrane across the LIF threshold, a near-saturated class score past
another in the NMS order. Each comparison therefore counts (and prints)
the elements outside its tolerance and bounds them: RPN rates all within;
per-image box-head mean rates all within, at most 15% of RoIs outside;
at most 5% of pre-NMS scores and coordinates outside; over all images, FG
detection counts within 10% and at least 90% of each side's detections
matched (label, score, box) on the other side. The default cap of 100
detections per image keeps the cap itself from trading near-equal scores.

Those borderline values all come from the backbone: its features differ
by float32 ulps (a few 1e-6 relative) between XLA's and PyTorch's
convolutions. So the port also runs once on the JAX backbone's own
features, and from there on every output must agree element by element at
the same tolerances, with no outlier allowed and spike rates to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models.detector import detector_apply as j_apply
from snn_automotive_object_detection_tpu.models import resnet_fpn as j_resnet
from snn_automotive_object_detection_tpu.models import transform as j_transform
from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
from snn_automotive_object_detection_tpu.models.factory import init_params as j_init
from snn_automotive_object_detection_tpu.models.roi_heads import RoIConfig as JRoI
from snn_automotive_object_detection_tpu.models.rpn import RPNConfig as JRPN
from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree

T_STEPS = 6
IMG = (128, 256)
N_IMAGES = 3
MEAN, STD = (0.2869, 0.3251, 0.2839), (0.1870, 0.1902, 0.1872)


def _scaled_params(cfg):
    return _scale(jax.tree.map(lambda a: np.array(a, np.float32),
                               j_init(cfg, jax.random.PRNGKey(0))))


def _scale(p):
    """Seeded frozen-BN affines and gains on the FPN outputs and the heads,
    so that every spiking layer fires; ``p`` is a numpy tree, changed in
    place and returned."""
    rng = np.random.default_rng(0)

    def bn(tree):
        if isinstance(tree, dict):
            if "bn" in tree:
                c = tree["bn"]["scale"].shape[0]
                tree["bn"]["scale"] = rng.uniform(0.75, 1.3, c).astype(np.float32)
                tree["bn"]["bias"] = rng.normal(0, 0.05, c).astype(np.float32)
            for v in tree.values():
                bn(v)
        elif isinstance(tree, list):
            for v in tree:
                bn(v)

    bn(p["backbone"])
    for layer in p["backbone"]["fpn"]["layer"]:
        layer["w"] *= 8.0
    p["rpn_head"]["shared_conv"]["w"] *= 6.0
    p["rpn_head"]["conv_cls"]["w"] *= 6.0
    p["rpn_head"]["conv_bbox"]["w"] *= 2.0
    for k, s in (("fc6", 2.0), ("fc7", 2.0), ("cls_score", 60.0), ("bbox_pred", 0.5)):
        p["box_head"][k]["w"] *= s
    return p


def _run_both():
    jcfg = JConfig(
        num_classes=5, t_rpn=T_STEPS, t_det=T_STEPS, min_size=IMG[0],
        max_size=IMG[1], image_mean=MEAN, image_std=STD,
        rpn=JRPN(pre_nms_top_n_test=100, post_nms_top_n_test=50),
        roi=JRoI(detections_per_img=100), compute_dtype=jnp.float32)
    tcfg = DetectorConfig(
        num_classes=5, t_rpn=T_STEPS, t_det=T_STEPS, min_size=IMG[0],
        max_size=IMG[1], image_mean=MEAN, image_std=STD,
        rpn=RPNConfig(pre_nms_top_n_test=100, post_nms_top_n_test=50),
        roi=RoIConfig(detections_per_img=100), compute_dtype=torch.float32)
    params = _scaled_params(jcfg)
    images = np.random.default_rng(7).uniform(0, 1, (N_IMAGES, *IMG, 3)).astype(np.float32)
    sizes = np.asarray([IMG] * N_IMAGES, np.int32)
    orig = np.asarray([[256, 512]] * N_IMAGES, np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    jdet, _ = j_apply(jparams,
                      {"images": jnp.asarray(images), "image_sizes": jnp.asarray(sizes),
                       "original_sizes": jnp.asarray(orig)},
                      jcfg, training=False, collect_rates=True)
    jdet = jax.tree.map(np.asarray, jdet)
    tparams = from_numpy_tree(params, device="cpu")
    tbatch = {"images": torch.from_numpy(images), "image_sizes": torch.from_numpy(sizes),
              "original_sizes": torch.from_numpy(orig)}
    tdet, _ = detector_apply(tparams, tbatch, tcfg, collect_rates=True)

    # The same port run on the JAX backbone's features.
    jfeats = j_resnet.resnet50_fpn_apply(
        jparams["backbone"], j_transform.normalize_images(jnp.asarray(images), MEAN, STD),
        jnp.float32)
    tfeats = [torch.from_numpy(np.array(f)) for f in jfeats]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_detector, "resnet50_fpn_apply", lambda *args: tfeats)
        tdet_shared, _ = detector_apply(tparams, tbatch, tcfg, collect_rates=True)
    return jdet, _to_numpy(tdet), _to_numpy(tdet_shared)


def _to_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def both():
    return _run_both()


def test_output_shapes_match(both):
    jdet, tdet, _ = both
    for k in ("boxes", "scores", "labels", "valid", "proposals", "objectness",
              "all_scores", "all_boxes"):
        assert tdet[k].shape == jdet[k].shape, k


def _matches(a, b):
    """Detections in ``a`` with a partner in ``b``: same label, score within
    1e-4 (+1e-4 relative), every box coordinate within 5e-2 (+1e-3
    relative). Each detection of ``b`` is used once."""
    used = np.zeros(len(b[0]), bool)
    hits = 0
    for box, score, label in zip(*a):
        ok = ((b[2] == label) & ~used
              & (np.abs(b[1] - score) <= 1e-4 + 1e-4 * np.abs(score))
              & (np.abs(b[0] - box) <= 5e-2 + 1e-3 * np.abs(box)).all(axis=1))
        if ok.any():
            used[np.argmax(ok)] = True
            hits += 1
    return hits


def _fg(det, i):
    v = det["valid"][i] & (det["labels"][i] > 0)
    return det["boxes"][i][v], det["scores"][i][v], det["labels"][i][v]


def test_final_detections_match(both):
    jdet, tdet, _ = both
    n_w = n_g = hit_w = hit_g = 0
    for i in range(N_IMAGES):
        want, got = _fg(jdet, i), _fg(tdet, i)
        hw, hg = _matches(want, got), _matches(got, want)
        print(f"image {i}: {len(got[1])} port vs {len(want[1])} JAX FG "
              f"detections; matched {hg} / {hw}")
        n_w, n_g, hit_w, hit_g = n_w + len(want[1]), n_g + len(got[1]), \
            hit_w + hw, hit_g + hg
    assert n_w >= 20, f"only {n_w} detections"
    assert abs(n_g - n_w) <= 0.1 * n_w
    assert hit_w >= 0.9 * n_w and hit_g >= 0.9 * n_g


def _mismatches(got, want, rtol, atol):
    return int((np.abs(got - want) > atol + rtol * np.abs(want)).sum())


def test_pre_nms_proposals_match(both):
    jdet, tdet, _ = both
    level_hw = [(32, 64), (16, 32), (8, 16), (4, 8), (2, 4)]
    counts = [min(100, h * w * 3) for h, w in level_hw]
    bad_s = bad_p = 0
    for i in range(N_IMAGES):
        off = 0
        for cnt in counts:
            gs, ws = tdet["objectness"][i, off:off + cnt], jdet["objectness"][i, off:off + cnt]
            gp, wp = tdet["proposals"][i, off:off + cnt], jdet["proposals"][i, off:off + cnt]
            go, wo = np.argsort(-gs, kind="stable"), np.argsort(-ws, kind="stable")
            bad_s += _mismatches(gs[go], ws[wo], 1e-4, 1e-5)
            bad_p += _mismatches(gp[go], wp[wo], 1e-3, 5e-2)
            off += cnt
    n = N_IMAGES * sum(counts)
    print(f"pre-NMS: {bad_s} of {n} scores and {bad_p} of {4 * n} box "
          f"coordinates outside tolerance")
    assert bad_s <= 0.05 * n and bad_p <= 0.05 * 4 * n


def test_spike_rates_match(both):
    jdet, tdet, _ = both
    for key in ("encoder", "shared"):
        assert tdet["rpn_rates"][key].shape == (5, N_IMAGES)
        np.testing.assert_allclose(tdet["rpn_rates"][key], jdet["rpn_rates"][key],
                                   atol=1e-3)
    p = tdet["det_rates"]["fc6"].shape[0] // N_IMAGES
    for key in ("encoder", "fc6", "fc7"):
        got = tdet["det_rates"][key].reshape(N_IMAGES, p)
        want = jdet["det_rates"][key].reshape(N_IMAGES, p)
        np.testing.assert_allclose(got.mean(axis=1), want.mean(axis=1), atol=1e-3)
        bad = _mismatches(got, want, 0.0, 1e-3)
        print(f"box head {key}: {bad} of {got.size} RoIs outside 1e-3")
        assert bad <= 0.15 * got.size
    print("rates: RPN shared", tdet["rpn_rates"]["shared"].mean(axis=1),
          "box head", {k: float(v.mean()) for k, v in tdet["det_rates"].items()})
    assert tdet["rpn_rates"]["shared"].max() > 0.05
    assert tdet["det_rates"]["fc6"].mean() > 0.02


def test_outputs_exact_on_shared_backbone_features(both):
    """From identical backbone features on, the port is the JAX path up to
    summation order: every element within the tolerances above."""
    jdet, _, tdet = both
    np.testing.assert_array_equal(tdet["valid"], jdet["valid"])
    np.testing.assert_array_equal(tdet["labels"], jdet["labels"])
    for k in ("scores", "objectness", "all_scores"):
        np.testing.assert_allclose(tdet[k], jdet[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("boxes", "proposals", "all_boxes"):
        np.testing.assert_allclose(tdet[k], jdet[k], rtol=1e-3, atol=5e-2, err_msg=k)
    for group in ("rpn_rates", "det_rates"):
        for k, v in jdet[group].items():
            np.testing.assert_allclose(tdet[group][k], v, atol=1e-6, err_msg=k)
    assert (jdet["valid"] & (jdet["labels"] > 0)).sum() >= 20
