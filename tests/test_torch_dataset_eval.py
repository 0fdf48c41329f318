"""Port vs JAX: a dataset evaluated to COCO stats, end to end on the CPU.

The images of the mini COCO set of ``tests/mini_dataset.py`` (4 images of
128x256, the 64x128 bucket) go through each stack's own pipeline: the
loader, the detector's float32 evaluation (``detector_apply``; the port's
batch moved by ``to_device_batch``) and the COCO evaluator, with the same
weights (the JAX ``init_params`` tree scaled as
tests/test_torch_detector_e2e.py scales it, so that every spiking layer
fires) and a score threshold of 0.01 so that each image keeps many
detections. Random weights find none of the set's own boxes, so the ground
truth is put on the JAX pipeline's three best detections per image: the
stats then measure how closely the port's detections follow.

In float32 the two detectors differ by summation order and ulps of
exp/log (tests/test_torch_detector_e2e.py): a borderline value can move a
detection, so the stats are held to 0.01 absolute of the JAX pipeline's; the
loaders' batches are equal (tests/test_torch_data.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.data.coco import CocoDataset as JCoco
from snn_automotive_object_detection_tpu.data.loader import DetectionLoader as JLoader
from snn_automotive_object_detection_tpu.evaluation.evaluator import (
    CocoEvaluator as JEvaluator,
)
from snn_automotive_object_detection_tpu.models.detector import detector_apply as j_apply
from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
from snn_automotive_object_detection_tpu.models.roi_heads import RoIConfig as JRoI
from snn_automotive_object_detection_tpu.models.rpn import RPNConfig as JRPN
from snn_automotive_object_detection_tpu_torch.data import DetectionLoader, to_device_batch
from snn_automotive_object_detection_tpu_torch.data.coco import CocoDataset
from snn_automotive_object_detection_tpu_torch.evaluation import CocoEvaluator
from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.config import load_dataset_config
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree
from tests.mini_dataset import make_mini_env
from tests.test_torch_detector_e2e import MEAN, STD, _scaled_params

BUCKET = (64, 128)
BATCH = 4           # one detector call per stack: each JAX compile costs 25 s
KEYS = ("boxes", "scores", "labels", "valid")


def _configs():
    common = dict(num_classes=4, t_rpn=3, t_det=3, min_size=BUCKET[0], max_size=BUCKET[1],
                  image_mean=MEAN, image_std=STD)
    jcfg = JConfig(**common, rpn=JRPN(pre_nms_top_n_test=60, post_nms_top_n_test=30),
                   roi=JRoI(score_thresh=0.01, detections_per_img=50),
                   compute_dtype=jnp.float32)
    tcfg = DetectorConfig(**common, rpn=RPNConfig(pre_nms_top_n_test=60,
                                                  post_nms_top_n_test=30),
                          roi=RoIConfig(score_thresh=0.01, detections_per_img=50),
                          compute_dtype=torch.float32)
    return jcfg, tcfg


def _gt_from(dets, coco, per_image=3):
    """``coco`` with its annotations replaced by each image's ``per_image``
    best-scoring foreground detections of ``dets``, so that the stats
    depend on where the detections lie."""
    anns = []
    for img in coco["images"]:
        d = dets[img["id"]]
        fg = np.nonzero(np.asarray(d["valid"]) & (np.asarray(d["labels"]) > 0))[0]
        for i in fg[np.argsort(-np.asarray(d["scores"])[fg], kind="stable")][:per_image]:
            x1, y1, x2, y2 = (float(v) for v in d["boxes"][i])
            anns.append({"id": len(anns) + 1, "image_id": img["id"],
                         "bbox": [x1, y1, x2 - x1, y2 - y1], "area": (x2 - x1) * (y2 - y1),
                         "category_id": int(d["labels"][i]), "iscrowd": 0})
    return {**coco, "annotations": anns}


@pytest.fixture(scope="module")
def stats(tmp_path_factory):
    _, ds_yaml, _ = make_mini_env(tmp_path_factory.mktemp("eval"), seed=1, n_images=4)
    cfg = load_dataset_config(ds_yaml)
    jcfg, tcfg = _configs()
    params = _scaled_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = from_numpy_tree(params, device="cpu")
    kw = dict(min_size=BUCKET[0], max_size=BUCKET[1], with_targets=False, num_workers=2)

    # The JAX pipeline's detections; the ground truth is then placed on
    # some of them.
    jdets = {}
    for b in JLoader(JCoco(cfg["images_dir"], cfg["ann_file_val"]), BATCH, BUCKET, **kw):
        det = jax.tree.map(np.asarray, j_apply(
            jparams, {k: jnp.asarray(b[k]) for k in ("images", "image_sizes",
                                                     "original_sizes")},
            jcfg, training=False)[0])
        jdets.update({int(b["image_ids"][i]): {k: det[k][i] for k in KEYS}
                      for i in range(BATCH) if b["pad_mask"][i]})
    with open(cfg["ann_file_val"]) as f:
        coco = _gt_from(jdets, json.load(f))
    jds = JCoco(cfg["images_dir"], coco)
    want = _score(JEvaluator(jds), jdets)

    ds = CocoDataset(cfg["images_dir"], coco)
    tdets = {}
    cb.reset_counts()
    for b in DetectionLoader(ds, BATCH, BUCKET, **kw):
        det = detector_apply(tparams, to_device_batch(b, "cpu"), tcfg)[0]
        tdets.update({int(b["image_ids"][i]): {k: det[k][i] for k in KEYS}
                      for i in range(BATCH) if b["pad_mask"][i]})
    got = _score(CocoEvaluator(ds), tdets)
    n = [sum(int(np.sum(np.asarray(d["valid"]))) for d in x.values()) for x in (tdets, jdets)]
    return got, want, n[0], n[1], len(coco["annotations"]), dict(cb.LAUNCHES)


def _score(evaluator, dets):
    evaluator.update(dets)
    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    return np.asarray(evaluator.summarize(verbose=False))


def test_dataset_stats_match_jax(stats):
    got, want, t_n, j_n, n_gt, launches = stats
    print(f"port {got.round(4).tolist()}\nJAX  {want.round(4).tolist()}\n"
          f"detections port {t_n} JAX {j_n}, GT boxes {n_gt}")
    assert got.shape == want.shape == (12,) and n_gt >= 4
    assert np.isfinite(got).all() and want[0] > 0.2
    np.testing.assert_allclose(got, want, atol=0.01, rtol=0)
    assert abs(t_n - j_n) <= 0.1 * j_n
    assert all(v == 0 for v in launches.values())
