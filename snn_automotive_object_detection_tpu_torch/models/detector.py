"""Detector assembly, eval path: backbone -> RPN -> RoI heads -> outputs.

Port of ``snn_automotive_object_detection_tpu/models/detector.py``
(``detector_apply`` with training=False; reference generalized_rcnn.py and
faster_rcnn.py at inference): normalise, frozen ResNet-50-FPN (5 levels),
spiking RPN over all levels, RoIAlign and the spiking box head over levels
0-3, open-set postprocess; detections, pre-NMS proposals and ``all_boxes``
are rescaled to the original image sizes.

On a CUDA device the four spiking-core stages run as hand-written kernels
(K1 RPN head, K2 RoIAlign, K3 encoder+fc6, K4 box tail); on the CPU they
run as the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from snn_automotive_object_detection_tpu_torch.models import heads
from snn_automotive_object_detection_tpu_torch.models import roi_heads as roi_mod
from snn_automotive_object_detection_tpu_torch.models import rpn as rpn_mod
from snn_automotive_object_detection_tpu_torch.models.resnet_fpn import (
    resnet50_fpn_apply,
)
from snn_automotive_object_detection_tpu_torch.models.transform import (
    normalize_images,
    rescale_boxes,
)
from snn_automotive_object_detection_tpu_torch.ops.anchors import generate_anchors


@functools.lru_cache(maxsize=8)
def _anchors(shapes, image_size, spec, device):
    """All levels' anchors on ``device`` and the per-level counts, built
    once per bucket: a host-to-device copy synchronises the stream."""
    with torch.inference_mode(False):
        levels = generate_anchors(shapes, image_size, spec, device=device)
        return torch.cat(levels, dim=0), tuple(a.shape[0] for a in levels)


@torch.inference_mode()
def detector_apply(params: Dict, batch: Dict[str, torch.Tensor], config,
                   collect_rates: bool = False) -> Dict[str, torch.Tensor]:
    """Run the detector on one bucketed batch.

    batch: images [N, Hb, Wb, 3] float in [0, 1]; image_sizes [N, 2] valid
    (h, w) after resize; original_sizes [N, 2] (h, w) before resize.

    Returns boxes/scores/labels/valid [N, D + P, ...] (D FG detections,
    then P BG slots), proposals [N, S, 4] and objectness [N, S] (pre-NMS),
    all_scores [N, P, C], all_boxes [N, P, C, 4], and with collect_rates
    rpn_rates {"encoder", "shared": [L, N]} and det_rates {"encoder",
    "fc6", "fc7": [N * P]}.
    """
    images = batch["images"]
    cd = config.compute_dtype
    _, hb, wb, _ = images.shape
    x = normalize_images(images, config.image_mean, config.image_std)
    feats = resnet50_fpn_apply(params["backbone"], x, cd)

    shapes = tuple((f.shape[1], f.shape[2]) for f in feats)
    anchors, anchor_counts = _anchors(shapes, (hb, wb), config.anchor_spec,
                                      images.device)

    def rpn_head_apply(features):
        return heads.rpn_head_snn_apply(params["rpn_head"], features,
                                        config.t_rpn, collect_rates, cd)

    def box_head_apply(flat):
        return heads.fastrcnn_snn_apply(params["box_head"], flat, config.t_det,
                                        collect_rates, cd)

    img_sizes = batch["image_sizes"]
    orig_sizes = batch["original_sizes"]
    proposals = rpn_mod.rpn_forward(
        rpn_head_apply, feats, anchors, anchor_counts, img_sizes, config.rpn)
    det = roi_mod.roi_heads_forward(
        box_head_apply, feats[:-1], proposals["boxes"], proposals["valid"],
        img_sizes, (hb, wb), config.roi)

    out = {
        "boxes": rescale_boxes(det["boxes"], img_sizes, orig_sizes),
        "scores": det["scores"],
        "labels": det["labels"],
        "valid": det["valid"],
        "proposals": rescale_boxes(proposals["pre_nms_proposals"], img_sizes,
                                   orig_sizes),
        "objectness": proposals["pre_nms_objectness"],
        "all_scores": det["all_scores"],
        "all_boxes": rescale_boxes(det["all_boxes"], img_sizes, orig_sizes),
    }
    if collect_rates:
        out["rpn_rates"] = proposals["rates"]
        out["det_rates"] = det["rates"]
    return out
