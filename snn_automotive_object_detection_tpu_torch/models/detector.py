"""Detector assembly: backbone -> RPN -> RoI heads -> outputs or losses.

Port of ``snn_automotive_object_detection_tpu/models/detector.py``
(reference generalized_rcnn.py and faster_rcnn.py): normalise, frozen
backbone (ResNet-50-FPN, 5 levels, or MobileNetV3-Large-FPN, 3 levels),
spiking RPN over all levels, RoIAlign and the spiking box head over all
levels but the pool level. At inference the open-set postprocess
follows; detections, pre-NMS proposals and ``all_boxes`` are rescaled to
the original image sizes. In training the four losses come back instead.

With bf16 on a CUDA device the four spiking-core stages run as
hand-written kernels (K1 RPN head, or K8 pair by pair when no rates are
collected and ``snn/cuda_rpn.PAIR_IMAGES`` is on; K2 RoIAlign, K3
encoder+fc6, K4 box tail); on the CPU they run as the kernels' plain
PyTorch versions. With float32 they run as the reference's own scans and
the gather RoIAlign, on either device, and launch no kernel. With bf16
neuron states (``snn_state_dtype=None``) the RPN head is K1's (or K8's)
instance for bf16 states and the box tail a scan with bf16 states after
K3. ANN heads
(``rpn_snn``/``detector_snn`` off) are plain convolutions and linears;
the ANN box head takes the standard postprocess, the spiking one the
open-set postprocess (:func:`make_head_applies` states the whole rule).

The compute dtype picks the backbone's route, by the reference's rule (its
bf16 runs take the fused kernels, its float32 runs keep the unfused chain):
with bf16 the raw image goes through the fused stem (K6, normalisation
folded in) and the levels through the fused FPN (K5), kernels on a CUDA
device and plain versions on the CPU; with float32 the image is normalised
and takes the unfused chain on either device. The fused stem and FPN are
ResNet's: a MobileNet backbone is normalised and runs unfused in either
dtype, as in the reference.

In training the route changes with what needs a gradient (see
:func:`make_head_applies` and ``_detector_apply``): the fused stem serves
while the stem is frozen, the FPN runs unfused, the RPN head is K1's
training instance with K7 as its backward while the backbone is frozen
(their bf16-state instances with bf16 neuron states), RoIAlign is the
gather version, and the box head K3's training instance with the
spike-code weight-gradient kernel as its backward, then the tail as a scan
under autograd, while the backbone is frozen and the states are float32;
otherwise the box head is the scan under autograd.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from snn_automotive_object_detection_tpu_torch.models import heads
from snn_automotive_object_detection_tpu_torch.models import roi_heads as roi_mod
from snn_automotive_object_detection_tpu_torch.models import rpn as rpn_mod
from snn_automotive_object_detection_tpu_torch.models.mobilenet_fpn import (
    mobilenet_v3_fpn_apply,
)
from snn_automotive_object_detection_tpu_torch.models.resnet_fpn import (
    resnet50_fpn_apply,
    resnet50_fpn_apply_from_p1,
)
from snn_automotive_object_detection_tpu_torch.models.transform import (
    normalize_images,
    rescale_boxes,
)
from snn_automotive_object_detection_tpu_torch.ops.anchors import generate_anchors
from snn_automotive_object_detection_tpu_torch.ops.cuda_stem import stem_apply
from snn_automotive_object_detection_tpu_torch.snn.cuda_fc6 import MAX_T as BOX_KERNEL_MAX_T
from snn_automotive_object_detection_tpu_torch.utils.spans import span


@functools.lru_cache(maxsize=8)
def _anchors(shapes, image_size, spec, device):
    """All levels' anchors on ``device`` and the per-level counts, built
    once per bucket: a host-to-device copy synchronises the stream."""
    with torch.inference_mode(False):
        levels = generate_anchors(shapes, image_size, spec, device=device)
        return torch.cat(levels, dim=0), tuple(a.shape[0] for a in levels)


def make_head_applies(config, params, collect_rates: bool, training: bool = False):
    """The RPN head's and the box head's apply functions for this call.

    The device, the dtype, the head switches, the state dtype, ``training``
    and the trainable backbone stages pick the route; there is no flag.

    ANN heads (``rpn_snn`` / ``detector_snn`` off) are convolutions and
    linears with biases on either device (the JAX package leaves them to
    XLA). For the spiking heads the kernels take bf16 only, as the
    reference gates its own on bf16:

      * float32 compute: the reference's scans (step encoder, LI readout at
        every step), on either device, in every mode.
      * bf16 with float32 states (the default), outside training: the RPN
        head on K1 (K8 where the pairing switch pairs a level), the box
        head on K3 then K4.
      * bf16 states (``snn_state_dtype=None``), outside training: the RPN
        head on K1's instance for bf16 states (K8's where the pairing switch
        pairs a level), the box head on K3 then :func:`heads.box_tail_scan`
        with bf16 states, as the reference runs its kernels there.
      * training: the RPN head is K1's training instance with K7 as its
        backward for bf16 compute, a frozen backbone (that gradient is for
        the weights only) and no rate collection, their bf16-state
        instances with bf16 states, as the reference takes its training VJP
        with either state dtype; otherwise the scan. The box head is K3's
        training instance with the spike-code weight-gradient kernel as its
        backward, then the tail as a scan under autograd
        (:func:`heads.fastrcnn_snn_train_apply`), for bf16 compute, float32
        states, features that need no gradient (a frozen backbone), no rate
        collection and ``t_det`` <= 32; otherwise the scan under autograd
        (bf16 states keep it: the JAX package's training encoder then
        carries a bf16 membrane).

    A box head of more steps than K3 and K4 take (``t_det`` > 32) is the
    scan on either device, as the reference's gate sends such a ``t_det`` to
    its XLA scan. ``RoIAlign`` is chosen by the features' dtype alone
    (``roi_heads.roi_heads_forward``).
    """
    cd, sd = config.compute_dtype, config.state_dtype
    kernels = cd == torch.bfloat16
    state16 = sd == torch.bfloat16
    kernel_rpn_train = (kernels and not collect_rates
                        and config.backbone_trainable_stages == 0)

    def rpn_head_apply(features):
        if not config.rpn_snn:
            return heads.rpn_head_ann_apply(params["rpn_head"], features, cd)
        if not training and kernels:
            return heads.rpn_head_snn_apply(params["rpn_head"], features,
                                            config.t_rpn, collect_rates, cd, state16)
        if training and kernel_rpn_train:
            return heads.rpn_head_snn_train_apply(params["rpn_head"], features,
                                                  config.t_rpn, cd, state16)
        return heads.rpn_head_snn_scan_apply(params["rpn_head"], features,
                                             config.t_rpn, collect_rates, cd,
                                             state_dtype=sd)

    def box_head_apply(flat):
        if not config.detector_snn:
            rep = heads.two_mlp_head_apply(params["box_head"], flat, cd)
            cls, reg = heads.fastrcnn_predictor_apply(params["box_predictor"], rep)
            return cls, reg, None
        if kernels and config.t_det <= BOX_KERNEL_MAX_T:
            if not training:
                return heads.fastrcnn_snn_apply(params["box_head"], flat, config.t_det,
                                                collect_rates, cd, sd)
            if sd == torch.float32 and not flat.requires_grad and not collect_rates:
                return heads.fastrcnn_snn_train_apply(params["box_head"], flat,
                                                      config.t_det, cd)
        return heads.fastrcnn_snn_scan_apply(params["box_head"], flat, config.t_det,
                                             collect_rates, cd, state_dtype=sd)

    return rpn_head_apply, box_head_apply


def detector_apply(params: Dict, batch: Dict[str, torch.Tensor], config,
                   training: bool = False,
                   generator: Optional[torch.Generator] = None,
                   collect_rates: bool = False, draws: Optional[Dict] = None):
    """Run the detector on one bucketed batch.

    batch: images [N, Hb, Wb, 3] float in [0, 1]; image_sizes [N, 2] valid
    (h, w) after resize; original_sizes [N, 2] (h, w) before resize; in
    training also targets {"boxes" [N, G, 4] in resized coordinates,
    "labels" [N, G], "valid" [N, G]}. The samplers draw from ``generator``
    (on the batch's device), or take the uniform draws given as ``draws`` =
    {"rpn": (rp, rn), "roi": (rp, rn, r_pack)}.

    Returns (detections, losses). Outside training, under inference mode:
    boxes/scores/labels/valid [N, D + P, ...] (D FG detections, then P BG
    slots), proposals [N, S, 4] and objectness [N, S] (pre-NMS), all_scores
    [N, P, C], all_boxes [N, P, C, 4], with collect_rates rpn_rates
    {"encoder", "shared": [L, N]} and det_rates {"encoder", "fc6", "fc7":
    [N * P]}; losses is empty. The ANN box head (``detector_snn`` off)
    gives D rows of foreground detections and no all_scores or all_boxes,
    an ANN head None for its rates. In training: detections holds the
    rates only (when collected) and losses the four of loss_objectness,
    loss_rpn_box_reg, loss_classifier and loss_box_reg.
    """
    with span("detector"):
        if training:
            return _detector_apply(params, batch, config, True, generator,
                                   collect_rates, draws or {})
        with torch.inference_mode():
            return _detector_apply(params, batch, config, False, None,
                                   collect_rates, {})


def backbone_features(params, images, config, training):
    """The FPN levels of ``images`` [N, Hb, Wb, 3] in the compute dtype, by
    the route the dtype, the backbone and the trainable stages pick."""
    cd = config.compute_dtype
    # Top trainable backbone stages; 0 outside training. The fused stem has
    # no gradient, which is fine while the stem is frozen; the fused FPN is
    # for inference.
    tbl = config.backbone_trainable_stages if training else 0
    if config.backbone != "resnet50_fpn":
        x = normalize_images(images, config.image_mean, config.image_std)
        feats = mobilenet_v3_fpn_apply(params["backbone"], x, cd)
    elif cd == torch.bfloat16 and tbl < 5:
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        p1 = stem_apply(params["backbone"]["stem"], images, config.image_mean,
                        config.image_std)
        feats = resnet50_fpn_apply_from_p1(params["backbone"], p1, tbl,
                                           fused_fpn=not training)
    else:
        x = normalize_images(images, config.image_mean, config.image_std)
        feats = resnet50_fpn_apply(params["backbone"], x, cd, tbl, not training)
    # With no trainable stage the whole backbone, FPN included, is frozen.
    if not (training and tbl > 0):
        feats = [f.detach() for f in feats]
    return feats


def _detector_apply(params, batch, config, training, generator, collect_rates,
                    draws):
    images = batch["images"]
    _, hb, wb, _ = images.shape
    with span("detector.backbone"):
        feats = backbone_features(params, images, config, training)

    shapes = tuple((f.shape[1], f.shape[2]) for f in feats)
    anchors, anchor_counts = _anchors(shapes, (hb, wb), config.anchor_spec,
                                      images.device)
    rpn_head_apply, box_head_apply = make_head_applies(config, params,
                                                       collect_rates, training)

    img_sizes = batch["image_sizes"]
    proposals, rpn_losses = rpn_mod.rpn_forward(
        rpn_head_apply, feats, anchors, anchor_counts, img_sizes, config.rpn,
        training, batch.get("targets"), generator, draws.get("rpn"))
    det, roi_losses = roi_mod.roi_heads_forward(
        box_head_apply, feats[:-1], proposals["boxes"], proposals["valid"],
        img_sizes, (hb, wb), config.roi, training, batch.get("targets"),
        generator, draws.get("roi"), open_set=config.detector_snn)
    losses = {**rpn_losses, **roi_losses}

    if training:
        out = {}
        if collect_rates:
            out["rpn_rates"] = proposals["rates"]
            out["det_rates"] = det["rates"]
        return out, losses

    orig_sizes = batch["original_sizes"]
    with span("detector.outputs"):
        out = {
            "boxes": rescale_boxes(det["boxes"], img_sizes, orig_sizes),
            "scores": det["scores"],
            "labels": det["labels"],
            "valid": det["valid"],
            "proposals": rescale_boxes(proposals["pre_nms_proposals"], img_sizes,
                                       orig_sizes),
            "objectness": proposals["pre_nms_objectness"],
        }
        # The ANN detector's postprocess has no per-class pre-NMS outputs,
        # and its heads no rates: the keys are left out, or None, as the JAX
        # package's det.get gives them.
        if "all_boxes" in det:
            out["all_scores"] = det["all_scores"]
            out["all_boxes"] = rescale_boxes(det["all_boxes"], img_sizes, orig_sizes)
    if collect_rates:
        out["rpn_rates"] = proposals["rates"]
        out["det_rates"] = det["rates"]
    return out, losses
