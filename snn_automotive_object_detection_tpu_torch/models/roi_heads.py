"""RoI heads of the spiking (open-set) detector: training-sample selection
and loss, and the eval postprocess.

Port of ``snn_automotive_object_detection_tpu/models/roi_heads.py``
(reference roi_heads.py:496-1347). Training: the ground truth is appended
to the proposals, matched at 0.5/0.5 without low-quality matches, 512 per
image are sampled at 25% positive, RoIAlign runs as the gather version
(``ops/roi_align.py``), and the loss is cross-entropy plus smooth-L1
(beta 1/9) over the sampled count. Eval: RoIAlign 7x7 over FPN levels 0-3
(kernel K2 on bf16 maps, the gather version on float32 ones, as the
reference gates its kernel), the box head, then the open-set postprocess.
Foreground boxes (classes >= 1) are score-thresholded, small-filtered, NMS'd per class and capped at detections_per_img;
background (class-0) boxes of proposals that no above-threshold foreground
prediction claimed survive their own NMS and are all kept. The pre-NMS
per-class scores and boxes go out for new-object discovery. All tensors
are batched over images; fixed capacities with validity masks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from snn_automotive_object_detection_tpu_torch.ops import boxes as box_ops
from snn_automotive_object_detection_tpu_torch.ops import nms as nms_ops
from snn_automotive_object_detection_tpu_torch.models.rpn import smooth_l1
from snn_automotive_object_detection_tpu_torch.ops.cuda_roi_align import roi_align
from snn_automotive_object_detection_tpu_torch.ops.matcher import match_boxes
from snn_automotive_object_detection_tpu_torch.ops.roi_align import multiscale_roi_align
from snn_automotive_object_detection_tpu_torch.ops.sampler import (
    balanced_sample_from_draws,
)
from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

# Per-class NMS over the top-K rows when no foreground class has more than
# K valid rows (exact: greedy NMS only looks at valid rows); otherwise the
# whole batch takes the full path.
PRUNED_NMS_K = 128


@dataclasses.dataclass(frozen=True)
class RoIConfig:
    """Hyperparameters from the reference's model.py:94-106."""

    score_thresh: float = 0.4
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    fg_iou_thresh: float = 0.5
    bg_iou_thresh: float = 0.5
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    min_size: float = 1e-2


def select_training_samples(proposals: torch.Tensor, prop_valid: torch.Tensor,
                            gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                            gt_valid: torch.Tensor, cfg: RoIConfig,
                            generator: Optional[torch.Generator] = None,
                            draws=None):
    """Proposal sampling (reference roi_heads.py:1037-1073), batched.

    proposals [N, P, 4]; prop_valid [N, P]; gt_boxes [N, G, 4]; gt_labels
    [N, G] int; gt_valid [N, G]. The uniform draws, each [N, P + G], come
    from ``generator`` or are given as ``draws`` = (rp, rn, r_pack): the
    sampler's two and the one that orders the packed slots. Returns the
    sampled set of S = batch_size_per_image slots per image, positives
    first: boxes [N, S, 4], labels [N, S] (0 background), regression targets
    [N, S, 4], valid [N, S].
    """
    s = cfg.batch_size_per_image
    all_boxes = torch.cat([proposals, gt_boxes], dim=1)
    all_valid = torch.cat([prop_valid, gt_valid], dim=1)
    if draws is None:
        draws = tuple(torch.rand(all_valid.shape, generator=generator,
                                 device=all_valid.device) for _ in range(3))
    rp, rn, r_pack = draws

    quality = box_ops.box_iou(gt_boxes, all_boxes)
    quality = torch.where(all_valid[:, None, :], quality, -1.0)
    matched = match_boxes(quality, gt_valid, cfg.fg_iou_thresh,
                          cfg.bg_iou_thresh, allow_low_quality_matches=False)
    # Foreground: the matched label; below the low threshold: background;
    # between the thresholds: ignored (none when the two are equal).
    safe_idx = matched.clamp(min=0)
    labels = torch.where(matched >= 0, torch.gather(gt_labels, 1, safe_idx), 0)
    ignore = matched == -2
    positive = (labels > 0) & all_valid & ~ignore
    negative = (labels == 0) & all_valid & ~ignore
    pos_m, neg_m = balanced_sample_from_draws(positive, negative, rp, rn, s,
                                              cfg.positive_fraction)

    # Pack the sampled rows into S slots: positives first, then negatives.
    sel_key = torch.where(pos_m, 2.0 + r_pack,
                          torch.where(neg_m, 1.0 + r_pack, nms_ops.NEG_INF))
    vals, idx = nms_ops.stable_sort_desc(sel_key)
    vals, idx = vals[:, :s], idx[:, :s]
    sel_valid = vals > nms_ops.NEG_INF

    idx4 = idx[..., None].expand(-1, -1, 4)
    boxes = torch.gather(all_boxes, 1, idx4)
    lab = torch.where(sel_valid, torch.gather(labels, 1, idx), 0)
    matched_boxes = torch.gather(
        gt_boxes, 1, torch.gather(safe_idx, 1, idx)[..., None].expand(-1, -1, 4))
    # Background rows regress to their own box (target 0); slots the sample
    # did not fill get a unit box, since a zero-size box would put NaNs from
    # the encoding's log into the masked loss's gradients.
    unit = device_constant((0.0, 0.0, 1.0, 1.0), boxes.dtype, boxes.device)
    boxes = torch.where(sel_valid[..., None], boxes, unit)
    ref = torch.where(((lab > 0) & sel_valid)[..., None], matched_boxes, boxes)
    reg_targets = box_ops.encode_boxes(ref, boxes, cfg.bbox_reg_weights)
    return boxes, lab, reg_targets, sel_valid


def fastrcnn_loss(class_logits: torch.Tensor, box_regression: torch.Tensor,
                  labels: torch.Tensor, reg_targets: torch.Tensor,
                  valid: torch.Tensor):
    """Classification and box loss (reference roi_heads.py:11-53), masked.
    class_logits [S, C]; box_regression [S, 4C]; labels, valid [S];
    reg_targets [S, 4]. Returns (loss_classifier, loss_box_reg)."""
    num = valid.sum().clamp(min=1)
    logp = torch.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
    loss_cls = (ce * valid).sum() / num

    reg = box_regression.reshape(class_logits.shape[0], -1, 4)
    cls_idx = labels.clamp(0, reg.shape[1] - 1)
    reg_for_label = torch.gather(reg, 1, cls_idx[:, None, None].expand(-1, 1, 4))[:, 0]
    pos = (labels > 0) & valid
    box_l = smooth_l1(reg_for_label - reg_targets, beta=1.0 / 9).sum(dim=-1)
    loss_box = (box_l * pos).sum() / num
    return loss_cls, loss_box


def _postproc_groups(class_logits, box_regression, proposals, prop_valid,
                     image_sizes, cfg: RoIConfig):
    """Softmax, decode and clip, then the G = (C-1) FG + 1 BG NMS groups.

    class_logits [N, P, C]; box_regression [N, P, 4C]; proposals [N, P, 4];
    prop_valid [N, P]; image_sizes [N, 2]. Returns ((gb [N, G, P, 4],
    gs [N, G, P], gv [N, G, P]), inter) with the per-image arrays the
    output stage needs.
    """
    n, p, c = class_logits.shape
    scores = torch.softmax(class_logits, dim=-1)
    boxes = box_ops.decode_boxes(box_regression, proposals, cfg.bbox_reg_weights)
    boxes = box_ops.clip_boxes_to_image(
        boxes.reshape(n, p, c, 4), image_sizes[:, 0, None, None],
        image_sizes[:, 1, None, None])

    all_scores = torch.where(prop_valid[..., None], scores, 0.0)
    all_boxes = torch.where(prop_valid[..., None, None], boxes, 0.0)

    fg_boxes = boxes[:, :, 1:].reshape(n, -1, 4)
    fg_scores = scores[:, :, 1:].reshape(n, -1)
    fg_labels = torch.arange(1, c, device=scores.device).repeat(p)
    fg_prop_valid = prop_valid.repeat_interleave(c - 1, dim=1)
    above = fg_scores > cfg.score_thresh
    fg_valid = above & fg_prop_valid & box_ops.small_box_mask(fg_boxes, cfg.min_size)

    claimed = (above & fg_prop_valid).reshape(n, p, c - 1).any(dim=-1)
    bg_boxes = boxes[:, :, 0]
    bg_scores = scores[:, :, 0]
    bg_valid = prop_valid & ~claimed & box_ops.small_box_mask(bg_boxes, cfg.min_size)

    gb = torch.cat([boxes[:, :, 1:].transpose(1, 2), bg_boxes[:, None]], dim=1)
    gs = torch.cat([scores[:, :, 1:].transpose(1, 2), bg_scores[:, None]], dim=1)
    gv = torch.cat([fg_valid.reshape(n, p, c - 1).transpose(1, 2),
                    bg_valid[:, None]], dim=1)
    inter = {"fg_boxes": fg_boxes, "fg_scores": fg_scores, "fg_labels": fg_labels,
             "bg_boxes": bg_boxes, "bg_scores": bg_scores,
             "all_scores": all_scores, "all_boxes": all_boxes}
    return (gb, gs, gv), inter


def _batched_group_nms(gb, gs, gv, nms_thresh: float):
    """NMS over [N, G, P] groups (FG classes first, BG last). Returns
    (keep [N, G, P], bg_order [N, P]: the BG group's score order)."""
    n, g, p = gs.shape
    k = min(PRUNED_NMS_K, p)
    if k >= p or bool((gv[:, :-1].sum(dim=-1) > k).any()):
        keep, order = nms_ops.nms_mask(gb.reshape(n * g, p, 4), gs.reshape(n * g, p),
                                       gv.reshape(n * g, p), nms_thresh)
        return keep.reshape(n, g, p), order.reshape(n, g, p)[:, -1]
    keep_fg = nms_ops.nms_mask_pruned(
        gb[:, :-1].reshape(-1, p, 4), gs[:, :-1].reshape(-1, p),
        gv[:, :-1].reshape(-1, p), nms_thresh, k).reshape(n, g - 1, p)
    keep_bg, order_bg = nms_ops.nms_mask(gb[:, -1], gs[:, -1], gv[:, -1], nms_thresh)
    return torch.cat([keep_fg, keep_bg[:, None]], dim=1), order_bg


def _postproc_outputs(inter, keep_all, bg_order, cfg: RoIConfig):
    """Top-k after NMS and the fixed-size outputs: D FG detections then P
    BG slots per image."""
    n, g, p = keep_all.shape
    fg_keep = keep_all[:, :g - 1].transpose(1, 2).reshape(n, -1)
    fg_idx, fg_valid = nms_ops.topk_after_nms(inter["fg_scores"], fg_keep,
                                              cfg.detections_per_img)
    bg_idx, bg_valid = nms_ops.select_kept_in_order(bg_order, keep_all[:, g - 1])

    def take(x, idx):
        if x.dim() == 3:
            return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        return torch.gather(x, 1, idx)

    out_boxes = torch.cat([take(inter["fg_boxes"], fg_idx),
                           take(inter["bg_boxes"], bg_idx)], dim=1)
    out_scores = torch.cat([take(inter["fg_scores"], fg_idx),
                            take(inter["bg_scores"], bg_idx)], dim=1)
    out_labels = torch.cat([inter["fg_labels"][fg_idx],
                            torch.zeros_like(bg_idx)], dim=1)
    out_valid = torch.cat([fg_valid, bg_valid], dim=1)
    return {
        "boxes": torch.where(out_valid[..., None], out_boxes, 0.0),
        "scores": torch.where(out_valid, out_scores, 0.0),
        "labels": torch.where(out_valid, out_labels, 0),
        "valid": out_valid,
        "all_scores": inter["all_scores"],
        "all_boxes": inter["all_boxes"],
    }


def roi_heads_forward(box_head_apply: Callable, features, proposals: torch.Tensor,
                      prop_valid: torch.Tensor, image_sizes: torch.Tensor,
                      image_bucket: Tuple[int, int], cfg: RoIConfig,
                      training: bool = False, targets: Optional[Dict] = None,
                      generator: Optional[torch.Generator] = None, draws=None):
    """features: the 4 pooled levels [N, H_l, W_l, C] (not "pool");
    proposals [N, P, 4]. box_head_apply: [N*P, 7*7*C] -> (logits, deltas,
    rates). targets (training): {"boxes", "labels", "valid"}; the sampler
    draws from ``generator`` or takes ``draws`` (see
    :func:`select_training_samples`). Returns (detections dict with
    "rates", losses): in training the dict holds the rates only, outside it
    the losses are empty."""
    n, p, _ = proposals.shape
    if training:
        if targets is None or (generator is None and draws is None):
            raise ValueError("training needs targets and a generator for the sampler")
        boxes, labels, reg_targets, valid = select_training_samples(
            proposals, prop_valid, targets["boxes"], targets["labels"],
            targets["valid"], cfg, generator, draws)
        pooled = multiscale_roi_align(features, boxes, image_bucket)
        cls, reg, rates = box_head_apply(pooled.reshape(n * boxes.shape[1], -1))
        loss_cls, loss_box = fastrcnn_loss(cls, reg, labels.reshape(-1),
                                           reg_targets.reshape(-1, 4),
                                           valid.reshape(-1))
        return {"rates": rates}, {"loss_classifier": loss_cls,
                                  "loss_box_reg": loss_box}
    align = roi_align if features[0].dtype == torch.bfloat16 else multiscale_roi_align
    pooled = align(features, proposals.contiguous(), image_bucket)
    cls, reg, rates = box_head_apply(pooled.reshape(n * p, -1))
    (gb, gs, gv), inter = _postproc_groups(
        cls.reshape(n, p, -1), reg.reshape(n, p, -1), proposals, prop_valid,
        image_sizes, cfg)
    keep_all, bg_order = _batched_group_nms(gb, gs, gv, cfg.nms_thresh)
    det = _postproc_outputs(inter, keep_all, bg_order, cfg)
    det["rates"] = rates
    return det, {}
