"""Region Proposal Network: proposal selection and filtering, and the
training loss.

Port of ``snn_automotive_object_detection_tpu/models/rpn.py`` (reference
rpn.py:299-703): flatten the head outputs in (y, x, anchor) order, take the
per-level top pre_nms_top_n by objectness, decode only those, clip, mask
small and low-score boxes, per-level NMS at 0.7, keep the post_nms_top_n
best. Shapes are fixed with validity masks. The pre-NMS proposals and their
scores go out for new-object discovery. In training the anchors are
matched at 0.7/0.3 with low-quality matches, 256 per image are sampled at
50% positive, and the loss is BCE on the objectness plus smooth-L1
(beta 1/9) on the positives' deltas, both over the sampled count; proposals
are selected from detached head outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from snn_automotive_object_detection_tpu_torch.ops import boxes as box_ops
from snn_automotive_object_detection_tpu_torch.ops import nms as nms_ops
from snn_automotive_object_detection_tpu_torch.ops.matcher import match_boxes
from snn_automotive_object_detection_tpu_torch.ops.sampler import (
    balanced_sample,
    balanced_sample_from_draws,
)


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """Hyperparameters from the reference's model.py:50-59."""

    pre_nms_top_n_train: int = 2000
    pre_nms_top_n_test: int = 1000
    post_nms_top_n_train: int = 2000
    post_nms_top_n_test: int = 1000
    nms_thresh: float = 0.7
    fg_iou_thresh: float = 0.7
    bg_iou_thresh: float = 0.3
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    score_thresh: float = 0.0
    min_size: float = 1e-3

    def pre_nms_top_n(self, training: bool) -> int:
        return self.pre_nms_top_n_train if training else self.pre_nms_top_n_test

    def post_nms_top_n(self, training: bool) -> int:
        return self.post_nms_top_n_train if training else self.post_nms_top_n_test


def flatten_head_outputs(objectness: List[torch.Tensor],
                         bbox_reg: List[torch.Tensor]):
    """[N, H, W, A] / [N, H, W, 4A] per level -> [N, K], [N, K, 4] and the
    per-level anchor counts."""
    n = objectness[0].shape[0]
    counts = [o.shape[1] * o.shape[2] * o.shape[3] for o in objectness]
    obj = torch.cat([o.reshape(n, -1) for o in objectness], dim=1)
    reg = torch.cat([r.reshape(n, -1, 4) for r in bbox_reg], dim=1)
    return obj, reg, counts


def select_pre_nms(objectness: torch.Tensor, counts: List[int], top_n: int):
    """Per-level top-k by objectness, ties lowest index first. Returns
    (obj [N, S], idx [N, S] global anchor indices)."""
    obj_sel, idx_sel = [], []
    offset = 0
    for k in counts:
        take = min(top_n, k)
        vals, idx = nms_ops.stable_sort_desc(objectness[:, offset:offset + k])
        obj_sel.append(vals[:, :take])
        idx_sel.append(idx[:, :take] + offset)
        offset += k
    return torch.cat(obj_sel, 1), torch.cat(idx_sel, 1)


def filter_proposals(proposals: torch.Tensor, objectness: torch.Tensor,
                     level_sizes: List[int], image_sizes: torch.Tensor,
                     cfg: RPNConfig, training: bool = False) -> Dict[str, torch.Tensor]:
    """proposals [N, S, 4]; objectness [N, S] logits; level_sizes sum to S;
    image_sizes [N, 2] (h, w). Returns boxes/scores/valid [N, P, ...]
    (P = post_nms_top_n(training)) and the unclipped pre-NMS proposals and
    scores."""
    n = proposals.shape[0]
    scores = torch.sigmoid(objectness)
    boxes = box_ops.clip_boxes_to_image(
        proposals, image_sizes[:, 0, None], image_sizes[:, 1, None])
    valid = box_ops.small_box_mask(boxes, cfg.min_size) & (
        scores >= cfg.score_thresh)

    # One NMS per level (suppression never crosses levels); rows arrive in
    # descending objectness, so the sort is skipped (presorted).
    n_lv, smax = len(level_sizes), max(level_sizes)
    bs = boxes.new_zeros((n, n_lv, smax, 4))
    ss = scores.new_zeros((n, n_lv, smax))
    vs = torch.zeros((n, n_lv, smax), dtype=torch.bool, device=boxes.device)
    off = 0
    for lvl, k in enumerate(level_sizes):
        bs[:, lvl, :k] = boxes[:, off:off + k]
        ss[:, lvl, :k] = scores[:, off:off + k]
        vs[:, lvl, :k] = valid[:, off:off + k]
        off += k
    keep_lv, _ = nms_ops.nms_mask(bs.reshape(-1, smax, 4), ss.reshape(-1, smax),
                                  vs.reshape(-1, smax), cfg.nms_thresh,
                                  presorted=True)
    keep_lv = keep_lv.reshape(n, n_lv, smax)
    keep = torch.cat([keep_lv[:, lvl, :k] for lvl, k in enumerate(level_sizes)],
                     dim=1)
    idx, out_valid = nms_ops.topk_after_nms(scores, keep,
                                            cfg.post_nms_top_n(training))
    return {
        "boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "scores": torch.gather(scores, 1, idx),
        "valid": out_valid,
        "pre_nms_proposals": proposals,
        "pre_nms_objectness": scores,
    }


def assign_targets_to_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                              gt_valid: torch.Tensor, cfg: RPNConfig):
    """Anchor labelling (reference rpn.py:376-432), batched over images.

    anchors [K, 4]; gt_boxes [N, G, 4] padded; gt_valid [N, G]. Returns
    labels [N, K] float (1 foreground, 0 background, -1 ignored) and
    regression targets [N, K, 4] (zeros for anchors that are not positive).
    """
    quality = box_ops.box_iou(gt_boxes, anchors[None])            # [N, G, K]
    matched = match_boxes(quality, gt_valid, cfg.fg_iou_thresh,
                          cfg.bg_iou_thresh, allow_low_quality_matches=True)
    labels = torch.where(matched >= 0, 1.0, torch.where(matched == -1, 0.0, -1.0))
    # An image without ground truth: every anchor is background.
    labels = torch.where(gt_valid.any(dim=-1, keepdim=True), labels, 0.0)

    idx = matched.clamp(min=0)[..., None].expand(-1, -1, 4)
    matched_boxes = torch.gather(gt_boxes, 1, idx)
    # Encode only the positives; elsewhere the anchor itself, so that the
    # encoding never sees a degenerate box (the loss reads positives only).
    safe = torch.where((labels == 1.0)[..., None], matched_boxes, anchors[None])
    return labels, box_ops.encode_boxes(safe, anchors[None])


def smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def rpn_loss(objectness: torch.Tensor, pred_deltas: torch.Tensor,
             labels: torch.Tensor, reg_targets: torch.Tensor, cfg: RPNConfig,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """RPN loss (reference rpn.py:527-561). objectness, labels [N, K];
    pred_deltas, reg_targets [N, K, 4]. The sampler's uniform draws come
    from ``generator``, or are given as ``draws`` = (rp, rn), each [N, K].
    Returns (loss_objectness, loss_rpn_box_reg)."""
    pos_mask, neg_mask = labels == 1.0, labels == 0.0
    if draws is None:
        pos, neg = balanced_sample(generator, pos_mask, neg_mask,
                                   cfg.batch_size_per_image, cfg.positive_fraction)
    else:
        pos, neg = balanced_sample_from_draws(
            pos_mask, neg_mask, draws[0], draws[1], cfg.batch_size_per_image,
            cfg.positive_fraction)
    sampled = pos | neg
    num_sampled = sampled.sum().clamp(min=1)

    box_l = smooth_l1(pred_deltas - reg_targets, beta=1.0 / 9).sum(dim=-1)
    loss_box = (box_l * pos).sum() / num_sampled

    # BCE with logits over the sampled anchors, mean reduction.
    z = objectness
    bce = z.clamp(min=0) - z * labels + torch.log1p(torch.exp(-z.abs()))
    loss_obj = (bce * sampled).sum() / num_sampled
    return loss_obj, loss_box


def rpn_forward(head_apply: Callable, features: List[torch.Tensor],
                anchors: torch.Tensor, level_counts: List[int],
                image_sizes: torch.Tensor, cfg: RPNConfig,
                training: bool = False, targets: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None, draws=None):
    """RPN pass. head_apply: features -> (objectness list, bbox list,
    rates). targets (training): {"boxes" [N, G, 4], "valid" [N, G]}; the
    loss's sampler draws from ``generator`` or takes ``draws`` (see
    :func:`rpn_loss`). Returns (the :func:`filter_proposals` dict plus
    "rates", losses): losses is empty outside training."""
    obj_maps, bbox_maps, rates = head_apply(features)
    objectness, deltas, counts = flatten_head_outputs(obj_maps, bbox_maps)
    if counts != list(level_counts):
        raise ValueError(f"head outputs {counts} do not match anchors "
                         f"{list(level_counts)}")
    top_n = cfg.pre_nms_top_n(training)
    # Proposals are selected from detached outputs: no gradient flows
    # through the selection or the decoded boxes.
    obj_sel, idx_sel = select_pre_nms(objectness.detach(), counts, top_n)
    takes = [min(top_n, k) for k in counts]
    deltas_sel = torch.gather(deltas.detach(), 1,
                              idx_sel[..., None].expand(-1, -1, 4))
    props = box_ops.decode_boxes(deltas_sel, anchors[idx_sel])
    out = filter_proposals(props, obj_sel, takes, image_sizes, cfg, training)
    out["rates"] = rates

    losses: Dict[str, torch.Tensor] = {}
    if training:
        if targets is None or (generator is None and draws is None):
            raise ValueError("training needs targets and a generator for the sampler")
        labels, reg_targets = assign_targets_to_anchors(
            anchors, targets["boxes"], targets["valid"], cfg)
        loss_obj, loss_box = rpn_loss(objectness, deltas, labels, reg_targets,
                                      cfg, generator, draws)
        losses = {"loss_objectness": loss_obj, "loss_rpn_box_reg": loss_box}
    return out, losses
