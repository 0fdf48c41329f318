"""RoI heads, eval path of the spiking (open-set) detector.

Port of ``snn_automotive_object_detection_tpu/models/roi_heads.py``
(reference roi_heads.py:1075-1176 and 1178-1347 at inference): RoIAlign
7x7 over FPN levels 0-3 (kernel K2), the box head, then the open-set
postprocess. Foreground boxes (classes >= 1) are score-thresholded,
small-filtered, NMS'd per class and capped at detections_per_img;
background (class-0) boxes of proposals that no above-threshold foreground
prediction claimed survive their own NMS and are all kept. The pre-NMS
per-class scores and boxes go out for new-object discovery. All tensors
are batched over images; fixed capacities with validity masks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from snn_automotive_object_detection_tpu_torch.ops import boxes as box_ops
from snn_automotive_object_detection_tpu_torch.ops import nms as nms_ops
from snn_automotive_object_detection_tpu_torch.ops.cuda_roi_align import roi_align

# Per-class NMS over the top-K rows when no foreground class has more than
# K valid rows (exact: greedy NMS only looks at valid rows); otherwise the
# whole batch takes the full path.
PRUNED_NMS_K = 128


@dataclasses.dataclass(frozen=True)
class RoIConfig:
    """Eval hyperparameters from the reference's model.py:94-106."""

    score_thresh: float = 0.4
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    min_size: float = 1e-2


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
                      image_bucket: Tuple[int, int], cfg: RoIConfig) -> Dict:
    """features: the 4 pooled levels [N, H_l, W_l, C] (not "pool");
    proposals [N, P, 4]. box_head_apply: [N*P, 7*7*C] -> (logits, deltas,
    rates). Returns the detections dict with "rates"."""
    n, p, _ = proposals.shape
    pooled = roi_align(features, proposals.contiguous(), image_bucket)
    cls, reg, rates = box_head_apply(pooled.reshape(n * p, -1))
    (gb, gs, gv), inter = _postproc_groups(
        cls.reshape(n, p, -1), reg.reshape(n, p, -1), proposals, prop_valid,
        image_sizes, cfg)
    keep_all, bg_order = _batched_group_nms(gb, gs, gv, cfg.nms_thresh)
    det = _postproc_outputs(inter, keep_all, bg_order, cfg)
    det["rates"] = rates
    return det
