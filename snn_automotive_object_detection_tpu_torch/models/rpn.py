"""Region Proposal Network, eval path: proposal selection and filtering.

Port of ``snn_automotive_object_detection_tpu/models/rpn.py`` (reference
rpn.py:299-703 at inference): flatten the head outputs in (y, x, anchor)
order, take the per-level top pre_nms_top_n by objectness, decode only
those, clip, mask small and low-score boxes, per-level NMS at 0.7, keep the
post_nms_top_n best. Shapes are fixed with validity masks. The pre-NMS
proposals and their scores go out for new-object discovery.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from snn_automotive_object_detection_tpu_torch.ops import boxes as box_ops
from snn_automotive_object_detection_tpu_torch.ops import nms as nms_ops


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """Eval hyperparameters from the reference's model.py:50-59."""

    pre_nms_top_n_test: int = 1000
    post_nms_top_n_test: int = 1000
    nms_thresh: float = 0.7
    score_thresh: float = 0.0
    min_size: float = 1e-3


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
                     cfg: RPNConfig) -> Dict[str, torch.Tensor]:
    """proposals [N, S, 4]; objectness [N, S] logits; level_sizes sum to S;
    image_sizes [N, 2] (h, w). Returns boxes/scores/valid [N, P, ...]
    (P = post_nms_top_n) and the unclipped pre-NMS proposals and scores."""
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
    idx, out_valid = nms_ops.topk_after_nms(scores, keep, cfg.post_nms_top_n_test)
    return {
        "boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "scores": torch.gather(scores, 1, idx),
        "valid": out_valid,
        "pre_nms_proposals": proposals,
        "pre_nms_objectness": scores,
    }


def rpn_forward(head_apply: Callable, features: List[torch.Tensor],
                anchors: torch.Tensor, level_counts: List[int],
                image_sizes: torch.Tensor, cfg: RPNConfig):
    """Eval RPN pass. head_apply: features -> (objectness list, bbox list,
    rates). Returns the :func:`filter_proposals` dict plus "rates"."""
    obj_maps, bbox_maps, rates = head_apply(features)
    objectness, deltas, counts = flatten_head_outputs(obj_maps, bbox_maps)
    if counts != list(level_counts):
        raise ValueError(f"head outputs {counts} do not match anchors "
                         f"{list(level_counts)}")
    obj_sel, idx_sel = select_pre_nms(objectness, counts, cfg.pre_nms_top_n_test)
    takes = [min(cfg.pre_nms_top_n_test, k) for k in counts]
    deltas_sel = torch.gather(deltas, 1, idx_sel[..., None].expand(-1, -1, 4))
    props = box_ops.decode_boxes(deltas_sel, anchors[idx_sel])
    out = filter_proposals(props, obj_sel, takes, image_sizes, cfg)
    out["rates"] = rates
    return out
