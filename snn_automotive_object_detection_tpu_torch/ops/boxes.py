"""Box primitives (xyxy convention) in PyTorch.

Port of ``snn_automotive_object_detection_tpu/ops/boxes.py`` (torchvision
0.13 ``ops.boxes`` and ``BoxCoder`` semantics, batched and mask-based).
"""

from __future__ import annotations

import math

import torch

# torchvision BoxCoder clamps dw/dh at log(1000/16) before exp.
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: [..., N, 4] x [..., M, 4] -> [..., N, M] (no +1
    offsets; 0/0 -> 0)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    iw = torch.clamp(
        torch.minimum(boxes1[..., :, None, 2], boxes2[..., None, :, 2])
        - torch.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0]),
        min=0.0,
    )
    ih = torch.clamp(
        torch.minimum(boxes1[..., :, None, 3], boxes2[..., None, :, 3])
        - torch.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1]),
        min=0.0,
    )
    inter = iw * ih
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes_to_image(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp xyxy boxes to [0, W] x [0, H]. height/width: scalars or
    tensors broadcastable against boxes[..., 0]."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    h = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Mask of boxes with BOTH sides >= min_size."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


def encode_boxes(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode ground-truth boxes [..., 4] relative to anchors or proposals
    [..., 4] as (tx, ty, tw, th) (torchvision ``BoxCoder.encode_single``)."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0]
    ex_h = proposals[..., 3] - proposals[..., 1]
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h

    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0]
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1]
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

    tx = wx * (gt_cx - ex_cx) / ex_w
    ty = wy * (gt_cy - ex_cy) / ex_h
    tw = ww * torch.log(gt_w / ex_w)
    th = wh * torch.log(gt_h / ex_h)
    return torch.stack([tx, ty, tw, th], dim=-1)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Apply regression deltas [..., K*4] to boxes [..., 4]
    (torchvision ``BoxCoder.decode_single``)."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(d[..., 3] / wh, max=BBOX_XFORM_CLIP)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)
    return out.reshape(deltas.shape)
