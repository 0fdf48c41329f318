"""Masked, batched NMS in PyTorch: blocked bitmask suppression.

Port of ``snn_automotive_object_detection_tpu/ops/nms.py``. Every function
takes a leading batch dimension (the JAX package vmaps instead) and keeps
the reference's keep sets bit for bit: the same stable score order, the
same block size and the same in-block fixpoint. That fixpoint zeroes the
rows of every box that is suppressed by any row still in the matrix, so in
a suppression chain a -> b -> c -> d inside one block it keeps d, which
greedy NMS drops (c, kept, overlaps it); the port reproduces this rather
than torchvision's greedy result.

Sorting uses ``torch.sort(stable=True)``: ties go lowest index first, as
CPU ``lax.top_k`` and ``jnp.argsort`` order them (``torch.topk`` promises
no tie order on CUDA).
"""

from __future__ import annotations

import torch

from snn_automotive_object_detection_tpu_torch.ops.boxes import box_iou
from snn_automotive_object_detection_tpu_torch.utils.graphs import graphed

NEG_INF = torch.finfo(torch.float32).min
BLOCK = 256


def stable_sort_desc(x: torch.Tensor):
    """(values, indices) sorted descending along the last dim, ties lowest
    index first."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _self_suppress_fixpoint(sup: torch.Tensor) -> torch.Tensor:
    """sup: [B, b, b] bool, sup[i, j] = box i (earlier) would suppress j.
    The reference zeroes the rows of suppressed boxes until nothing
    changes; returns the [B, b] mask of suppressed boxes at that fixpoint.

    One round reaches it, with no loop and no read back to the host: rows
    are only ever removed, so the boxes hit after the first round are a
    subset of those hit before it, and the second round removes no row.
    The suppressed boxes are those hit by a box that nothing hits.
    """
    alive = ~sup.any(dim=1)
    return (sup & alive[:, :, None]).any(dim=1)


@graphed
def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, groups: torch.Tensor | None = None,
             block_size: int | None = None, presorted: bool = False):
    """Masked NMS over [B, N] rows.

    boxes [B, N, 4]; scores, valid [B, N]; groups optional [B, N] ints
    (suppression only within a group). presorted: scores already descend
    over the valid rows, so the sort is skipped.

    Returns keep [B, N] bool (original order) and order [B, N] int64 (the
    score-descending indices).
    """
    bsz, n = scores.shape
    dev = scores.device
    b = min(block_size if block_size is not None else BLOCK, n)
    n_pad = -(-n // b) * b

    if presorted:
        order = torch.arange(n, device=dev).expand(bsz, n)
        ob, ov, og = boxes, valid, groups
    else:
        masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        order = torch.sort(-masked, dim=-1, stable=True).indices
        ob = torch.gather(boxes, 1, order[..., None].expand(bsz, n, 4))
        ov = torch.gather(valid, 1, order)
        og = None if groups is None else torch.gather(groups, 1, order)

    sb = torch.zeros((bsz, n_pad, 4), dtype=boxes.dtype, device=dev)
    sb[:, :n] = ob
    sa = torch.zeros((bsz, n_pad), dtype=torch.bool, device=dev)
    sa[:, :n] = ov
    sg = None
    if og is not None:
        sg = torch.full((bsz, n_pad), -1, dtype=torch.int64, device=dev)
        sg[:, :n] = og

    kept = torch.zeros((bsz, n_pad), dtype=torch.bool, device=dev)
    tri = torch.ones((b, b), dtype=torch.bool, device=dev).triu(1)
    for start in range(0, n_pad, b):
        blk = sb[:, start:start + b]
        active = sa[:, start:start + b]
        blk_g = None if sg is None else sg[:, start:start + b]
        if start > 0:
            prev = kept[:, None, :start]
            if sg is not None:
                prev = prev & (blk_g[:, :, None] == sg[:, None, :start])
            hit = (box_iou(blk, sb[:, :start]) > iou_threshold) & prev
            active = active & ~hit.any(dim=-1)
        pair = tri & active[:, :, None] & active[:, None, :]
        if blk_g is not None:
            pair = pair & (blk_g[:, :, None] == blk_g[:, None, :])
        sup = pair & (box_iou(blk, blk) > iou_threshold)
        kept[:, start:start + b] = active & ~_self_suppress_fixpoint(sup)

    if presorted:
        keep = kept[:, :n]
    else:
        keep = torch.zeros((bsz, n), dtype=torch.bool, device=dev)
        keep.scatter_(1, order, kept[:, :n])
    return keep, order


def nms_mask_pruned(boxes, scores, valid, iou_threshold: float, k: int):
    """NMS over [B, N] rows of which AT MOST ``k`` per row are valid (the
    caller guarantees it): only the top-k masked scores can keep or
    suppress, so one presorted block of k replaces the full sweep.
    Returns keep [B, N] bool.

    The body is :func:`_pruned_keep`, a CUDA graph replay in evaluation;
    this call stays a Python call, which the caller's branch counts."""
    return _pruned_keep(boxes, scores, valid, iou_threshold, k)


@graphed
def _pruned_keep(boxes, scores, valid, iou_threshold: float, k: int):
    """The body of :func:`nms_mask_pruned`."""
    bsz, n = scores.shape
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    vals, idx = stable_sort_desc(masked)
    vals, idx = vals[:, :k], idx[:, :k]
    valid_k = vals > NEG_INF
    keep_k, _ = nms_mask(
        torch.gather(boxes, 1, idx[..., None].expand(bsz, k, 4)), vals,
        valid_k, iou_threshold, block_size=k, presorted=True)
    keep = torch.zeros((bsz, n), dtype=torch.bool, device=scores.device)
    keep.scatter_(1, idx, keep_k & valid_k)
    return keep


def select_kept_in_order(order: torch.Tensor, keep: torch.Tensor):
    """Kept entries in score order from an existing sort: a stable
    partition of ``order`` [B, N] by ``keep`` [B, N]. Returns (idx [B, N],
    valid [B, N]); the tail holds the non-kept indices in score order."""
    bsz, n = order.shape
    kept_o = torch.gather(keep, 1, order)
    cum = torch.cumsum(kept_o.to(torch.int64), dim=1)
    nk = cum[:, -1:]
    pos_i = torch.arange(n, device=order.device).expand(bsz, n)
    pos = torch.where(kept_o, cum - 1, nk + pos_i - cum)
    idx = torch.zeros_like(order).scatter_(1, pos, order)
    return idx, pos_i < nk


def topk_after_nms(scores: torch.Tensor, keep: torch.Tensor, k: int):
    """Up to ``k`` kept entries per row, score-descending: (indices [B, k],
    valid [B, k]), padded with the next rows of the sort."""
    masked = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    vals, idx = stable_sort_desc(masked)
    return idx[:, :k], vals[:, :k] > NEG_INF
