"""IoU matcher (torchvision ``detection._utils.Matcher``), batched.

Port of ``snn_automotive_object_detection_tpu/ops/matcher.py``. Used by the
RPN (thresholds 0.7/0.3, low-quality matches on) and the RoI head (0.5/0.5,
off). Padded ground-truth rows are handled by a validity mask.
"""

from __future__ import annotations

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_boxes(quality: torch.Tensor, gt_valid: torch.Tensor,
                high_threshold: float, low_threshold: float,
                allow_low_quality_matches: bool) -> torch.Tensor:
    """Assign each prediction (anchor or proposal) a ground-truth index or
    a flag.

    quality [..., G, K] match quality (IoU), rows are (padded) ground-truth
    boxes; gt_valid [..., G] bool, False rows never match. Returns matches
    [..., K] int64: the index, or BELOW_LOW_THRESHOLD / BETWEEN_THRESHOLDS.
    Among equal maxima the first row wins, as ``argmax`` gives it.
    """
    q = torch.where(gt_valid[..., :, None], quality, -1.0)
    matched_vals, matches = q.max(dim=-2)

    below = matched_vals < low_threshold
    between = (matched_vals >= low_threshold) & (matched_vals < high_threshold)
    out = torch.where(below, BELOW_LOW_THRESHOLD, matches)
    out = torch.where(between, BETWEEN_THRESHOLDS, out)

    if allow_low_quality_matches:
        # For each ground-truth box, every prediction tying its best quality
        # keeps its pre-threshold match (set_low_quality_matches_).
        highest_per_gt = q.max(dim=-1, keepdim=True).values
        is_best = (q == highest_per_gt) & gt_valid[..., :, None]
        out = torch.where(is_best.any(dim=-2), matches, out)
    return out
