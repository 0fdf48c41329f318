"""Multi-level RoIAlign by gathers (NHWC), in PyTorch.

Port of ``snn_automotive_object_detection_tpu/ops/roi_align.py``:
torchvision ``roi_align`` with aligned=False and sampling_ratio 2 under
``MultiScaleRoIAlign`` (levels 0-3, 7x7 output). Semantics kept exactly:

  * roi coords scaled by the level's spatial scale, no -0.5 offset
  * roi width/height floored at 1.0
  * 2 x 2 sample points per bin at (i + 0.5) sub-bin offsets, averaged
  * bilinear interpolation with torchvision's border rules: a sample is
    zero if y < -1 or y > H or x < -1 or x > W; otherwise coordinates clamp
    to [0, size - 1] and the high index collapses onto the low one

:func:`multiscale_roi_align` is the plain version of the hand-written CUDA
kernel in ``ops/cuda_roi_align.py``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from snn_automotive_object_detection_tpu_torch.ops.boxes import box_area
from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

OUTPUT_SIZE = 7
SAMPLING_RATIO = 2


def assign_fpn_levels(boxes: torch.Tensor, num_levels: int,
                      canonical_scale: float = 224.0,
                      canonical_level: float = 4.0, k_min: int = 2,
                      eps: float = 1e-6, k_max: int | None = None):
    """FPN level per box, 0-based (torchvision ``LevelMapper``)."""
    if k_max is None:
        k_max = k_min + num_levels - 1
    s = torch.sqrt(box_area(boxes))
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale) + eps)
    lvl = torch.clamp(lvl, k_min, k_max)
    return (lvl - k_min).to(torch.int32)


def infer_scales(feature_shapes: Sequence[Tuple[int, int]],
                 image_size: Tuple[int, int]) -> list:
    """Per-level spatial scales 2 ** round(log2(feature / image))."""
    scales = []
    for fh, fw in feature_shapes:
        s_h = 2.0 ** round(math.log2(fh / image_size[0]))
        s_w = 2.0 ** round(math.log2(fw / image_size[1]))
        if s_h != s_w:
            raise ValueError(f"non-uniform FPN scale {fh}x{fw} for {image_size}")
        scales.append(s_h)
    return scales


def level_geometry(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                   image_size: Tuple[int, int], canonical_scale: float = 224.0,
                   canonical_level: float = 4.0):
    """(levels [N, R] int32, scales [L] float) for the pooled levels."""
    shapes = [(f.shape[1], f.shape[2]) for f in features]
    scales = infer_scales(shapes, image_size)
    levels = assign_fpn_levels(
        boxes, len(features), canonical_scale, canonical_level,
        k_min=int(-math.log2(scales[0])), k_max=int(-math.log2(scales[-1])))
    return levels, scales


def multiscale_roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                         image_size: Tuple[int, int],
                         canonical_scale: float = 224.0,
                         canonical_level: float = 4.0) -> torch.Tensor:
    """Multi-level RoIAlign over FPN features.

    features: list of [N, H_l, W_l, C]; boxes: [N, R, 4] xyxy in padded
    input coordinates. Returns float32 [N, R, 7, 7, C]; bf16 features are
    interpolated in float32.
    """
    n, r, _ = boxes.shape
    c = features[0].shape[-1]
    dev = boxes.device
    levels, scales = level_geometry(features, boxes, image_size,
                                    canonical_scale, canonical_level)
    lv = levels.long()
    sizes = [f.shape[1] * f.shape[2] for f in features]
    offs = [0]
    for sz in sizes[:-1]:
        offs.append(offs[-1] + sz)
    buf = torch.cat([f.reshape(n, -1, c) for f in features], dim=1)
    lvl_scale = device_constant(tuple(scales), boxes.dtype, dev)[lv]
    lvl_h = device_constant(tuple(f.shape[1] for f in features), torch.int64, dev)[lv]
    lvl_w = device_constant(tuple(f.shape[2] for f in features), torch.int64, dev)[lv]
    lvl_off = device_constant(tuple(offs), torch.int64, dev)[lv]

    x1 = boxes[..., 0] * lvl_scale
    y1 = boxes[..., 1] * lvl_scale
    x2 = boxes[..., 2] * lvl_scale
    y2 = boxes[..., 3] * lvl_scale
    # A 0-d device tensor as divisor keeps this a true division: PyTorch's
    # CUDA division by a Python scalar multiplies by its reciprocal, which
    # can move the bin size (and every sample point) by an ulp.
    out_size = device_constant(float(OUTPUT_SIZE), boxes.dtype, dev)
    bin_w = torch.clamp(x2 - x1, min=1.0) / out_size
    bin_h = torch.clamp(y2 - y1, min=1.0) / out_size

    os_, sr = OUTPUT_SIZE, SAMPLING_RATIO
    ph = torch.arange(os_, dtype=boxes.dtype, device=dev)
    sub = (torch.arange(sr, dtype=boxes.dtype, device=dev) + 0.5) / sr
    # [N, R, 7, 2]: sample coordinates per bin and sub-sample.
    ys = y1[..., None, None] + (ph[:, None] + sub[None, :]) * bin_h[..., None, None]
    xs = x1[..., None, None] + (ph[:, None] + sub[None, :]) * bin_w[..., None, None]

    hh = lvl_h[..., None, None]
    ww = lvl_w[..., None, None]
    off = lvl_off[..., None, None]
    hf, wf = hh.to(boxes.dtype), ww.to(boxes.dtype)
    zero = torch.zeros((), dtype=boxes.dtype, device=dev)

    def corner(yi, xi):
        idx = (off + yi * ww + xi).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(buf, 1, idx).reshape(n, r, os_, os_, c).float()

    acc = None
    for a in range(sr):
        for b in range(sr):
            y = ys[..., :, None, a].expand(n, r, os_, os_)
            x = xs[..., None, :, b].expand(n, r, os_, os_)
            valid = (y >= -1.0) & (y <= hf) & (x >= -1.0) & (x <= wf)
            y = torch.maximum(y, zero)
            x = torch.maximum(x, zero)
            y_low = torch.minimum(y.long(), hh - 1)
            x_low = torch.minimum(x.long(), ww - 1)
            y = torch.where(y_low >= hh - 1, y_low.to(y.dtype), y)
            x = torch.where(x_low >= ww - 1, x_low.to(x.dtype), x)
            y_high = torch.minimum(y_low + 1, hh - 1)
            x_high = torch.minimum(x_low + 1, ww - 1)
            ly = y - y_low.to(y.dtype)
            lx = x - x_low.to(x.dtype)
            hy = 1.0 - ly
            hx = 1.0 - lx
            vm = valid.to(torch.float32)
            w00 = (hy * hx * vm)[..., None]
            w01 = (hy * lx * vm)[..., None]
            w10 = (ly * hx * vm)[..., None]
            w11 = (ly * lx * vm)[..., None]
            v = ((w00 * corner(y_low, x_low) + w01 * corner(y_low, x_high))
                 + (w10 * corner(y_high, x_low) + w11 * corner(y_high, x_high)))
            acc = v if acc is None else acc + v
    return acc / (sr * sr)
