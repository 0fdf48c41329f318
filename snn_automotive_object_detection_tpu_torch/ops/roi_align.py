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
    # A 0-d tensor as divisor keeps this a true division on every device
    # (PyTorch's CUDA division by a Python scalar multiplies by its
    # reciprocal), so the level agrees with the JAX mapper and with K2's.
    scale = device_constant(float(canonical_scale), boxes.dtype, boxes.device)
    lvl = torch.floor(canonical_level + torch.log2(s / scale) + eps)
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


def level_range(scales: Sequence[float]) -> Tuple[int, int]:
    """(k_min, k_max) of the level mapper for the pooled levels' scales:
    the finest and the coarsest level's log2 stride."""
    return int(-math.log2(scales[0])), int(-math.log2(scales[-1]))


def level_geometry(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                   image_size: Tuple[int, int], canonical_scale: float = 224.0,
                   canonical_level: float = 4.0):
    """(levels [N, R] int32, scales [L] float) for the pooled levels."""
    shapes = [(f.shape[1], f.shape[2]) for f in features]
    scales = infer_scales(shapes, image_size)
    k_min, k_max = level_range(scales)
    levels = assign_fpn_levels(boxes, len(features), canonical_scale,
                               canonical_level, k_min=k_min, k_max=k_max)
    return levels, scales


def _sample_corners(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                    image_size: Tuple[int, int], canonical_scale: float,
                    canonical_level: float):
    """The bilinear corners of every sample point. Yields, for each of the
    2 x 2 sub-samples of a bin (row-major), the four corners (y_low, x_low),
    (y_low, x_high), (y_high, x_low), (y_high, x_high) as (row index
    [N, R, 7, 7] into the levels' rows concatenated per image, weight
    [N, R, 7, 7] f32, zero for a sample outside the map)."""
    n, r, _ = boxes.shape
    dev = boxes.device
    levels, scales = level_geometry(features, boxes, image_size,
                                    canonical_scale, canonical_level)
    lv = levels.long()
    sizes = [f.shape[1] * f.shape[2] for f in features]
    offs = [0]
    for sz in sizes[:-1]:
        offs.append(offs[-1] + sz)
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
            yield ((off + y_low * ww + x_low, hy * hx * vm),
                   (off + y_low * ww + x_high, hy * lx * vm),
                   (off + y_high * ww + x_low, ly * hx * vm),
                   (off + y_high * ww + x_high, ly * lx * vm))


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
    os_ = OUTPUT_SIZE
    buf = torch.cat([f.reshape(n, -1, c) for f in features], dim=1)

    def corner(idx):
        idx = idx.reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(buf, 1, idx).reshape(n, r, os_, os_, c).float()

    acc = None
    for (i00, w00), (i01, w01), (i10, w10), (i11, w11) in _sample_corners(
            features, boxes, image_size, canonical_scale, canonical_level):
        v = ((w00[..., None] * corner(i00) + w01[..., None] * corner(i01))
             + (w10[..., None] * corner(i10) + w11[..., None] * corner(i11)))
        acc = v if acc is None else acc + v
    return acc / (SAMPLING_RATIO * SAMPLING_RATIO)


def rows_read(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              image_size: Tuple[int, int], canonical_scale: float = 224.0,
              canonical_level: float = 4.0) -> int:
    """How many distinct feature rows (image, level, y, x; C values each)
    the RoIAlign of ``boxes`` reads with a nonzero weight: the least any
    implementation must read from the pooled levels."""
    n = boxes.shape[0]
    per_image = sum(f.shape[1] * f.shape[2] for f in features)
    base = torch.arange(n, device=boxes.device).view(n, 1, 1, 1) * per_image
    ids = [(idx + base)[wt != 0]
           for corners in _sample_corners(features, boxes, image_size,
                                          canonical_scale, canonical_level)
           for idx, wt in corners]
    return int(torch.unique(torch.cat(ids)).numel())
