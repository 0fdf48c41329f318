"""Image normalisation, box rescaling and the resize arithmetic (torchvision
``GeneralizedRCNNTransform`` as the reference configures it). Port of
``snn_automotive_object_detection_tpu/models/transform.py``; the resize to
the bucket happens on the host (``data/loader.py``) before the batch
reaches the model."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# Cityscapes' own statistics, which the reference's model.py sets.
CITYSCAPES_MEAN = (0.2869, 0.3251, 0.2839)
CITYSCAPES_STD = (0.1870, 0.1902, 0.1872)


def resize_shape(orig_hw: Tuple[int, int], min_size: int = 768,
                 max_size: int = 1536) -> Tuple[int, int]:
    """Torchvision's resize arithmetic: scale by min(min_size / short side,
    max_size / long side) and floor each side (recompute_scale_factor)."""
    h, w = orig_hw
    short, long = min(h, w), max(h, w)
    scale = min(min_size / short, max_size / long)
    return int(math.floor(h * scale)), int(math.floor(w * scale))


def normalize_images(images: torch.Tensor, mean, std) -> torch.Tensor:
    """images: [N, H, W, 3] float in [0, 1] (or uint8, scaled here)."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    mean = device_constant(tuple(mean), images.dtype, images.device)
    std = device_constant(tuple(std), images.dtype, images.device)
    return (images - mean) / std


def rescale_boxes(boxes: torch.Tensor, from_sizes: torch.Tensor,
                  to_sizes: torch.Tensor) -> torch.Tensor:
    """boxes [N, ..., 4]; from_sizes/to_sizes [N, 2] (h, w)."""
    ry = to_sizes[:, 0].to(boxes.dtype) / from_sizes[:, 0].to(boxes.dtype)
    rx = to_sizes[:, 1].to(boxes.dtype) / from_sizes[:, 1].to(boxes.dtype)
    scale = torch.stack([rx, ry, rx, ry], dim=-1)
    scale = scale.reshape((boxes.shape[0],) + (1,) * (boxes.dim() - 2) + (4,))
    return boxes * scale
