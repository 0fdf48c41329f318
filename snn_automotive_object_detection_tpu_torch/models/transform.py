"""Image normalisation and box rescaling (torchvision
``GeneralizedRCNNTransform`` as the reference configures it). Port of
``snn_automotive_object_detection_tpu/models/transform.py``; the resize to
the bucket happens on the host before the batch reaches the model."""

from __future__ import annotations

import torch

from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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
