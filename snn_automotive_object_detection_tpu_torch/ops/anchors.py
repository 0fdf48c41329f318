"""Anchor grids as precomputed constants (torchvision ``AnchorGenerator``
as the reference configures it). Port of
``snn_automotive_object_detection_tpu/ops/anchors.py``."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AnchorSpec:
    sizes: Tuple[Tuple[float, ...], ...] = ((32.0,), (64.0,), (128.0,),
                                            (256.0,), (512.0,))
    aspect_ratios: Tuple[Tuple[float, ...], ...] = ((0.5, 1.0, 2.0),) * 5

    @property
    def num_anchors_per_location(self) -> Tuple[int, ...]:
        return tuple(len(s) * len(a)
                     for s, a in zip(self.sizes, self.aspect_ratios))


def _cell_anchors(sizes: Sequence[float], ratios: Sequence[float]) -> np.ndarray:
    """Zero-centred, rounded base anchors [A, 4] (torchvision 0.13)."""
    sizes = np.asarray(sizes, dtype=np.float32)
    ratios = np.asarray(ratios, dtype=np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * sizes[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * sizes[None, :]).reshape(-1)
    return (np.stack([-ws, -hs, ws, hs], axis=1) / 2.0).round()


def generate_anchors(feature_shapes: Sequence[Tuple[int, int]],
                     image_size: Tuple[int, int],
                     spec: AnchorSpec = AnchorSpec(),
                     device=None) -> list:
    """Per-level [H_l * W_l * A, 4] float32 anchors in (y, x, anchor)
    order; strides are image_size // feature_size per dimension."""
    img_h, img_w = image_size
    out = []
    for (fh, fw), sizes, ratios in zip(feature_shapes, spec.sizes,
                                       spec.aspect_ratios):
        cell = _cell_anchors(sizes, ratios)
        shifts_x = np.arange(fw, dtype=np.float32) * (img_w // fw)
        shifts_y = np.arange(fh, dtype=np.float32) * (img_h // fh)
        sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()],
                          axis=1)
        anchors = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
        out.append(torch.as_tensor(anchors.astype(np.float32), device=device))
    return out
