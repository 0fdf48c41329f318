"""A synthetic detection set of five shape classes, drawn on the device.

Port of ``tools/synth_shapes.py`` of the JAX package. Five visually
distinct classes, shape and colour family together deciding the label:

  1 solid rectangle, red     2 ellipse, green   3 hollow frame, blue
  4 striped rectangle, yellow          5 checkerboard rectangle, magenta

each object with a brightness jitter, patterned ones filling the rest of
their extent with a dim shade of their colour; long sides log-uniform over
[40, 440] pixels (the FPN's anchor bands), aspect ratios over [0.5, 2],
2 to ``max_boxes`` objects an image, later objects occluding earlier ones
(their boxes stay the full extent).

The draws and the painting are apart: :func:`draw_params` takes every
random number from an explicit ``torch.Generator``, and :func:`paint` is
deterministic, so that the JAX package's own draws can be painted here and
the images compared. Everything runs in torch ops on the generator's
device; :func:`synth_batch` gives ``detector_apply``'s training batch.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

NUM_SHAPE_CLASSES = 5
LOG_LONG = (math.log(40.0), math.log(440.0))
LOG_ASPECT = (math.log(0.5), math.log(2.0))
BRIGHT = (0.55, 1.0)
NOISE_MAX = 0.22
# Colour family by class (row 0 pads class 0).
BASE_COLOURS = ((0.0, 0.0, 0.0), (1.0, 0.15, 0.15), (0.15, 1.0, 0.15),
                (0.25, 0.45, 1.0), (1.0, 1.0, 0.15), (1.0, 0.25, 1.0))


def draw_params(generator: torch.Generator, batch: int, h: int, w: int,
                max_boxes: int = 8) -> Dict[str, torch.Tensor]:
    """Every random number of ``batch`` images of ``h`` x ``w``, on the
    generator's device: "n" [B] objects an image (2..max_boxes), "cls" [B,
    G] classes (1..5), "long" [B, G] long sides, "aspect" [B, G] aspect
    ratios, "ux" and "uy" [B, G] uniform placements in [0, 1), "bright" [B,
    G, 1] the brightness jitter and "noise" [B, h, w, 3] the background."""
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=dev)
        return u if (lo, hi) == (0.0, 1.0) else u * (hi - lo) + lo

    g = (batch, max_boxes)
    return {
        "n": torch.randint(2, max_boxes + 1, (batch,), generator=generator, device=dev),
        "cls": torch.randint(1, NUM_SHAPE_CLASSES + 1, g, generator=generator, device=dev),
        "long": torch.exp(uniform(g, *LOG_LONG)),
        "aspect": torch.exp(uniform(g, *LOG_ASPECT)),
        "ux": uniform(g),
        "uy": uniform(g),
        "bright": uniform((batch, max_boxes, 1), *BRIGHT),
        "noise": uniform((batch, h, w, 3), 0.0, NOISE_MAX),
    }


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true division on every device (CUDA divides by a
    Python number as a product with its reciprocal)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _shape_masks(ys, xs, cls, x0, y0, x1, y1):
    """(bright, dim) [B, H, W] masks of one object per image; ``cls`` and
    the box coordinates are [B, 1, 1]. ``bright`` is the class's pattern at
    full colour, ``dim`` the rest of a patterned object's extent."""
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    rx = torch.clamp((x1 - x0) / 2, min=1.0)
    ry = torch.clamp((y1 - y0) / 2, min=1.0)
    in_rect = (xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)
    ellipse = (((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2) <= 1.0
    # The frame: the rectangle less an inner one at 65% of its size.
    inner = ((xs >= cx - 0.65 * rx) & (xs < cx + 0.65 * rx)
             & (ys >= cy - 0.65 * ry) & (ys < cy + 0.65 * ry))
    frame = in_rect & ~inner
    # Stripe and checker periods scale with the box.
    period = torch.clamp(_div(y1 - y0, 6.0), min=2.0)
    px = torch.clamp(_div(x1 - x0, 6.0), min=2.0)
    rows = torch.floor((ys - y0) / period)
    stripes = in_rect & (rows.to(torch.int32) % 2 == 0)
    checker = in_rect & ((rows + torch.floor((xs - x0) / px)).to(torch.int32) % 2 == 0)
    bright = torch.where(cls == 1, in_rect, torch.where(
        cls == 2, ellipse, torch.where(cls == 3, frame,
                                       torch.where(cls == 4, stripes, checker))))
    # The ellipse keeps the background in its corners (its outline is the
    # cue); the other classes fill their extent with the dim shade.
    dim = torch.where(cls == 2, ellipse, in_rect) & ~bright
    return bright, dim


def paint(params: Dict[str, torch.Tensor], h: int, w: int):
    """The images and ground truth of :func:`draw_params`' draws: (images
    [B, h, w, 3] float32 in [0, 1], boxes [B, G, 4] (x0, y0, x1, y1; zeros
    in the unused rows), labels [B, G] int64 (0 unused), valid [B, G])."""
    cls, long, aspect = params["cls"], params["long"], params["aspect"]
    dev = long.device
    root = torch.sqrt(aspect)
    bw = torch.clamp(long * root, max=w * 0.9)
    bh = torch.clamp(long / root, max=h * 0.9)
    x0 = params["ux"] * (w - bw - 2) + 1
    y0 = params["uy"] * (h - bh - 2) + 1
    x1, y1 = x0 + bw, y0 + bh
    base = torch.tensor(BASE_COLOURS, dtype=torch.float32, device=dev)
    colour = torch.clamp(base[cls] * params["bright"] + 0.12, 0.0, 1.0)   # [B, G, 3]
    n_boxes = cls.shape[1]
    valid = torch.arange(n_boxes, device=dev) < params["n"][:, None]

    img = params["noise"].clone()
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
    for i in range(n_boxes):
        def col(t):
            return t[:, i, None, None]
        bright, dim = _shape_masks(ys, xs, col(cls), col(x0), col(y0), col(x1), col(y1))
        on = col(valid)
        c = colour[:, i, None, None, :]
        img = torch.where((dim & on)[..., None], c * 0.35, img)
        img = torch.where((bright & on)[..., None], c, img)
    boxes = torch.where(valid[..., None], torch.stack([x0, y0, x1, y1], dim=-1), 0.0)
    labels = torch.where(valid, cls, 0).to(torch.int64)
    return img, boxes, labels, valid


def synth_batch(generator: torch.Generator, batch: int, h: int, w: int,
                max_boxes: int = 8) -> Dict:
    """A fresh batch in ``detector_apply``'s training format, drawn and
    painted on the generator's device."""
    images, boxes, labels, valid = paint(draw_params(generator, batch, h, w, max_boxes),
                                         h, w)
    sizes = torch.tensor([[h, w]] * batch, device=images.device)
    return {"images": images, "image_sizes": sizes, "original_sizes": sizes.clone(),
            "targets": {"boxes": boxes, "labels": labels, "valid": valid}}
