"""Host-side image/box transforms (numpy + cv2).

Copy of ``snn_automotive_object_detection_tpu/data/transforms.py`` for the
PyTorch port; ``cv2`` is imported only inside the transforms that draw or
resize with it (rain, scale jitter, shortest-size resize, photometric
distortion).

Covers the reference's transform presets (its presets.py,
transforms.py): horizontal flip for training (the default and only
augmentation used by the released models), plus the evaluation-time
corruption transforms for the robustness studies:

  * gaussian / salt-and-pepper noise with skimage.random_noise semantics
    (transforms.py:87-107): additive N(0, var) on [0,1] floats, clipped;
    s&p flips `amount` of the pixels to 0/1 in equal proportion
  * synthetic rain (transforms.py:110-191): random slanted streaks drawn with
    cv2.line, box blur, HLS lightness scaling — light=300 drops/4x4
    blur/0.97, heavy=1000 drops/6x6 blur/0.95, parametric count otherwise

All transforms take and return (image uint8|float RGB HWC, target dict) —
the loader converts to float [0,1] at the end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, image, target):
        for t in self.transforms:
            image, target = t(image, target)
        return image, target


class RandomHorizontalFlip:
    """Flip image + boxes with probability p (transforms.py:30-52)."""

    def __init__(self, p: float = 0.5, rng: Optional[np.random.Generator] = None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target):
        if self.rng.random() < self.p:
            image = np.ascontiguousarray(image[:, ::-1])
            if target is not None and len(target.get("boxes", ())):
                w = image.shape[1]
                b = target["boxes"].copy()
                b[:, [0, 2]] = w - b[:, [2, 0]]
                target = {**target, "boxes": b}
        return image, target


def _to_float01(image: np.ndarray) -> np.ndarray:
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return image.astype(np.float32)


class RandomNoise:
    """skimage.random_noise equivalent ('gaussian' / 'syp')."""

    def __init__(self, noise_type: str, noise_intensity: float,
                 rng: Optional[np.random.Generator] = None):
        if noise_type not in ("gaussian", "syp"):
            raise ValueError(f"unknown noise type {noise_type!r}")
        self.mode = noise_type
        self.intensity = float(noise_intensity)
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target):
        img = _to_float01(image)
        if self.mode == "gaussian":
            img = img + self.rng.normal(0.0, np.sqrt(self.intensity), img.shape)
        else:  # salt & pepper
            flip = self.rng.random(img.shape[:2]) < self.intensity
            salt = self.rng.random(img.shape[:2]) < 0.5
            img[flip & salt] = 1.0
            img[flip & ~salt] = 0.0
        return np.clip(img, 0.0, 1.0).astype(np.float32), target


class Rain:
    """Synthetic rain streaks (transforms.py:110-191 behaviour)."""

    PRESETS = {
        "light": dict(drops=300, color=(125, 125, 125), blur=(4, 4), brightness=0.97),
        "heavy": dict(drops=1000, color=(150, 150, 150), blur=(6, 6), brightness=0.95),
        "rain": dict(drops=None, color=(150, 150, 150), blur=(6, 6), brightness=0.95),
    }

    def __init__(self, rain_type: str, number_of_drops: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        if rain_type not in self.PRESETS:
            raise ValueError(f"unknown rain type {rain_type!r}")
        p = self.PRESETS[rain_type]
        self.drops = p["drops"] if p["drops"] is not None else int(number_of_drops)
        self.color = p["color"]
        self.blur = p["blur"]
        self.brightness = p["brightness"]
        self.slant_extreme = 10
        self.drop_length = 15
        self.drop_width = 2
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target):
        import cv2

        img = _to_float01(image).copy()
        h, w = img.shape[:2]
        slant = int(self.rng.integers(-self.slant_extreme, self.slant_extreme))
        color = tuple(c / 255.0 for c in self.color)
        for _ in range(self.drops):
            if slant < 0:
                x = int(self.rng.integers(slant, w))
            else:
                x = int(self.rng.integers(0, max(w - slant, 1)))
            y = int(self.rng.integers(0, max(h - self.drop_length, 1)))
            cv2.line(img, (x, y), (x + slant, y + self.drop_length),
                     color, self.drop_width)
        img = cv2.blur(img, self.blur)
        hls = cv2.cvtColor(img, cv2.COLOR_RGB2HLS)
        hls[:, :, 1] = hls[:, :, 1] * self.brightness
        img = cv2.cvtColor(hls, cv2.COLOR_HLS2RGB)
        return np.clip(img, 0.0, 1.0).astype(np.float32), target


class ScaleJitter:
    """Large-scale jitter (torchvision ScaleJitter): resize by a random
    factor r in [0.1, 2.0] of target_size / image_size."""

    def __init__(self, target_size=(1024, 1024), scale_range=(0.1, 2.0),
                 rng: Optional[np.random.Generator] = None):
        self.target_size = target_size
        self.scale_range = scale_range
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target):
        import cv2

        h, w = image.shape[:2]
        scale = self.rng.uniform(*self.scale_range)
        r = min(self.target_size[0] / h, self.target_size[1] / w) * scale
        nh, nw = max(int(h * r), 1), max(int(w * r), 1)
        image = cv2.resize(_to_float01(image), (nw, nh),
                           interpolation=cv2.INTER_LINEAR)
        if target is not None and len(target.get("boxes", ())):
            b = target["boxes"].copy()
            b[:, [0, 2]] *= nw / w
            b[:, [1, 3]] *= nh / h
            target = {**target, "boxes": b}
        return image, target


class FixedSizeCrop:
    """Random crop (pad) to a fixed size with fill (torchvision
    FixedSizeCrop); boxes clipped, degenerate ones dropped."""

    def __init__(self, size=(1024, 1024), fill=(0.485, 0.456, 0.406),
                 rng: Optional[np.random.Generator] = None):
        self.size = size
        self.fill = np.asarray(fill, np.float32)
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target):
        img = _to_float01(image)
        th, tw = self.size
        h, w = img.shape[:2]
        y0 = int(self.rng.integers(0, max(h - th, 0) + 1))
        x0 = int(self.rng.integers(0, max(w - tw, 0) + 1))
        crop = img[y0:y0 + th, x0:x0 + tw]
        out = np.broadcast_to(self.fill, (th, tw, 3)).astype(np.float32).copy()
        out[: crop.shape[0], : crop.shape[1]] = crop
        if target is not None and len(target.get("boxes", ())):
            b = target["boxes"].copy()
            b[:, [0, 2]] = np.clip(b[:, [0, 2]] - x0, 0, tw)
            b[:, [1, 3]] = np.clip(b[:, [1, 3]] - y0, 0, th)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            target = {**target, "boxes": b[keep],
                      "labels": target["labels"][keep]}
        return out, target


class RandomShortestSize:
    """Multiscale resize (torchvision RandomShortestSize)."""

    def __init__(self, min_sizes, max_size=1333,
                 rng: Optional[np.random.Generator] = None):
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target):
        import cv2

        h, w = image.shape[:2]
        ms = self.min_sizes[int(self.rng.integers(0, len(self.min_sizes)))]
        r = min(ms / min(h, w), self.max_size / max(h, w))
        nh, nw = int(h * r), int(w * r)
        image = cv2.resize(_to_float01(image), (nw, nh),
                           interpolation=cv2.INTER_LINEAR)
        if target is not None and len(target.get("boxes", ())):
            b = target["boxes"].copy()
            b[:, [0, 2]] *= nw / w
            b[:, [1, 3]] *= nh / h
            target = {**target, "boxes": b}
        return image, target


class RandomZoomOut:
    """Canvas zoom-out with fill (torchvision RandomZoomOut, p=0.5,
    side_range (1, 4))."""

    def __init__(self, fill=(0.485, 0.456, 0.406), side_range=(1.0, 4.0),
                 p: float = 0.5, rng: Optional[np.random.Generator] = None):
        self.fill = np.asarray(fill, np.float32)
        self.side_range = side_range
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target):
        if self.rng.random() >= self.p:
            return image, target
        img = _to_float01(image)
        h, w = img.shape[:2]
        r = self.rng.uniform(*self.side_range)
        ch, cw = int(h * r), int(w * r)
        y0 = int(self.rng.integers(0, ch - h + 1))
        x0 = int(self.rng.integers(0, cw - w + 1))
        canvas = np.broadcast_to(self.fill, (ch, cw, 3)).astype(np.float32).copy()
        canvas[y0:y0 + h, x0:x0 + w] = img
        if target is not None and len(target.get("boxes", ())):
            b = target["boxes"].copy()
            b[:, [0, 2]] += x0
            b[:, [1, 3]] += y0
            target = {**target, "boxes": b}
        return canvas, target


class RandomIoUCrop:
    """SSD-style IoU-constrained crop (torchvision RandomIoUCrop)."""

    def __init__(self, rng: Optional[np.random.Generator] = None, trials=40):
        self.options = [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, None]
        self.trials = trials
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target):
        if target is None or not len(target.get("boxes", ())):
            return image, target
        h, w = image.shape[:2]
        boxes = target["boxes"]
        for _ in range(self.trials):
            min_iou = self.options[int(self.rng.integers(0, len(self.options)))]
            if min_iou is None:
                return image, target
            cw = int(self.rng.uniform(0.3, 1.0) * w)
            ch = int(self.rng.uniform(0.3, 1.0) * h)
            if cw / ch < 0.5 or cw / ch > 2.0:
                continue
            x0 = int(self.rng.integers(0, w - cw + 1))
            y0 = int(self.rng.integers(0, h - ch + 1))
            crop = np.array([x0, y0, x0 + cw, y0 + ch], np.float32)
            cx = (boxes[:, 0] + boxes[:, 2]) / 2
            cy = (boxes[:, 1] + boxes[:, 3]) / 2
            inside = (cx > crop[0]) & (cx < crop[2]) & (cy > crop[1]) & (cy < crop[3])
            if not inside.any():
                continue
            ix = np.maximum(boxes[:, 0], crop[0])
            iy = np.maximum(boxes[:, 1], crop[1])
            ix2 = np.minimum(boxes[:, 2], crop[2])
            iy2 = np.minimum(boxes[:, 3], crop[3])
            inter = np.clip(ix2 - ix, 0, None) * np.clip(iy2 - iy, 0, None)
            ba = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            iou = inter / np.maximum(ba + cw * ch - inter, 1e-9)
            if iou.max() < min_iou:
                continue
            img = _to_float01(image)[y0:y0 + ch, x0:x0 + cw]
            b = boxes[inside].copy()
            b[:, [0, 2]] = np.clip(b[:, [0, 2]] - x0, 0, cw)
            b[:, [1, 3]] = np.clip(b[:, [1, 3]] - y0, 0, ch)
            t = {**target, "boxes": b, "labels": target["labels"][inside]}
            return img, t
        return image, target


class RandomPhotometricDistort:
    """Brightness/contrast/saturation/hue jitter (torchvision
    RandomPhotometricDistort, each with p=0.5)."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target):
        import cv2

        img = _to_float01(image)
        r = self.rng
        if r.random() < 0.5:
            img = img * r.uniform(0.875, 1.125)  # brightness
        if r.random() < 0.5:
            img = (img - img.mean()) * r.uniform(0.5, 1.5) + img.mean()  # contrast
        img = np.clip(img, 0, 1).astype(np.float32)
        if r.random() < 0.5 or r.random() < 0.5:  # saturation / hue
            hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
            hsv[..., 1] *= r.uniform(0.5, 1.5)
            hsv[..., 0] = (hsv[..., 0] + r.uniform(-18, 18)) % 360
            img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        return np.clip(img, 0, 1).astype(np.float32), target


def train_transform(data_augmentation: str = "hflip",
                    rng: Optional[np.random.Generator] = None):
    """Training presets (presets.py:12-67; released models use 'hflip')."""
    if data_augmentation == "hflip":
        return Compose([RandomHorizontalFlip(0.5, rng)])
    if data_augmentation == "lsj":
        return Compose([
            ScaleJitter(rng=rng),
            FixedSizeCrop(rng=rng),
            RandomHorizontalFlip(0.5, rng),
        ])
    if data_augmentation == "multiscale":
        return Compose([
            RandomShortestSize(
                (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800),
                1333, rng,
            ),
            RandomHorizontalFlip(0.5, rng),
        ])
    if data_augmentation == "ssd":
        return Compose([
            RandomPhotometricDistort(rng),
            RandomZoomOut(rng=rng),
            RandomIoUCrop(rng),
            RandomHorizontalFlip(0.5, rng),
        ])
    if data_augmentation == "ssdlite":
        return Compose([RandomIoUCrop(rng), RandomHorizontalFlip(0.5, rng)])
    if data_augmentation in ("none", ""):
        return Compose([])
    raise ValueError(f"unknown data augmentation policy {data_augmentation!r}")


def eval_transform(add_noise: str = "", noise_intensity: float = 0.05,
                   rng: Optional[np.random.Generator] = None):
    """Evaluation preset incl. corruption variants (presets.py:70-118)."""
    ts = []
    if add_noise == "gaussian":
        ts.append(RandomNoise("gaussian", noise_intensity, rng))
    elif add_noise == "syp":
        ts.append(RandomNoise("syp", noise_intensity, rng))
    elif add_noise == "rain":
        ts.append(Rain("rain", int(noise_intensity), rng))
    elif add_noise == "light-rain":
        ts.append(Rain("light", rng=rng))
    elif add_noise == "heavy-rain":
        ts.append(Rain("heavy", rng=rng))
    elif add_noise:
        raise ValueError(f"unknown noise option {add_noise!r}")
    return Compose(ts)
