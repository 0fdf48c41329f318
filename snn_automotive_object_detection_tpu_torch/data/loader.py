"""Bucketed, fixed-shape batch loader with threaded prefetch.

Port of ``snn_automotive_object_detection_tpu/data/loader.py`` for the
PyTorch port, with two changes: the bilinear resize is numpy
(:func:`resize_bilinear`, no ``cv2``), and there is no planar image layout
(the fused stem, K6, takes the raw NHWC batch). :func:`to_device_batch`
moves a batch onto the device the model runs on.

It replaces torch DataLoader + GeneralizedRCNNTransform batching (the
reference's datasets.py:149-163, faster_rcnn.py:163-164): each image is

  1. aspect-preserving resized so min side -> min_size (768) capped by
     max_size (1536), boxes scaled along (bilinear, half-pixel centres)
  2. degenerate GT boxes are patched +2 px like generalized_rcnn.py:84-91
  3. padded bottom/right into the static bucket (min_size, max_size)
  4. GT packed into fixed [MAX_GT] slots + validity mask

yielding batches of static shapes. Worker threads overlap decode, resize
and augmentation with the device's work (numpy and cv2 release the GIL).

Aspect-ratio grouping (reference train.py:103 ``--aspect-ratio-group-factor``
+ torchvision GroupedBatchSampler): images are bucketed by ORIENTATION —
landscape into ``bucket`` (min_size, max_size), portrait into the transposed
bucket — and every batch is orientation-homogeneous, so a mixed dataset
(e.g. Pascal VOC) has exactly two batch shapes instead of overflowing the
fixed landscape bucket. Orientation comes from dataset metadata
(``get_height_and_width``, the torchvision sampler's own protocol) without
decoding pixels; datasets that don't expose it are treated as
all-landscape (the original single-bucket behavior).

Data-parallel sharding: ``shard=(process_index, process_count)`` splits the
dataset like the reference's DistributedSampler (train.py:594-607). The
group partition is derived from metadata identically on every process, and
each orientation group is wrap-around padded to the world size — so all
ranks yield the same number of batches with the SAME bucket sequence
(bucket b on rank 0 is bucket b everywhere), keeping collectives in
lockstep.
"""

from __future__ import annotations

import math
import threading
import queue
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from snn_automotive_object_detection_tpu_torch.models.transform import resize_shape

MAX_GT = 128


def _taps(n_src: int, n_dst: int):
    """Source index and float32 fraction of each output position along one
    axis: x = (d + 0.5) n_src / n_dst - 0.5 in float64 (the scale taken as
    1 / (n_dst / n_src)), its floor, and the fraction rounded once to
    float32."""
    x = (np.arange(n_dst, dtype=np.float64) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5
    s = np.floor(x)
    return s.astype(np.int64), (x - s).astype(np.float32)


def fma_f32(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """x y + z on float32 arrays, rounded once to float32 (a fused
    multiply-add). The product is exact in float64 and the float64 sum s
    rounds once more; that second rounding can only go wrong where s falls
    on a float32 midpoint (its low 29 fraction bits 1000...), and there the
    sum's exact error decides the direction."""
    p = x.astype(np.float64) * y            # exact: two 24-bit significands
    z64 = np.broadcast_to(z, p.shape).astype(np.float64)
    s = p + z64
    r = s.astype(np.float32)
    tie = (s.view(np.uint64) & 0x1FFFFFFF) == 0x10000000
    if tie.any():
        i = np.nonzero(tie)
        pi, zi, si = p[i], z64[i], s[i]
        bb = si - pi
        err = (pi - (si - bb)) + (zi - bb)  # si + err == pi + zi exactly
        ri = r[i]
        lo = ri.astype(np.float64) < si
        ri = np.where((err > 0) & lo, np.nextafter(ri, np.float32(np.inf)), ri)
        ri = np.where((err < 0) & ~lo, np.nextafter(ri, np.float32(-np.inf)), ri)
        r[i] = ri
    return r


def _lerp(a: np.ndarray, b: np.ndarray, f: np.ndarray) -> np.ndarray:
    """a + f (b - a) on float32: b - a rounded, then one fused rounding."""
    return fma_f32(b - a, f, a)


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear resize of a float32 image [H, W, ...] to [nh, nw, ...] with
    half-pixel centres and clamped edges: OpenCV's ``cv2.resize(img, (nw,
    nh), interpolation=cv2.INTER_LINEAR)`` on float32, bit for bit, as
    OpenCV 5 computes it: a horizontal pass, then a vertical one, each
    a + f (b - a) with one rounding (an FMA). Along x a position left of
    the first pixel centre or right of the last takes that pixel; along y
    the two rows are clamped into the image and the fraction kept. OpenCV 4
    computes (1 - f) a + f b instead and averages an exact 2x downscale."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    sx, fx = _taps(w, nw)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, w - 1)
    x1 = np.minimum(sx + 1, w - 1)
    sy, fy = _taps(h, nh)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    rows = np.unique(np.concatenate([y0, y1]))
    tail = (None,) * (img.ndim - 2)
    hor = np.empty((h, nw) + img.shape[2:], np.float32)
    src = img[rows]
    hor[rows] = _lerp(src[:, sx], src[:, x1], fx[(None, slice(None)) + tail])
    return _lerp(hor[y0], hor[y1], fy[(slice(None), None) + tail])


def resize_image_and_target(img: np.ndarray, target: Optional[dict],
                            min_size: int, max_size: int):
    """Returns (resized image float32 [0,1], target w/ scaled boxes,
    (new_h, new_w))."""
    h, w = img.shape[:2]
    nh, nw = resize_shape((h, w), min_size, max_size)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    resized = resize_bilinear(img, nh, nw)
    if target is not None and len(target.get("boxes", ())):
        b = target["boxes"].astype(np.float32).copy()
        b[:, [0, 2]] *= nw / w
        b[:, [1, 3]] *= nh / h
        # Degenerate-box patch (+2 px), generalized_rcnn.py:84-91.
        deg = b[:, 2:] <= b[:, :2]
        b[:, 2:] = np.where(deg, b[:, 2:] + 2.0, b[:, 2:])
        target = {**target, "boxes": b}
    return resized, target, (nh, nw)


def pack_targets(targets: List[dict], max_gt: int = MAX_GT):
    n = len(targets)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    labels = np.zeros((n, max_gt), np.int32)
    valid = np.zeros((n, max_gt), bool)
    for i, t in enumerate(targets):
        g = min(len(t["boxes"]), max_gt)
        if g:
            boxes[i, :g] = t["boxes"][:g]
            labels[i, :g] = t["labels"][:g]
            valid[i, :g] = True
    return {"boxes": boxes, "labels": labels, "valid": valid}


class DetectionLoader:
    """Iterates fixed-shape batches.

    Yields dicts:
      images [N, Hb, Wb, 3] float32, image_sizes [N, 2], original_sizes
      [N, 2], image_ids [N], and (if with_targets) targets {boxes, labels,
      valid}. The final partial batch is padded by repeating the last image
      with pad_mask marking real entries.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        bucket: Tuple[int, int],
        min_size: int = 768,
        max_size: int = 1536,
        shuffle: bool = False,
        seed: int = 12,
        with_targets: bool = True,
        num_workers: int = 4,
        shard: Tuple[int, int] = (0, 1),
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucket = bucket
        self.min_size = min_size
        self.max_size = max_size
        self.shuffle = shuffle
        self.seed = seed
        self.with_targets = with_targets
        self.num_workers = max(1, num_workers)
        self.shard = shard
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """DistributedSampler.set_epoch equivalent (train.py:900-903)."""
        self.epoch = epoch

    def _portrait_flags(self) -> Optional[np.ndarray]:
        """bool[n]: image i is portrait (h > w). None when the dataset has no
        cheap size metadata -> single-bucket (all-landscape) behavior.
        ``get_height_and_width`` is the same per-image protocol torchvision's
        GroupedBatchSampler path uses (reference train.py:103)."""
        get_hw = getattr(self.dataset, "get_height_and_width", None)
        if get_hw is None:
            return None
        n = len(self.dataset)
        flags = np.zeros(n, bool)
        for i in range(n):
            h, w = get_hw(i)
            flags[i] = h > w
        return flags if flags.any() else None

    def _bucket_for(self, portrait: bool) -> Tuple[int, int]:
        hb, wb = self.bucket
        return (wb, hb) if portrait else (hb, wb)

    def _batches(self) -> List[Tuple[List[int], Tuple[int, int]]]:
        """The epoch plan: [(dataset indices, bucket)] — every batch
        orientation-homogeneous, identical bucket sequence on all ranks."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        flags = self._portrait_flags()
        rank, world = self.shard
        out: List[Tuple[List[int], Tuple[int, int]]] = []
        for portrait in (False, True):
            grp = idx if flags is None else idx[flags[idx] == portrait]
            if not len(grp):
                continue
            g = len(grp)
            if world > 1 and g % world:
                # DistributedSampler-style wrap-around padding PER GROUP:
                # every process must yield the SAME number of batches of the
                # SAME bucket or multi-host collectives desynchronize. Tile
                # when the pad exceeds the group size (torch
                # DistributedSampler's indices * ceil rule) — a short pad
                # would give ranks unequal shard lengths and deadlock the
                # collectives. Duplicated images are deduplicated at the
                # evaluator merge (evaluation/coco_metrics.py merge_from).
                pad = world - g % world
                reps = -(-pad // g)
                grp = np.concatenate([grp] * (1 + reps))[: g + pad]
            local = grp[rank::world].tolist()
            if self.drop_last:
                # Truncate the tail here so __iter__ never decodes images
                # that no batch will consume.
                local = local[: (len(local) // self.batch_size)
                              * self.batch_size]
            bucket = self._bucket_for(portrait)
            for lo in range(0, len(local), self.batch_size):
                out.append((local[lo:lo + self.batch_size], bucket))
            if flags is None:
                break  # no metadata -> single landscape pass
        return out

    def _indices(self) -> List[int]:
        """Flat rank-local index list (batch order)."""
        return [i for b, _ in self._batches() for i in b]

    def __len__(self):
        return len(self._batches())

    def _load_one(self, i: int, bucket: Tuple[int, int]):
        img, target = self.dataset[i]
        orig = img.shape[:2]
        img, target, new_size = resize_image_and_target(
            img, target if self.with_targets else target, self.min_size, self.max_size
        )
        hb, wb = bucket
        nh, nw = new_size
        if nh > hb or nw > wb:
            # Reachable when a portrait image arrives from a dataset that
            # exposes no cheap size metadata: _portrait_flags() returned
            # None, so every image was planned into the landscape bucket.
            raise ValueError(
                f"resized image {new_size} exceeds bucket {bucket}: the "
                f"dataset ({type(self.dataset).__name__}) does not "
                "implement get_height_and_width(i) -> (h, w), so the "
                "loader cannot route portrait images into the transposed "
                "orientation bucket. Implement that method (the same "
                "per-image protocol torchvision's GroupedBatchSampler "
                "uses, reference train.py:103) to enable portrait batches."
            )
        padded = np.zeros((hb, wb, 3), np.float32)
        padded[:nh, :nw] = img
        return padded, target, new_size, orig

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        plan = self._batches()
        results: Dict[int, tuple] = {}
        lock = threading.Lock()
        todo = queue.Queue()
        pos = 0
        for batch_idx, bucket in plan:
            for i in batch_idx:
                todo.put((pos, i, bucket))
                pos += 1
        errors = []

        def worker():
            while True:
                try:
                    pos, i, bucket = todo.get_nowait()
                except queue.Empty:
                    return
                try:
                    out = self._load_one(i, bucket)
                except Exception as e:  # propagate to the consumer
                    errors.append(e)
                    out = None
                with lock:
                    results[pos] = out

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def take(pos):
            while True:
                with lock:
                    if pos in results:
                        out = results.pop(pos)
                        break
                if errors:
                    raise errors[0]
                threading.Event().wait(0.002)
            if out is None:
                raise errors[0]
            return out

        lo = 0
        for batch_idx, bucket in plan:
            hi = lo + len(batch_idx)
            items = [take(p) for p in range(lo, hi)]
            lo = hi
            pad_mask = np.zeros(self.batch_size, bool)
            pad_mask[: len(items)] = True
            while len(items) < self.batch_size:
                items.append(items[-1])

            images = np.stack([it[0] for it in items])
            new_sizes = np.asarray([it[2] for it in items], np.int32)
            orig_sizes = np.asarray([it[3] for it in items], np.int32)
            image_ids = np.asarray(
                [np.asarray(it[1]["image_id"]).item() if it[1] else -1 for it in items]
            )
            batch = {
                "images": images,
                "image_sizes": new_sizes,
                "original_sizes": orig_sizes,
                "image_ids": image_ids,
                "pad_mask": pad_mask,
            }
            if self.with_targets:
                batch["targets"] = pack_targets([it[1] for it in items])
            yield batch


def to_device_batch(batch: Dict, device, with_targets: bool = False) -> Dict:
    """A loader batch as the tensors ``detector_apply`` takes, on
    ``device``: images, image_sizes, original_sizes and, with
    ``with_targets``, the packed targets. For a CUDA device each array goes
    through pinned host memory with a non-blocking copy, so the call does
    not wait for the device; a CUDA device without a card raises."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"to_device_batch: {device} requested, but no CUDA device is present")

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if cuda:
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    out = {k: put(batch[k]) for k in ("images", "image_sizes", "original_sizes")}
    if with_targets and "targets" in batch:
        out["targets"] = {k: put(v) for k, v in batch["targets"].items()}
    return out
