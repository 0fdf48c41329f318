"""COCO-format detection dataset with open-set class remapping.

Copy of ``snn_automotive_object_detection_tpu/data/coco.py`` for the
PyTorch port, with one change: pixels are read through one method,
:meth:`CocoDataset.load_image`, so that a subclass can hand in decoded
arrays (no ``cv2`` needed then). The slice of pycocotools + torchvision
``CocoDetection`` that the reference uses (its coco_utils.py):

  * JSON index (images / annotations / categories)          [COCO class]
  * ``known_classes`` remap: rewrite annotation category ids through an
    orig_id -> id table, drop other classes, prune images left empty
    (coco_utils.py:204-269, 272-311)
  * xywh -> xyxy conversion, crowd filtering, degenerate-box filtering
    (coco_utils.py:74-135)
  * removal of images without annotations for training
    (coco_utils.py:9-54)

No C extension needed — the reference only uses bbox-mode evaluation, so
mask decoding never happens on this path.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class CocoIndex:
    """Minimal COCO annotation index (bbox detection subset)."""

    def __init__(self, ann_file_or_dict):
        if isinstance(ann_file_or_dict, (str, os.PathLike)):
            with open(ann_file_or_dict) as f:
                d = json.load(f)
        else:
            d = ann_file_or_dict
        self.dataset = d
        self._build()

    def _build(self):
        self.imgs = {img["id"]: img for img in self.dataset.get("images", [])}
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}
        self.img_to_anns: Dict[Any, List[dict]] = {i: [] for i in self.imgs}
        self.anns = {}
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            if ann["image_id"] in self.img_to_anns:
                self.img_to_anns[ann["image_id"]].append(ann)

    @property
    def image_ids(self) -> List[Any]:
        return list(self.imgs.keys())

    def remap_known_classes(self, known_classes: Sequence[dict]) -> "CocoIndex":
        """Keep only the known classes, remapping ids (coco_utils.py:204-269).

        known_classes: [{"id": new_id, "orig_id": old_id, "name": ...}, ...]
        including background (orig_id 0) which has no annotations.
        Returns a new CocoIndex; images with no remaining annotations are
        dropped.
        """
        id_map = {
            int(c["orig_id"]): int(c["id"])
            for c in known_classes
            if int(c["orig_id"]) != 0
        }
        new_anns = []
        for ann in self.dataset.get("annotations", []):
            if int(ann["category_id"]) in id_map:
                a = dict(ann)
                a["category_id"] = id_map[int(ann["category_id"])]
                new_anns.append(a)
        keep_imgs = {a["image_id"] for a in new_anns}
        new_cats = [
            {"id": int(c["id"]), "name": c.get("name", str(c["id"])),
             "supercategory": c.get("supercategory", "none")}
            for c in known_classes
            if int(c["orig_id"]) != 0
        ]
        d = {
            "images": [im for im in self.dataset["images"] if im["id"] in keep_imgs],
            "annotations": new_anns,
            "categories": new_cats,
        }
        return CocoIndex(d)

    def remove_images_without_annotations(self) -> "CocoIndex":
        """coco_utils.py:9-54 (without the keypoint branch)."""
        keep = set()
        for img_id, anns in self.img_to_anns.items():
            anns = [a for a in anns if a.get("iscrowd", 0) == 0]
            if any(a["bbox"][2] > 1 and a["bbox"][3] > 1 for a in anns):
                keep.add(img_id)
        d = {
            "images": [im for im in self.dataset["images"] if im["id"] in keep],
            "annotations": [
                a for a in self.dataset["annotations"] if a["image_id"] in keep
            ],
            "categories": self.dataset["categories"],
        }
        return CocoIndex(d)


def target_from_annotations(
    anns: List[dict], height: int, width: int, image_id
) -> Dict[str, np.ndarray]:
    """xywh -> xyxy conversion + crowd/degenerate filtering
    (coco_utils.py:74-135)."""
    anns = [a for a in anns if a.get("iscrowd", 0) == 0]
    boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
    boxes[:, 2:] += boxes[:, :2]
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, width)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, height)
    labels = np.asarray([a["category_id"] for a in anns], np.int64)
    area = np.asarray([a.get("area", 0.0) for a in anns], np.float32)
    iscrowd = np.zeros(len(anns), np.int64)

    keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
    return {
        "boxes": boxes[keep],
        "labels": labels[keep],
        "image_id": np.asarray(image_id),
        "area": area[keep],
        "iscrowd": iscrowd[keep],
    }


class CocoDataset:
    """Detection dataset over a COCO JSON + image directory.

    __getitem__ -> (image uint8 RGB [H, W, 3], target dict of numpy arrays).
    """

    def __init__(
        self,
        images_dir: str,
        ann_file: str,
        known_classes: Optional[Sequence[dict]] = None,
        remove_empty: bool = False,
        transforms=None,
    ):
        index = CocoIndex(ann_file)
        if known_classes:
            index = index.remap_known_classes(known_classes)
        if remove_empty:
            index = index.remove_images_without_annotations()
        self.index = index
        self.images_dir = images_dir
        self.ids = sorted(index.imgs.keys())
        self.transforms = transforms

    def __len__(self):
        return len(self.ids)

    def image_path(self, image_id) -> str:
        return os.path.join(self.images_dir, self.index.imgs[image_id]["file_name"])

    def get_height_and_width(self, i: int):
        """Per-image (h, w) from COCO metadata WITHOUT decoding pixels —
        the torchvision GroupedBatchSampler protocol the loader's
        orientation bucketing uses (reference train.py:103). Falls back to
        a header-only PIL open for jsons missing the size fields."""
        info = self.index.imgs[self.ids[i]]
        h, w = info.get("height"), info.get("width")
        if h is None or w is None:
            from PIL import Image

            with Image.open(self.image_path(self.ids[i])) as im:
                w, h = im.size  # header read only; pixels stay undecoded
        return int(h), int(w)

    def load_image(self, image_id) -> np.ndarray:
        """The image's pixels, uint8 RGB [H, W, 3]: a ``.npy`` file as numpy
        saved it, any other file decoded with ``cv2``."""
        path = self.image_path(image_id)
        if path.endswith(".npy"):
            return np.load(path)
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(self.image_path(image_id))
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def __getitem__(self, i: int):
        image_id = self.ids[i]
        info = self.index.imgs[image_id]
        img = self.load_image(image_id)
        target = target_from_annotations(
            self.index.img_to_anns.get(image_id, []),
            info.get("height", img.shape[0]),
            info.get("width", img.shape[1]),
            image_id,
        )
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target
