"""Indian Driving Dataset (Pascal-VOC-style XML annotations).

Copy of ``snn_automotive_object_detection_tpu/data/idd.py`` for the PyTorch
port, with pixels read through one method, :meth:`IDDDataset.load_image`,
as in ``data/coco.py``. The reference's idd.py: 15 classes shifted by +1
so 0 is background, image lists from ``{split}.txt``, boxes parsed from
``Annotations/*.xml``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np

IDD_CLASSES = [
    "person", "rider", "car", "truck", "bus", "motorcycle", "bicycle",
    "autorickshaw", "animal", "traffic light", "traffic sign",
    "vehicle fallback", "caravan", "trailer", "train",
]
# +1 shift: 0 is background (idd.py:25-45)
IDD_CLASS_TO_ID: Dict[str, int] = {n: i + 1 for i, n in enumerate(IDD_CLASSES)}


class IDDDataset:
    """__getitem__ -> (image uint8 RGB [H, W, 3], target dict)."""

    def __init__(self, root: str, split: str = "train", transforms=None):
        self.root = root
        self.split = split
        self.transforms = transforms
        with open(os.path.join(root, f"{split}.txt")) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        self.image_paths = sorted(
            os.path.join(root, "JPEGImages", n + ".jpg") for n in names
        )
        self.ann_paths = [
            p.replace("JPEGImages", "Annotations").replace(".jpg", ".xml")
            for p in self.image_paths
        ]

    def __len__(self):
        return len(self.image_paths)

    def get_height_and_width(self, i: int):
        """(h, w) from the VOC XML <size> block (no pixel decode) — the
        loader's orientation-bucketing protocol; header-only PIL fallback
        when an annotation omits it."""
        root = ET.parse(self.ann_paths[i]).getroot()
        size = root.find("size")
        if size is not None:
            h = size.findtext("height")
            w = size.findtext("width")
            if h and w:
                return int(h), int(w)
        from PIL import Image

        with Image.open(self.image_paths[i]) as im:
            w, h = im.size
        return int(h), int(w)

    def _parse_xml(self, path: str):
        root = ET.parse(path).getroot()
        labels, boxes = [], []
        for node in root.iter("object"):
            name = node.find("name").text
            labels.append(IDD_CLASS_TO_ID[name])
            boxes.append(
                [
                    int(node.find("bndbox/xmin").text),
                    int(node.find("bndbox/ymin").text),
                    int(node.find("bndbox/xmax").text),
                    int(node.find("bndbox/ymax").text),
                ]
            )
        return (
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int64),
        )

    def load_image(self, image_id: int) -> np.ndarray:
        """Image ``image_id`` (its index), uint8 RGB [H, W, 3], decoded with
        ``cv2``."""
        import cv2

        img = cv2.imread(self.image_paths[image_id], cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(self.image_paths[image_id])
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def __getitem__(self, i: int):
        img = self.load_image(i)
        boxes, labels = self._parse_xml(self.ann_paths[i])
        area = (boxes[:, 3] - boxes[:, 1]) * (boxes[:, 2] - boxes[:, 0])
        target = {
            "boxes": boxes,
            "labels": labels,
            "image_id": np.asarray(i),
            "area": area,
            "iscrowd": np.zeros(len(boxes), np.int64),
        }
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target
