"""Dataset factory (the reference's datasets.py:65-146 dispatch).

Port of ``snn_automotive_object_detection_tpu/data/registry.py``. A config
given as a dict (``cfg=``) needs no YAML reader.

cityscapes / bdd / pascal / coco -> CocoDataset; idd -> IDDDataset.
The reference auto-downloaded Cityscapes/BDD annotation zips from OneDrive
(datasets.py:20-62) — this environment has no egress, so missing files raise
a clear error telling the user where to put the data instead.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from snn_automotive_object_detection_tpu_torch.data.coco import CocoDataset
from snn_automotive_object_detection_tpu_torch.data.idd import IDDDataset
from snn_automotive_object_detection_tpu_torch.utils.config import load_dataset_config


def create_dataset(
    name: str,
    set_option: str = "train",
    transforms=None,
    known_classes: Optional[list] = None,
    only_known_cls: bool = False,
    data_root: Optional[str] = None,
    cfg: Optional[Dict[str, Any]] = None,
):
    """Build a dataset by name ('cityscapes' | 'bdd' | 'idd' | 'pascal' |
    'coco'), set_option in {'train', 'validation'}.

    only_known_cls applies the open-set KNOWN_CLASSES remap from the dataset
    YAML (datasets.py known_classes flow).
    """
    cfg = cfg or load_dataset_config(name, data_root)
    if set_option not in ("train", "validation", "val", "test"):
        raise ValueError(f"bad set_option {set_option!r}")
    is_train = set_option == "train"

    if only_known_cls and known_classes is None:
        known_classes = cfg.get("known_classes")
        if known_classes is None:
            raise ValueError(f"dataset {name!r} has no known_classes table")

    if cfg["dataset"] == "idd":
        split = "train" if is_train else "val"
        root = cfg.get("root_dir") or os.path.dirname(cfg["images_dir"])
        return IDDDataset(root, split, transforms=transforms)

    ann = cfg["ann_file_train"] if is_train else cfg["ann_file_val"]
    if not os.path.exists(ann):
        raise FileNotFoundError(
            f"annotation file {ann!r} not found. This environment cannot "
            "download datasets; place the files at the paths in "
            f"configs/{cfg['dataset']}.yaml (or pass data_root)."
        )
    return CocoDataset(
        images_dir=cfg["images_dir"],
        ann_file=ann,
        known_classes=known_classes,
        remove_empty=is_train,
        transforms=transforms,
    )
