"""Dataset and model configs.

Port of ``snn_automotive_object_detection_tpu/utils/config.py``: the
reference's ``load_config_dict`` with its UPPERCASE keys accepted as
aliases, and the model hyperparameters. The named configs are this
package's own ``configs/*.json`` (the same facts as the JAX package's YAML
files of those names), so a run by dataset name needs no PyYAML. A JSON
object's decimal keys come back as integers, as YAML reads ``{0:
background}``. A user's ``.yaml`` path still works: PyYAML is imported only
to read one.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

CONFIG_DIR = str(Path(__file__).resolve().parents[1] / "configs")

_KEY_ALIASES = {
    "IMAGES_DIR": "images_dir",
    "ANN_DIR": "ann_dir",
    "ANN_FILE_TRAIN": "ann_file_train",
    "ANN_FILE_VAL": "ann_file_val",
    "OUT_DIR": "out_dir",
    "NUM_CLASSES": "num_classes",
    "CLASSES": "classes",
    "KNOWN_CLASSES": "known_classes",
    "ROOT_DIR_FOR_DWLOAD": "root_dir",
}


def _int_keys(pairs):
    """A JSON object with its decimal keys as integers (YAML's reading)."""
    return {int(k) if k.isdigit() else k: v for k, v in pairs}


def _read(path: str) -> Dict[str, Any]:
    """A JSON file (read without PyYAML), or a YAML one."""
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f, object_pairs_hook=_int_keys)
        import yaml

        return yaml.safe_load(f)


def load_dataset_config(name_or_path: str, data_root: Optional[str] = None) -> Dict[str, Any]:
    """A dataset config by name (cityscapes/bdd/idd/pascal/coco: ``<name>.json``
    of ``CONFIG_DIR``) or path of a JSON or YAML file; ``data_root`` is
    prepended to every relative data path."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(CONFIG_DIR, f"{name_or_path}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no dataset config named {name_or_path!r} (looked in {CONFIG_DIR})")
    raw = _read(path)

    cfg = {_KEY_ALIASES.get(k, k): v for k, v in raw.items()}
    cfg.setdefault("dataset", os.path.splitext(os.path.basename(path))[0])
    if data_root:
        for k in ("images_dir", "ann_file_train", "ann_file_val", "root_dir"):
            if cfg.get(k) and not os.path.isabs(cfg[k]):
                cfg[k] = os.path.join(data_root, cfg[k])
    return cfg


def load_model_yaml(path: Optional[str] = None) -> Dict[str, Any]:
    """Model hyperparameters (``model.json`` of ``CONFIG_DIR`` by default, or
    a JSON or YAML file of the same keys)."""
    return _read(path or os.path.join(CONFIG_DIR, "model.json"))


def class_names(cfg: Dict[str, Any]) -> Dict[int, str]:
    """The classes table as {id: name}, from the mapping form or the
    reference's list of dicts."""
    classes = cfg.get("classes")
    if classes is None:
        return {}
    if isinstance(classes, dict):
        return {int(k): v for k, v in classes.items()}
    return {int(c["id"]): c["name"] for c in classes}
