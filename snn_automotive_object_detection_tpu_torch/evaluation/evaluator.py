"""CocoEvaluator: glue between padded model outputs and the COCO protocol.

Port of ``snn_automotive_object_detection_tpu/evaluation/evaluator.py``;
detections may be torch tensors on any device (they are copied to the host
here) or numpy arrays. The cross-process merge gathers every rank's
detections (``parallel/collectives.py``) when a process group is up.

API mirror of the reference's evaluator (its coco_eval.py:14-57):
``update({image_id: detection_dict})`` -> ``synchronize_between_processes()``
-> ``accumulate()`` -> ``summarize()``; stats identical to pycocotools.

Ground truth is built directly from the framework's dataset objects
(CocoDataset / IDDDataset), covering the reference's
``get_coco_api_from_dataset`` + ``convert_to_coco_api``
(coco_utils.py:138-201) without round-tripping through JSON.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from snn_automotive_object_detection_tpu_torch.evaluation.coco_metrics import COCOEval
from snn_automotive_object_detection_tpu_torch.parallel.collectives import (
    all_gather_objects,
    parallel_world,
)


def _host(a) -> np.ndarray:
    """A torch tensor (any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def ground_truth_from_dataset(dataset) -> tuple[Dict, List[int], List]:
    """Extract {image_id: gt dict}, category ids, image ids from a dataset."""
    # CocoDataset: use its index directly.
    if hasattr(dataset, "index"):
        idx = dataset.index
        gt = {}
        for img_id in dataset.ids:
            anns = [a for a in idx.img_to_anns.get(img_id, [])]
            boxes = np.asarray([a["bbox"] for a in anns], np.float64).reshape(-1, 4)
            xyxy = boxes.copy()
            xyxy[:, 2:] += xyxy[:, :2]
            gt[img_id] = {
                "boxes": xyxy,
                "labels": np.asarray([a["category_id"] for a in anns]),
                "areas": np.asarray([a.get("area", (b[2] * b[3]))
                                     for a, b in zip(anns, boxes)], np.float64),
                "iscrowd": np.asarray([a.get("iscrowd", 0) for a in anns]),
            }
        cat_ids = sorted(idx.cats.keys())
        return gt, cat_ids, list(dataset.ids)

    # IDD-style dataset: iterate annotations (convert_to_coco_api path).
    gt = {}
    cat_set = set()
    for i in range(len(dataset)):
        boxes, labels = dataset._parse_xml(dataset.ann_paths[i])
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        gt[i] = {
            "boxes": boxes.astype(np.float64),
            "labels": labels,
            "areas": areas.astype(np.float64),
            "iscrowd": np.zeros(len(labels), np.int64),
        }
        cat_set.update(labels.tolist())
    return gt, sorted(cat_set), list(range(len(dataset)))


class CocoEvaluator:
    """update()/accumulate()/summarize() over a dataset's ground truth."""

    def __init__(self, dataset, remove_bg: bool = False):
        gt, cat_ids, img_ids = ground_truth_from_dataset(dataset)
        self.eval = COCOEval(gt, cat_ids, img_ids)
        self.remove_bg = remove_bg

    def update(self, res: Dict):
        """res: {image_id: {"boxes" [K,4], "scores" [K], "labels" [K],
        optional "valid" [K] mask}} (numpy arrays or torch tensors)."""
        for img_id, det in res.items():
            boxes = _host(det["boxes"]).astype(np.float64)
            scores = _host(det["scores"]).astype(np.float64)
            labels = _host(det["labels"])
            keep = _host(det["valid"]).astype(bool) if "valid" in det else \
                np.ones(len(scores), bool)
            if self.remove_bg:
                # --rm-bg: drop background (label 0) predictions before they
                # reach the evaluator (reference train.py:317-326).
                keep &= labels != 0
            # Without the flag, BG boxes stay in the detection set — exactly
            # like the reference, where the raw outputs (incl. open-set BG
            # extras) go to coco_evaluator.update. COCO metrics are
            # unaffected either way (per-category matching skips label 0,
            # which is never a GT category), but the stored/merged detection
            # set differs, and downstream consumers of self.eval.dets see
            # the BG boxes.
            self.eval.add_detections(img_id, boxes[keep], scores[keep], labels[keep])

    def synchronize_between_processes(self, others: Optional[Sequence] = None):
        """Merge detections across processes (the reference's utils.py:78-91).

        Where each process evaluated its shard, this gathers every
        process's detection dict so that all ranks compute the same global
        metrics; without a process group (``parallel_world()`` (0, 1))
        nothing is gathered. ``others`` additionally merges explicit evaluators."""
        if others:
            self.eval.merge_from([o.eval for o in others])
        me, size = parallel_world()
        if size > 1:
            all_dets = all_gather_objects(dict(self.eval.dets))
            for p, dets in enumerate(all_dets):
                if p == me:
                    continue
                for img_id, d in dets.items():
                    # First-seen wins: wrap-around shard padding duplicates
                    # images across ranks with identical detections
                    # (reference np.unique merge, coco_eval.py:163-177).
                    if img_id in self.eval.dets:
                        continue
                    s = self.eval.dets[img_id]
                    s["boxes"].extend(d["boxes"])
                    s["scores"].extend(d["scores"])
                    s["labels"].extend(d["labels"])

    def accumulate(self):
        self.eval.evaluate()
        self.eval.accumulate()

    def summarize(self, verbose: bool = True) -> np.ndarray:
        return self.eval.summarize(verbose)

    @property
    def stats(self):
        return self.eval.stats
