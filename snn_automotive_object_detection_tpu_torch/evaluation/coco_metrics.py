"""COCO bbox evaluation protocol, reimplemented in numpy.

Copy of ``snn_automotive_object_detection_tpu/evaluation/coco_metrics.py``
for the PyTorch port, on the port's own ``_native`` matcher.

Replaces the pycocotools ``COCOeval`` C/Python implementation the reference
consumes through coco_eval.py. Reproduces the exact protocol:

  * IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1
  * area ranges all / small(<32^2) / medium / large(>96^2), maxDets 1/10/100
  * per-image greedy matching in descending det-score order, preferring
    non-ignored GTs; crowd GTs can absorb multiple detections and use
    IoU = inter / det_area
  * unmatched detections outside the area range are ignored, not false
    positives
  * accumulate: global score-sorted PR curves, precision envelope, 101-point
    interpolation; -1 where no GT exists
  * the standard 12 summary stats (stats[0]=mAP, stats[1]=mAP@.5,
    stats[8]=mAR@100 are the ones the reference's sweeps consume —
    metrics_for_different_timesteps.py:497-499)

Inputs are plain numpy/dict structures; no COCO class required (any mapping
of image -> GT boxes/labels/areas/iscrowd works).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
AREA_KEYS = list(AREA_RNG.keys())


def bbox_iou_xyxy(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU [D, G]; crowd GT uses union = det area."""
    d_area = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    g_area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    ix = np.clip(
        np.minimum(dt[:, None, 2], gt[None, :, 2])
        - np.maximum(dt[:, None, 0], gt[None, :, 0]),
        0,
        None,
    )
    iy = np.clip(
        np.minimum(dt[:, None, 3], gt[None, :, 3])
        - np.maximum(dt[:, None, 1], gt[None, :, 1]),
        0,
        None,
    )
    inter = ix * iy
    union = np.where(
        iscrowd[None, :].astype(bool),
        d_area[:, None],
        d_area[:, None] + g_area[None, :] - inter,
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


class COCOEval:
    """Bbox COCOeval over in-memory ground truth + detections.

    ground_truth: {image_id: {"boxes" [G,4] xyxy, "labels" [G],
                              "areas" [G], "iscrowd" [G]}}
    category_ids: evaluated category ids (no background).
    Detections are fed via add_detections(image_id, boxes, scores, labels).
    """

    def __init__(self, ground_truth: Dict, category_ids: Sequence[int],
                 image_ids: Optional[Sequence] = None):
        self.gt = ground_truth
        self.cat_ids = list(category_ids)
        self.img_ids = list(image_ids) if image_ids is not None else list(ground_truth)
        self.dets: Dict = defaultdict(lambda: {"boxes": [], "scores": [], "labels": []})
        self._eval = None
        self.stats: Optional[np.ndarray] = None

    def add_detections(self, image_id, boxes: np.ndarray, scores: np.ndarray,
                       labels: np.ndarray):
        d = self.dets[image_id]
        d["boxes"].append(np.asarray(boxes, np.float64).reshape(-1, 4))
        d["scores"].append(np.asarray(scores, np.float64).reshape(-1))
        d["labels"].append(np.asarray(labels).reshape(-1))

    # ---------------------------------------------------------------- merge

    def merge_from(self, others: Iterable["COCOEval"]):
        """Cross-process merge (the all_gather of coco_eval.py:158-177).

        First-seen wins per image: the sharded loader pads with wrap-around
        duplicates so every rank yields equal batch counts, which makes the
        same image (with identical detections) appear on two ranks. The
        reference dedups the merged img_ids the same way
        (coco_eval.py:163-177, np.unique)."""
        for o in others:
            for img_id, d in o.dets.items():
                if img_id in self.dets:
                    continue
                s = self.dets[img_id]
                s["boxes"].extend(d["boxes"])
                s["scores"].extend(d["scores"])
                s["labels"].extend(d["labels"])

    # ------------------------------------------------------------- evaluate

    def _img_cat_eval(self, img_id, cat):
        """Match one (image, category) pair across all IoU thresholds.

        Returns None if no GT and no det, else a dict like COCOeval's
        evalImgs entries.
        """
        g = self.gt.get(img_id)
        if g is None:
            g_boxes = np.zeros((0, 4))
            g_crowd = np.zeros(0, bool)
            g_area = np.zeros(0)
        else:
            sel = np.asarray(g["labels"]).reshape(-1) == cat
            g_boxes = np.asarray(g["boxes"], np.float64).reshape(-1, 4)[sel]
            g_crowd = np.asarray(g.get("iscrowd", np.zeros(sel.sum()))).reshape(-1)[sel].astype(bool)
            g_area = np.asarray(
                g.get("areas", np.zeros(sel.sum()))
            ).reshape(-1)[sel].astype(np.float64)

        d = self.dets.get(img_id)
        if d is None or not d["boxes"]:
            d_boxes = np.zeros((0, 4))
            d_scores = np.zeros(0)
        else:
            boxes = np.concatenate(d["boxes"]) if d["boxes"] else np.zeros((0, 4))
            scores = np.concatenate(d["scores"])
            labels = np.concatenate(d["labels"])
            sel = labels == cat
            d_boxes = boxes[sel]
            d_scores = scores[sel]

        if len(g_boxes) == 0 and len(d_boxes) == 0:
            return None

        # Sort dets by score desc (mergesort = stable, like pycocotools).
        order = np.argsort(-d_scores, kind="mergesort")[: max(MAX_DETS)]
        d_boxes = d_boxes[order]
        d_scores = d_scores[order]
        d_area = (d_boxes[:, 2] - d_boxes[:, 0]) * (d_boxes[:, 3] - d_boxes[:, 1])

        nd, ng = len(d_boxes), len(g_boxes)
        t = len(IOU_THRS)
        ious = bbox_iou_xyxy(d_boxes, g_boxes, g_crowd) if nd and ng else np.zeros((nd, ng))

        out = {"img": img_id, "cat": cat, "scores": d_scores, "d_area": d_area}

        # Native fast path (csrc/coco_eval.cpp — the pycocotools-C-extension
        # equivalent); identical semantics to the numpy loop below.
        from snn_automotive_object_detection_tpu_torch.evaluation._native import (
            coco_match_native,
        )

        native = coco_match_native(
            ious, d_area, g_crowd.astype(np.uint8), g_area, IOU_THRS,
            np.asarray(list(AREA_RNG.values())),
        )
        if native is not None:
            dtm_n, dt_ig_n, num_gt_n = native
            for ai in range(len(AREA_RNG)):
                out[f"dtm_{ai}"] = dtm_n[ai]
                out[f"dtIg_{ai}"] = dt_ig_n[ai].astype(bool)
                out[f"num_gt_{ai}"] = int(num_gt_n[ai])
            return out

        for ai, (lo, hi) in enumerate(AREA_RNG.values()):
            g_ig = g_crowd | (g_area < lo) | (g_area > hi)
            # GT order: non-ignored first (stable), pycocotools gtind.
            gt_order = np.argsort(g_ig, kind="mergesort")
            gtm = np.zeros((t, ng), np.int64) - 1
            dtm = np.zeros((t, nd), np.int64) - 1
            dt_ig = np.zeros((t, nd), bool)
            for ti, thr in enumerate(IOU_THRS):
                for di in range(nd):
                    best_iou = min(thr, 1 - 1e-10)
                    best_g = -1
                    for gi in gt_order:
                        if gtm[ti, gi] >= 0 and not g_crowd[gi]:
                            continue
                        # Best non-ignored match found and this gt is
                        # ignored: later gts are all ignored -> stop.
                        if best_g >= 0 and not g_ig[best_g] and g_ig[gi]:
                            break
                        if ious[di, gi] < best_iou:
                            continue
                        best_iou = ious[di, gi]
                        best_g = gi
                    if best_g >= 0:
                        dtm[ti, di] = best_g
                        gtm[ti, best_g] = di
                        dt_ig[ti, di] = g_ig[best_g]
            # Unmatched dets outside the area range are ignored.
            a_out = (d_area < lo) | (d_area > hi)
            dt_ig |= (dtm < 0) & a_out[None, :]
            out[f"dtm_{ai}"] = dtm
            out[f"dtIg_{ai}"] = dt_ig
            out[f"num_gt_{ai}"] = int((~g_ig).sum())
        return out

    def evaluate(self):
        self._eval = [
            e
            for cat in self.cat_ids
            for img_id in self.img_ids
            if (e := self._img_cat_eval(img_id, cat)) is not None
        ]

    # ------------------------------------------------------------ accumulate

    def accumulate(self):
        if self._eval is None:
            self.evaluate()
        t, r = len(IOU_THRS), len(REC_THRS)
        k, a, m = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((t, r, k, a, m))
        recall = -np.ones((t, k, a, m))
        scores_out = -np.ones((t, r, k, a, m))

        by_cat = defaultdict(list)
        for e in self._eval:
            by_cat[e["cat"]].append(e)

        for ki, cat in enumerate(self.cat_ids):
            entries = by_cat.get(cat, [])
            for ai in range(a):
                num_gt = sum(e[f"num_gt_{ai}"] for e in entries)
                if num_gt == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in entries]
                    ) if entries else np.zeros(0)
                    order = np.argsort(-scores, kind="mergesort")
                    scores_sorted = scores[order]
                    dtm = np.concatenate(
                        [e[f"dtm_{ai}"][:, :max_det] for e in entries], axis=1
                    )[:, order] if entries else np.zeros((t, 0))
                    dt_ig = np.concatenate(
                        [e[f"dtIg_{ai}"][:, :max_det] for e in entries], axis=1
                    )[:, order] if entries else np.zeros((t, 0), bool)

                    tps = (dtm >= 0) & ~dt_ig
                    fps = (dtm < 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

                    for ti in range(t):
                        tp = tp_sum[ti]
                        fp = fp_sum[ti]
                        nd = len(tp)
                        rc = tp / num_gt
                        pr = tp / np.maximum(fp + tp, np.finfo(float).eps)
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0

                        # Precision envelope (monotone non-increasing).
                        q = np.zeros(r)
                        ss = np.zeros(r)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = scores_sorted[pi]
                        precision[ti, :, ki, ai, mi] = q
                        scores_out[ti, :, ki, ai, mi] = ss

        self._acc = {"precision": precision, "recall": recall, "scores": scores_out}
        return self._acc

    # ------------------------------------------------------------ summarize

    def _summary(self, ap: bool, iou: Optional[float], area: str, max_det: int):
        acc = self._acc
        ai = AREA_KEYS.index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = acc["precision"][:, :, :, ai, mi]
            if iou is not None:
                s = s[np.isclose(IOU_THRS, iou)]
        else:
            s = acc["recall"][:, :, ai, mi]
            if iou is not None:
                s = s[np.isclose(IOU_THRS, iou)]
        valid = s > -1
        return float(s[valid].mean()) if valid.any() else -1.0

    def summarize(self, verbose: bool = True) -> np.ndarray:
        """The 12 COCO stats (printed like pycocotools)."""
        rows = [
            (True, None, "all", 100), (True, 0.5, "all", 100), (True, 0.75, "all", 100),
            (True, None, "small", 100), (True, None, "medium", 100),
            (True, None, "large", 100),
            (False, None, "all", 1), (False, None, "all", 10), (False, None, "all", 100),
            (False, None, "small", 100), (False, None, "medium", 100),
            (False, None, "large", 100),
        ]
        stats = np.array([self._summary(*r) for r in rows])
        if verbose:
            for (ap, iou, area, md), v in zip(rows, stats):
                kind = "Average Precision" if ap else "Average Recall"
                tag = "(AP)" if ap else "(AR)"
                iou_s = f"{iou:0.2f}      " if iou else "0.50:0.95"
                print(
                    f" {kind}  {tag} @[ IoU={iou_s} | area={area:>6s} | "
                    f"maxDets={md:>3d} ] = {v:0.3f}"
                )
        self.stats = stats
        return stats
