"""Open-set new-object discovery from the port's exported proposals and
detections.

The port's counterpart of the JAX package's ``cli/new_object_discovery.py``
(the reference's new_object_discovery.py), on the ``.npz`` dump that
``cli/train.py -ext-prop-det`` writes. Host code in numpy, as the JAX CLI
has it:

  1. drop background (label-0) boxes with IoU > --iou-thr against any known
     detection (:87-120)
  2. score each surviving BG box as sum_j IoU(bg, proposal_j) * objectness_j
     (:147-153)
  3. NMS on the new-object scores (:156)
  4. remove BG boxes overlapping the dataset's ego-vehicle region
     (cityscapes: [0.15W, 0.8H, W, H]; bdd: [0, 0.9H, W, H], :125-134)
  5. with --save-images, render known (green) vs "unk" (red) panels
     (Matplotlib); always write params.txt

``-d`` is a dataset name or the path of a YAML or JSON dataset config; the
ego-vehicle region follows its ``dataset`` key (cityscapes or bdd).

    python -m snn_automotive_object_detection_tpu_torch.cli.new_object_discovery \\
        -d cityscapes -f outputs/cityscapes/test_results_per_img_cityscapes.npz -s 10
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def get_args_parser(add_help=True):
    p = argparse.ArgumentParser(description="New object discovery (PyTorch/CUDA)",
                                add_help=add_help)
    p.add_argument("-d", "--dataset", required=True,
                   help="cityscapes, bdd, or the path of a dataset config of either")
    p.add_argument("-f", "--file", required=True,
                   help=".npz dump from cli/train.py -ext-prop-det")
    p.add_argument("--only-known-cls", dest="only_known_cls", action="store_true")
    p.add_argument("-s", "--save-images", dest="save_images", type=int, default=0)
    p.add_argument("-iou", "--iou-thr", dest="iou_thr", type=float, default=0.05)
    p.add_argument("-sc", "--score-thr", dest="score_thr", type=float, default=0.25)
    p.add_argument("-nms", "--nms-thr", dest="nms_thr", type=float, default=0.5)
    p.add_argument("-max", "--max-detections", dest="max_detections", type=int,
                   default=0)
    p.add_argument("--data-root", dest="data_root", default="")
    return p


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = aa[:, None] + ab[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, thr: float) -> np.ndarray:
    order = np.argsort(-scores, kind="stable")
    iou = iou_matrix(boxes, boxes)
    suppressed = np.zeros(len(boxes), bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > thr
        suppressed[i] = True
    return np.asarray(keep, np.int64)


EGO_BBOX = {
    # dataset: (W, H, [x1, y1, x2, y2])
    "cityscapes": (2048, 1024, [int(0.15 * 2048), int(0.8 * 1024), 2048, 1024]),
    "bdd": (1280, 720, [0, int(0.9 * 720), 1280, 720]),
}


def discover(detections, dataset: str, iou_thr: float, nms_thr: float,
             max_detections: int = 0):
    """Run the 4 filtering stages; returns one dict per image: image_id,
    known {boxes, labels, scores}, new_boxes, new_object_scores."""
    ego = np.asarray(EGO_BBOX[dataset][2], np.float64)[None]

    out = []
    for det in detections:
        labels = np.asarray(det["labels"])
        boxes = np.asarray(det["boxes"], np.float64)
        scores = np.asarray(det["scores"], np.float64)
        is_bg = labels == 0
        known = {"boxes": boxes[~is_bg], "labels": labels[~is_bg],
                 "scores": scores[~is_bg]}
        bg_boxes = boxes[is_bg]

        # 1. drop BG overlapping known detections
        if len(known["boxes"]):
            overlap = iou_matrix(bg_boxes, known["boxes"]).max(axis=1) > iou_thr
        else:
            overlap = np.zeros(len(bg_boxes), bool)
        bg_boxes = bg_boxes[~overlap]

        # 2. new-object score from pre-NMS proposals x objectness
        proposals = np.asarray(det["proposals"], np.float64)
        objness = np.asarray(det["objectness"], np.float64)
        nos = (iou_matrix(bg_boxes, proposals) * objness[None, :]).sum(axis=1)

        # 3. NMS on the new-object scores
        keep = greedy_nms(bg_boxes, nos, nms_thr)
        bg_boxes, nos = bg_boxes[keep], nos[keep]

        # 4. ego-vehicle exclusion
        keep = iou_matrix(bg_boxes, ego).max(axis=1) == 0 if len(bg_boxes) else \
            np.zeros(0, bool)
        bg_boxes, nos = bg_boxes[keep], nos[keep]

        if max_detections:
            bg_boxes = bg_boxes[:max_detections]
            nos = nos[:max_detections]

        out.append({
            "image_id": det.get("image_id", -1),
            "known": known,
            "new_boxes": bg_boxes,
            "new_object_scores": nos,
        })
    return out


def save_panels(processed, cfg, args, out_dir) -> int:
    """Known (green) and new (red, "unk") boxes on up to ``args.save_images``
    validation images; returns how many were written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from snn_automotive_object_detection_tpu_torch.data import create_dataset
    from snn_automotive_object_detection_tpu_torch.utils.config import class_names
    from snn_automotive_object_detection_tpu_torch.utils.plotting import (
        draw_boxes,
        image_with_boxes,
    )

    names = class_names(cfg)
    known_classes = cfg.get("known_classes") if args.only_known_cls else None
    if known_classes:
        names = {int(c["id"]): c["name"] for c in known_classes}
    ds = create_dataset(cfg["dataset"], "validation", only_known_cls=args.only_known_cls,
                        data_root=args.data_root or None, cfg=cfg)
    id_to_idx = {img_id: i for i, img_id in enumerate(getattr(ds, "ids", range(len(ds))))}
    count = 0
    for p in processed:
        if count >= args.save_images:
            break
        idx = id_to_idx.get(p["image_id"])
        if idx is None:
            continue
        image, _ = ds[idx]
        fig = image_with_boxes(image, p["known"]["boxes"], p["known"]["labels"],
                               p["known"]["scores"], names, color="green")
        sel = p["new_object_scores"] > args.score_thr
        draw_boxes(fig.axes[0], p["new_boxes"][sel], labels=np.zeros(int(sel.sum()), int),
                   scores=p["new_object_scores"][sel], color="red", class_names={0: "unk"})
        fig.savefig(os.path.join(out_dir, f"nod_{count:04d}.png"))
        plt.close(fig)
        count += 1
    print(f"wrote {count} NOD panels to {out_dir}")
    return count


def main(args):
    """Runs the discovery; returns the processed list."""
    from snn_automotive_object_detection_tpu_torch.utils.config import load_dataset_config

    cfg = load_dataset_config(args.dataset, args.data_root or None)
    dataset = cfg["dataset"]
    if dataset not in EGO_BBOX:
        raise ValueError(f"new-object discovery has an ego-vehicle region for "
                         f"{sorted(EGO_BBOX)}, not {dataset!r}")
    out_dir = os.path.join(cfg.get("out_dir", f"outputs/{dataset}"), f"new_objects_{dataset}")
    os.makedirs(out_dir, exist_ok=True)

    detections = list(np.load(args.file, allow_pickle=True)["results"])
    processed = discover(detections, dataset, args.iou_thr, args.nms_thr, args.max_detections)

    n_new = sum(len(p["new_boxes"]) for p in processed)
    n_conf = sum((p["new_object_scores"] > args.score_thr).sum() for p in processed)
    print(f"{len(processed)} images: {n_new} candidate new objects, "
          f"{n_conf} above score_thr={args.score_thr}")

    with open(os.path.join(out_dir, "params.txt"), "w") as f:
        for k, v in sorted(vars(args).items()):
            f.write(f"{k} = {v}\n")

    if args.save_images:
        save_panels(processed, cfg, args, out_dir)
    return processed


if __name__ == "__main__":
    main(get_args_parser().parse_args())
