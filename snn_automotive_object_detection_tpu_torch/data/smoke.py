"""Data-pipeline smoke check (the reference's datasets.py:177-214 __main__
block): build the validation set, iterate a few loader batches, and render
one ground-truth panel so a human can eyeball that images, boxes, and the
class table line up after the resize/bucket pipeline.

Copy of ``snn_automotive_object_detection_tpu/data/smoke.py`` on the
PyTorch port's loader.

Usage:
    python -m snn_automotive_object_detection_tpu_torch.data.smoke -d cityscapes
    python -m ...data.smoke -d path/to/ds.yaml --batches 5 -b 2 --out gt.png

Unlike the reference block (hard-coded dataset name, plt.show()), this takes
the dataset by flag and always writes the panel to --out so it works headless
and under test (tests/test_torch_data.py).
"""

from __future__ import annotations

import argparse

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser(
        description="iterate the detection loader and render one GT panel")
    p.add_argument("-d", "--dataset", required=True,
                   help="dataset name (cityscapes/bdd/idd/pascal/coco) or a "
                   "dataset YAML path")
    p.add_argument("--set", default="validation",
                   choices=("train", "validation"))
    p.add_argument("--batches", type=int, default=20,
                   help="loader iterations (reference used 20)")
    p.add_argument("-b", "--batch-size", type=int, default=2)
    p.add_argument("--bucket", type=int, nargs=2, default=(768, 1536),
                   metavar=("H", "W"))
    p.add_argument("-j", "--workers", type=int, default=4)
    p.add_argument("--data-root", default=None)
    p.add_argument("--out", default="smoke_gt_panel.png",
                   help="where to write the GT panel image")
    return p


def main(args):
    from snn_automotive_object_detection_tpu_torch.data.loader import (
        DetectionLoader,
    )
    from snn_automotive_object_detection_tpu_torch.data.registry import (
        create_dataset,
    )
    from snn_automotive_object_detection_tpu_torch.data.transforms import (
        eval_transform,
    )
    from snn_automotive_object_detection_tpu_torch.utils.config import (
        class_names, load_dataset_config,
    )
    from snn_automotive_object_detection_tpu_torch.utils.plotting import (
        save_prediction_panel,
    )

    cfg = load_dataset_config(args.dataset, args.data_root)
    ds = create_dataset(cfg["dataset"], set_option=args.set,
                        transforms=eval_transform(), cfg=cfg)
    print(f"{cfg['dataset']} {args.set}: {len(ds)} images, "
          f"{cfg.get('num_classes')} classes")

    hb, wb = args.bucket
    loader = DetectionLoader(ds, args.batch_size, (hb, wb),
                             min_size=hb, max_size=wb, shuffle=True,
                             num_workers=args.workers)
    batch = None
    for i, batch in enumerate(loader):
        if i + 1 >= args.batches:
            break
        n_valid = int(batch["targets"]["valid"].sum())
        print(f"batch {i}: images {batch['images'].shape} "
              f"sizes {batch['image_sizes'].tolist()} gt_boxes {n_valid}")
    assert batch is not None, "loader yielded no batches"

    # One GT panel from the last batch (the reference rendered images[1]
    # with create_img_with_bboxes; we take image 0, whose slot always holds
    # a real image even in a padded final batch).
    img = np.clip(batch["images"][0], 0.0, 1.0)
    v = batch["targets"]["valid"][0]
    gt = {"boxes": batch["targets"]["boxes"][0][v],
          "labels": batch["targets"]["labels"][0][v]}
    save_prediction_panel(args.out, img, gt, class_names=class_names(cfg),
                          option="one_img_preds")
    print(f"wrote GT panel to {args.out}")


if __name__ == "__main__":
    main(get_args_parser().parse_args())
