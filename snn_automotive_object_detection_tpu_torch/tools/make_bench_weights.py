"""Train weights of the flagship detector on the synthetic shape set.

Port of ``tools/make_bench_weights.py`` of the JAX package. Random weights
give no foreground score above the box head's 0.4, so a run on them never
reaches the postprocess's full NMS; these weights are trained on the
five-class shape set (``tools/synth_shapes.py``) with a fresh batch drawn
on the device every step, and evaluated on held-out images of another
seed with the COCO protocol (the reference's train.py:271-314).

The flagship configuration (9 classes, T_rpn = 8, T_det = 12, the 768 x
1536 bucket, bf16 with float32 neuron states; ``--bf16-states`` for bf16
states), the backbone frozen unless ``--train-backbone``, SGD with
momentum 0.9 or AdamW (weight decay 1e-5) on a cosine schedule down to
5% of the rate. The weights go to ``--out`` through
``utils/checkpoint.save_checkpoint`` ({"params"}), which the port's CLIs
load with ``--load-model``; ``--save-every`` writes ``<out>.partial``
meanwhile, which the final save removes. It runs on the card unless
``--device cpu`` is given.

    python -m snn_automotive_object_detection_tpu_torch.tools.make_bench_weights \\
        --out bench_weights.pth --steps 2000 --opt adamw --lr 1e-3 --eval-images 64
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from snn_automotive_object_detection_tpu_torch.evaluation.coco_metrics import COCOEval
from snn_automotive_object_detection_tpu_torch.models.factory import (
    DetectorConfig,
    init_params,
)
from snn_automotive_object_detection_tpu_torch.tools.synth_shapes import (
    NUM_SHAPE_CLASSES,
    synth_batch,
)
from snn_automotive_object_detection_tpu_torch.train.optim import (
    build_optimizer,
    merge_params,
    split_trainable,
)
from snn_automotive_object_detection_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
)
from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_weights_lenient,
    save_checkpoint,
)
from snn_automotive_object_detection_tpu_torch.utils.weights import tree_leaves

HELDOUT_SEED = 987
LOG_EVERY = 50


def bench_config(bf16_states: bool = False, **overrides) -> DetectorConfig:
    """The flagship configuration; ``overrides`` replace its fields (the
    tests' small bucket)."""
    config = DetectorConfig(num_classes=9, t_rpn=8, t_det=12,
                            snn_state_dtype=None if bf16_states else torch.float32)
    return dataclasses.replace(config, **overrides)


def evaluate_heldout(config, params, n_images: int, batch: int,
                     seed: int = HELDOUT_SEED) -> Tuple[np.ndarray, Dict[int, float]]:
    """COCO mAP over ``n_images`` fresh images of the shape set from a
    generator seeded with ``seed`` (training draws from other seeds).
    Returns (the 12 stats, {class: AP@[.5:.95]}); only foreground rows
    (label > 0) enter the metric."""
    device = tree_leaves(params)[0].device
    eval_step = make_eval_step(config)
    h, w = config.bucket
    generator = torch.Generator(device=device).manual_seed(seed)
    gt, dets = {}, {}
    img_id = 0
    for _ in range(-(-n_images // batch)):
        b = synth_batch(generator, batch, h, w)
        det = eval_step(params, {k: v for k, v in b.items() if k != "targets"})
        small = {k: det[k].float().cpu().numpy() if det[k].is_floating_point()
                 else det[k].cpu().numpy() for k in ("boxes", "scores", "labels", "valid")}
        tb, tl, tv = (b["targets"][k].cpu().numpy() for k in ("boxes", "labels", "valid"))
        for j in range(batch):
            if img_id >= n_images:
                break
            v = tv[j]
            gt[img_id] = {"boxes": tb[j][v].astype(np.float64), "labels": tl[j][v],
                          "areas": ((tb[j][v, 2] - tb[j][v, 0])
                                    * (tb[j][v, 3] - tb[j][v, 1])).astype(np.float64),
                          "iscrowd": np.zeros(int(v.sum()), np.int64)}
            dv = small["valid"][j] & (small["labels"][j] > 0)
            dets[img_id] = (small["boxes"][j][dv], small["scores"][j][dv],
                            small["labels"][j][dv])
            img_id += 1
    ev = COCOEval(gt, list(range(1, NUM_SHAPE_CLASSES + 1)), list(range(img_id)))
    for iid, (bx, sc, lb) in dets.items():
        ev.add_detections(iid, bx, sc, lb)
    acc = ev.accumulate()
    stats = ev.summarize(verbose=True)
    cls_ap = {}
    pr = acc["precision"][:, :, :, 0, -1]   # all areas, 100 detections
    for ki, cat in enumerate(range(1, NUM_SHAPE_CLASSES + 1)):
        s = pr[:, :, ki]
        cls_ap[cat] = float(s[s > -1].mean()) if (s > -1).any() else -1.0
    return stats, cls_ap


def cosine_schedule(lr: float, steps: int, alpha: float = 0.05):
    """optax's cosine_decay_schedule: ``lr`` decayed to ``alpha`` lr over
    ``steps`` updates, as a function of the count of updates made."""
    def sched(count):
        frac = min(count, steps) / max(steps, 1)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
    return sched


def train(config, params, steps: int, batch: int, lr: float, opt: str = "sgd",
          seed: int = 0, train_backbone: bool = False, save_every: int = 0,
          out: Optional[str] = None):
    """``steps`` updates of ``params`` in place, each on a fresh batch of
    the shape set from a generator seeded with ``seed + 1``; returns the
    trained tree. Writes ``<out>.partial`` every ``save_every`` steps."""
    device = tree_leaves(params)[0].device
    train_config = dataclasses.replace(config, train_backbone=train_backbone)
    trainable, frozen = split_trainable(params, train_backbone=train_backbone)
    if opt == "adamw":
        optimizer, scheduler = build_optimizer(trainable, "AdamW", cosine_schedule(lr, steps),
                                               weight_decay=1e-5)
    else:
        optimizer, scheduler = build_optimizer(trainable, "SGD", cosine_schedule(lr, steps),
                                               momentum=0.9, weight_decay=0.0)
    step = make_train_step(train_config, optimizer, scheduler)
    h, w = config.bucket
    data = torch.Generator(device=device).manual_seed(seed + 1)
    sampler = torch.Generator(device=device).manual_seed(seed + 2)
    t0 = time.perf_counter()
    for i in range(steps):
        losses = step(trainable, frozen, synth_batch(data, batch, h, w), sampler)
        if i % LOG_EVERY == 0 or i == steps - 1:
            vals = {k: float(v) for k, v in sorted(losses.items())}
            print(f"step {i}: " + " ".join(f"{k}={v:.4f}" for k, v in vals.items())
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
            if not all(math.isfinite(v) for v in vals.values()):
                raise FloatingPointError(f"non-finite loss at step {i}: {vals}")
        if save_every and out and i and i % save_every == 0:
            save_checkpoint(out + ".partial", {"params": merge_params(trainable, frozen)})
            print(f"partial checkpoint at step {i}", flush=True)
    return merge_params(trainable, frozen)


def get_args_parser():
    ap = argparse.ArgumentParser(description="Bench weights on the synthetic shape set")
    ap.add_argument("--out", default="bench_weights.pth")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--opt", default="sgd", choices=("sgd", "adamw"),
                    help="adamw converges faster for the frozen-backbone recipe "
                         "(use lr about 1e-3)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-images", type=int, default=64)
    ap.add_argument("--eval-only", action="store_true", help="evaluate --load, no training")
    ap.add_argument("--load", default=None, help="weights to start from or evaluate")
    ap.add_argument("--save-every", type=int, default=1000,
                    help="write <out>.partial every N steps")
    ap.add_argument("--bf16-states", action="store_true",
                    help="bf16 neuron states instead of float32 ones")
    ap.add_argument("--train-backbone", action="store_true",
                    help="train the backbone too (the RPN head then runs as the scan)")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on: the CUDA device unless 'cpu' is asked for")
    return ap


def main(args, config: Optional[DetectorConfig] = None):
    """Trains (unless ``--eval-only``), saves and evaluates; returns (the
    12 held-out stats, per-class AP, the parameters). ``config`` replaces
    the flagship configuration (a test's small bucket)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    config = config or bench_config(args.bf16_states)
    params = init_params(config, torch.Generator(device=device).manual_seed(args.seed),
                         device=device)
    if args.load:
        params = load_weights_lenient(params, load_checkpoint(args.load,
                                                              map_location=device)["params"])
    if not args.eval_only:
        out = os.path.abspath(args.out)
        params = train(config, params, args.steps, args.batch, args.lr, args.opt, args.seed,
                       args.train_backbone, args.save_every, out)
        save_checkpoint(out, {"params": params})
        print(f"saved weights to {out}")
        # The final file supersedes the partial one, which could otherwise
        # be loaded by mistake.
        if os.path.exists(out + ".partial"):
            os.remove(out + ".partial")
    stats, cls_ap = evaluate_heldout(config, params, args.eval_images, args.batch)
    print("held-out per-class AP@[.5:.95]:", {k: round(v, 4) for k, v in cls_ap.items()})
    print(f"held-out mAP@[.5:.95] = {stats[0]:.4f}  AP50 = {stats[1]:.4f}")
    return stats, cls_ap, params


if __name__ == "__main__":
    main(get_args_parser().parse_args())
