"""Train and evaluate the (spiking) Faster R-CNN with the PyTorch/CUDA port.

The port's counterpart of the JAX package's ``cli/train.py`` (the
reference's train.py flag surface): training with checkpoints and resume,
COCO evaluation, the new-object-discovery dump, spike-rate extraction and
the energy report, noise, prediction panels and a ``torch.profiler`` trace.
It runs on the CUDA device unless ``--device cpu`` is given (the tests do),
and needs neither JAX, OpenCV, PyYAML, Pillow nor Matplotlib where its
inputs do not: a
dataset or model config given as ``.json`` and images stored as ``.npy``
load with the standard library and numpy; ``--plot-images`` draws with
Matplotlib.

Numerics as the reference maps its flags: ``--fp32`` computes in float32
(the reference's scans, no kernel); ``--amp`` (the default) in bf16 with
float32 neuron states; ``--no-amp`` in bf16 with bf16 neuron states.

Examples::

    python -m snn_automotive_object_detection_tpu_torch.cli.train -d cityscapes \\
        --rpn-snn --detector-snn -t-rpn 8 -t-det 12 \\
        --load-model model_Cityscapes_SNN_Trpn8_Tdet12.pth --test-only

    python -m snn_automotive_object_detection_tpu_torch.cli.train -d cityscapes \\
        --rpn-snn --detector-snn --freeze-detector --epochs 25 --lr 5e-4 \\
        --lr-decay-milestones 10 15 20

Checkpoints: after every epoch ``model_<save name>_<epoch>.pth`` holds the
weights ({"params", "args"}, for ``--load-model``) and ``checkpoint.pth``
the whole training state (weights, optimizer, scheduler, epoch; for
``--resume``), both written with ``torch.save``.

Several processes, one card each (torchrun's or SLURM's variables,
``parallel/mesh.py``; NCCL between cards, gloo with ``--device cpu``)::

    torchrun --nproc_per_node=4 -m snn_automotive_object_detection_tpu_torch.cli.train \
        -d cityscapes --rpn-snn --detector-snn -b 2 --epochs 25

Each rank loads its shard of every split (``-b`` images a step on each
rank), starts from rank 0's weights and takes data-parallel steps over the
global batch (``train/steps.py``); evaluation gathers every rank's
detections, so all ranks report the same stats. Rank 0 writes the
checkpoints; every rank writes the hyperparameter dump and its scalars, as
the JAX package's CLI does.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import pickle
import time

import numpy as np
import torch

from snn_automotive_object_detection_tpu_torch.data import create_dataset
from snn_automotive_object_detection_tpu_torch.data.loader import (
    DetectionLoader,
    to_device_batch,
)
from snn_automotive_object_detection_tpu_torch.data.transforms import (
    eval_transform,
    train_transform,
)
from snn_automotive_object_detection_tpu_torch.evaluation import CocoEvaluator
from snn_automotive_object_detection_tpu_torch.models.factory import create_model
from snn_automotive_object_detection_tpu_torch.parallel.collectives import parallel_world
from snn_automotive_object_detection_tpu_torch.parallel.mesh import (
    init_distributed,
    rank_device,
    replicate,
)
from snn_automotive_object_detection_tpu_torch.train.optim import (
    build_optimizer,
    build_schedule,
    merge_params,
    split_trainable,
)
from snn_automotive_object_detection_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    make_val_loss_step,
)
from snn_automotive_object_detection_tpu_torch.utils import energy as energy_mod
from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_torch_backbone,
    load_torch_checkpoint,
    load_weights_lenient,
    save_checkpoint,
)
from snn_automotive_object_detection_tpu_torch.utils.config import (
    class_names,
    load_dataset_config,
    load_model_yaml,
)
from snn_automotive_object_detection_tpu_torch.utils.logging import MetricLogger, ScalarWriter
from snn_automotive_object_detection_tpu_torch.utils.weights import tree_leaves

RATE_KEYS = ("rpn_rates", "det_rates")


def get_args_parser(add_help: bool = True):
    p = argparse.ArgumentParser(description="SNN detection training (PyTorch/CUDA)",
                                add_help=add_help)
    p.add_argument("-d", "--dataset", required=True,
                   help="cityscapes | bdd | idd | pascal | coco, or a path to a dataset "
                        "config (YAML, or JSON of the same keys)")
    p.add_argument("-t-rpn", "--rpn-steps", dest="num_steps_rpn", type=int, default=12)
    p.add_argument("-t-det", "--det-steps", dest="num_steps_detector", type=int, default=16)
    p.add_argument("--save-name", default="", type=str)
    p.add_argument("-b", "--batch-size", type=int, default=2, help="images per batch")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("-j", "--workers", type=int, default=4)
    p.add_argument("--opt", default="AdamW", type=str, help="AdamW or SGD")
    p.add_argument("--lr", type=float, default=0.0025)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", "--weight-decay", dest="weight_decay", type=float, default=1e-4)
    p.add_argument("--lr-decay-milestones", dest="lr_decay_milestones", type=int, nargs="+",
                   default=[])
    p.add_argument("--lr-decay-step", dest="lr_decay_step", type=int, default=0)
    p.add_argument("--lr-decay-rate", dest="lr_decay_rate", type=float, default=0.5)
    p.add_argument("--constant-lr-scheduler", dest="constant_lr_scheduler", type=float,
                   default=0)
    p.add_argument("--print-freq", type=int, default=20)
    p.add_argument("--start-epoch", dest="start_epoch", type=int, default=1)
    p.add_argument("--resume", default="", type=str,
                   help="checkpoint.pth written by this program")
    p.add_argument("--load-model", dest="load_model", default="", type=str,
                   help="weights: a reference .pth, or a checkpoint of this program")
    p.add_argument("--pretrained-backbone", dest="pretrained_backbone", default="", type=str,
                   help="local torchvision ImageNet classification .pth (resnet50 / "
                        "mobilenet_v3_large) to seed the backbone trunk")
    p.add_argument("--validate-every-n-epochs", dest="validate_every_n_epochs", type=int,
                   default=1)
    p.add_argument("--test-only", dest="test_only", action="store_true")
    p.add_argument("--plot-images", dest="plot_images", action="store_true")
    p.add_argument("--save-images", dest="save_images", action="store_true")
    p.add_argument("--save-images-option", dest="save_images_option",
                   default="imgs_and_preds", choices=["imgs_and_preds", "one_img_preds"])
    p.add_argument("--max-plot-images", dest="max_plot_images", type=int, default=50,
                   help="cap on --plot-images/--save-images panels")
    p.add_argument("--trainable-backbone-layers", dest="trainable_backbone_layers",
                   default=0, type=int, choices=range(0, 6),
                   help="train the top N ResNet stages (1 -> layer4 ... 5 -> + stem)")
    p.add_argument("--freeze-fpn", dest="freeze_fpn", action="store_true")
    p.add_argument("--freeze-rpn", dest="freeze_rpn", action="store_true")
    p.add_argument("--freeze-detector", dest="freeze_detector", action="store_true")
    p.add_argument("--rpn-snn", dest="rpn_snn", action="store_true")
    p.add_argument("--detector-snn", dest="detector_snn", action="store_true")
    p.add_argument("--data-augmentation", dest="data_augmentation", default="hflip")
    p.add_argument("--only-known-cls", dest="only_known_cls", action="store_true")
    p.add_argument("--only-one-bbox", dest="only_one_bbox", action="store_true")
    p.add_argument("-ext-prop-det", "--extract-proposals-and-detections",
                   dest="extract_proposals_and_detections", nargs="+", default=[])
    p.add_argument("-n-img", "--max-num-images-for-nod", dest="max_num_images_for_nod",
                   type=int, default=20000)
    p.add_argument("--rm-bg", dest="rm_bg", action="store_true",
                   help="remove background predictions from detections")
    p.add_argument("--extract-spike-rates", dest="extract_spike_rates", nargs="+", default=[])
    p.add_argument("--add-noise", dest="add_noise", default="",
                   choices=["", "gaussian", "syp", "rain", "light-rain", "heavy-rain"])
    p.add_argument("--noise-intensity", dest="noise_intensity", type=float, default=0.05)
    p.add_argument("--data-root", dest="data_root", default="", type=str)
    p.add_argument("--out-dir", dest="out_dir_override", default="", type=str)
    p.add_argument("--model-config", dest="model_config", default="", type=str,
                   help="model hyperparameters (configs/model.yaml, or JSON of its keys)")
    p.add_argument("--backbone", default="resnet50_fpn",
                   choices=["resnet50_fpn", "mobilenet_v3_large_fpn",
                            "mobilenet_v3_large_320_fpn"])
    p.add_argument("--fp32", action="store_true",
                   help="compute in float32 instead of bfloat16")
    p.add_argument("--amp", default=True, action=argparse.BooleanOptionalAction,
                   help="bf16 convolutions and GEMMs with float32 neuron states (the "
                        "reference's default-on AMP numerics); --no-amp carries the states "
                        "in bf16 too; --fp32 overrides both")
    p.add_argument("--profile", default="", type=str,
                   help="write a torch.profiler trace of the first evaluation or "
                        "training epoch to this directory; it carries the port's "
                        "spans (utils/spans.py) around each layer of every batch")
    p.add_argument("--device", default="cuda", type=str,
                   help="the device to run on: the CUDA device unless 'cpu' is asked for")
    p.add_argument("--seed", type=int, default=0)
    return p


class _Profile:
    """A ``torch.profiler`` trace of the block into ``log_dir`` (none
    without one), written as a Chrome trace when the block ends. The
    profiler switches on the port's spans (``utils/spans.py``): each batch
    shows as a ``detector`` or ``train.step`` range with a range for each
    layer inside it, on the host's timeline and the device's."""

    def __init__(self, log_dir: str, device: torch.device):
        self.log_dir = log_dir
        self.device = device
        self.prof = None

    def __enter__(self):
        if self.log_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir, "trace.json")
            self.prof.export_chrome_trace(path)
            print(f"[profile] trace written to {path}")
        return False


# --------------------------------------------------------------- helpers


def run_device(args) -> torch.device:
    """Start the process group from the environment, if the launcher
    started several processes (the JAX package's CLI does so first), and
    return this rank's device: ``--device cuda`` is the rank's card."""
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    init_distributed(args.device)
    return rank_device(args.device)


def build_everything(args):
    """(dataset config, output directory, model config, parameters on
    this rank's device (:func:`run_device`), make_loader(split, training) -> (dataset, loader))."""
    cfg = load_dataset_config(args.dataset, args.data_root or None)
    out_dir = args.out_dir_override or cfg.get("out_dir", f"outputs/{cfg['dataset']}")
    os.makedirs(out_dir, exist_ok=True)
    model_yaml = load_model_yaml(args.model_config) if args.model_config else None
    num_classes = len(cfg["known_classes"]) if args.only_known_cls else cfg["num_classes"]
    config, params = create_model(
        dataset_name=cfg["dataset"], num_classes=num_classes, rpn_snn=args.rpn_snn,
        detector_snn=args.detector_snn, num_steps_rpn=args.num_steps_rpn,
        num_steps_detector=args.num_steps_detector, only_one_bbox=args.only_one_bbox,
        seed=args.seed, compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
        snn_state_dtype=torch.float32 if args.amp and not args.fp32 else None,
        model_yaml=model_yaml, backbone=args.backbone, device=run_device(args))
    if args.trainable_backbone_layers:
        config = dataclasses.replace(config,
                                     trainable_backbone_layers=args.trainable_backbone_layers)
        config.backbone_trainable_stages  # the backbone must have stages to train
    rank, world = parallel_world()
    rng = np.random.default_rng(args.seed + rank)

    def make_loader(split, training):
        tf = (train_transform(args.data_augmentation, rng) if training
              else eval_transform(args.add_noise, args.noise_intensity, rng))
        ds = create_dataset(args.dataset, split, transforms=tf,
                            only_known_cls=args.only_known_cls,
                            data_root=args.data_root or None, cfg=cfg)
        # A static batch shape pads a partial last batch by repeating an
        # image, which would bias gradients: training drops it.
        loader = DetectionLoader(ds, batch_size=args.batch_size, bucket=config.bucket,
                                 min_size=config.min_size, max_size=config.max_size,
                                 shuffle=training, seed=12, num_workers=args.workers,
                                 shard=(rank, world), drop_last=training)
        return ds, loader

    return cfg, out_dir, config, params, make_loader


def _read_weights(path: str, config, device):
    """The parameter tree in ``path``: a checkpoint this program wrote
    ({"params": ...}), or a reference ``.pth`` converted for the
    configured heads."""
    try:
        obj = load_checkpoint(path, map_location=device)
    except pickle.UnpicklingError:   # a reference checkpoint with pickled objects
        obj = None
    if isinstance(obj, dict) and "params" in obj:
        return obj["params"]
    return load_torch_checkpoint(path, rpn_snn=config.rpn_snn,
                                 detector_snn=config.detector_snn,
                                 only_one_bbox=config.only_one_bbox, device=device)


def load_weights(args, config, params):
    """``--pretrained-backbone`` (the trunk only), then ``--load-model``
    over it, both lenient: leaves of another shape keep their values. With
    a process group, every rank then holds rank 0's weights."""
    device = tree_leaves(params)[0].device
    if args.pretrained_backbone:
        params = load_weights_lenient(params, {"backbone": load_torch_backbone(
            args.pretrained_backbone, device=device)})
    if args.load_model:
        params = load_weights_lenient(params, _read_weights(args.load_model, config, device))
    return replicate(params)


def _host_det(det):
    """A detections dict's tensors on the host as numpy, rates left out."""
    return {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
            for k, v in det.items() if k not in RATE_KEYS and k != "rates"}


def compute_mean_avg_precision(eval_step, params, loader, dataset, device, rm_bg=False,
                               print_freq=100):
    """COCO mAP over a loader (the reference's train.py:271-314). Returns
    the 12 stats and prints the images/s of the detection loop."""
    evaluator = CocoEvaluator(dataset, remove_bg=rm_bg)
    logger = MetricLogger()
    n_images = 0
    t0 = time.perf_counter()
    for batch in logger.log_every(loader, print_freq, "Test:"):
        det = _host_det(eval_step(params, to_device_batch(batch, device)))
        res = {}
        for i, real in enumerate(batch["pad_mask"]):
            if real:
                res[int(batch["image_ids"][i])] = {k: det[k][i] for k in
                                                   ("boxes", "scores", "labels", "valid")}
                n_images += 1
        evaluator.update(res)
    dt = time.perf_counter() - t0
    print(f"Time spent generating detections: {datetime.timedelta(seconds=int(dt))} "
          f"({n_images / dt:.3f} images/sec)")
    logger.synchronize_between_processes()
    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    return evaluator.summarize()


NOD_KEYS = ("all_scores", "all_boxes", "proposals", "objectness")


def extract_proposals_and_detections(eval_step, params, loader, out_path, max_images,
                                     device):
    """New-object-discovery dump (train.py:233-260): per image {image_id,
    boxes, labels, scores (the valid detections), all_scores, all_boxes,
    proposals, objectness}, saved as an object array ``results`` in an
    ``.npz`` file; the ANN box head has no all_scores or all_boxes."""
    per_img = []
    for batch in loader:
        det = _host_det(eval_step(params, to_device_batch(batch, device)))
        for i, real in enumerate(batch["pad_mask"]):
            if not real or len(per_img) >= max_images:
                continue
            v = det["valid"][i]
            entry = {"image_id": int(batch["image_ids"][i]), "boxes": det["boxes"][i][v],
                     "labels": det["labels"][i][v], "scores": det["scores"][i][v]}
            entry.update({k: det[k][i] for k in NOD_KEYS if k in det})
            per_img.append(entry)
        if len(per_img) >= max_images:
            break
    np.savez_compressed(out_path, results=np.asarray(per_img, dtype=object),
                        allow_pickle=True)
    print(f"saved {len(per_img)} per-image results to {out_path}")
    return per_img


def extract_spike_rates_run(eval_step, params, loader, config, device, max_batches=None):
    """Spike rates per layer over a loader and the energy report
    (train.py:426-517): the RPN's shared-conv rates per level and image,
    the box head's fc6 and fc7 rates per RoI."""
    import math

    rpn_shared, fc6, fc7 = [], [], []
    n = 0
    for bi, batch in enumerate(loader):
        det = eval_step(params, to_device_batch(batch, device))
        keep = np.asarray(batch["pad_mask"])
        rpn_shared.append(det["rpn_rates"]["shared"].cpu().numpy()[:, keep])
        for out, key in ((fc6, "fc6"), (fc7, "fc7")):
            out.append(det["det_rates"][key].cpu().numpy().reshape(len(keep), -1)[keep]
                       .reshape(-1))
        n += int(keep.sum())
        if max_batches and bi + 1 >= max_batches:
            break
    print(f"Number of images processed: {n}")
    rpn_rates = {"shared": np.concatenate(rpn_shared, axis=1)}
    det_rates = {"fc6": np.concatenate(fc6), "fc7": np.concatenate(fc7)}
    spikes = energy_mod.aggregate_rates(rpn_rates, det_rates, config.t_rpn, config.t_det)
    # Level shapes from the configured backbone's strides (MobileNet has 3).
    h, w = config.bucket
    shapes = [(math.ceil(h / s), math.ceil(w / s)) for s in config.fpn_strides]
    flops = energy_mod.rpn_shared_flops(shapes) + energy_mod.detector_fc_flops(
        num_rois=config.rpn.post_nms_top_n_test)
    names = ([f"LVL_{i}" for i in range(len(shapes) - 1)] + ["pool"]
             + energy_mod.DET_LAYER_NAMES)
    report = energy_mod.energy_report(spikes, flops, layer_names=names)
    return {"rpn_rates": rpn_rates, "det_rates": det_rates, "report": report}


def dump_hyperparams(path, args, config, params):
    """The flags, the configuration and which top-level modules the freeze
    flags train, with their parameter counts (custom_utils.py:236-338)."""
    lines = [f"{k} = {v}" for k, v in sorted(vars(args).items())]
    lines.append(f"config = {config}")
    lines.append(f"total parameters = {sum(x.numel() for x in tree_leaves(params))}")
    trainable, frozen = split_trainable(
        params, args.freeze_fpn, args.freeze_rpn, args.freeze_detector,
        trainable_backbone_layers=args.trainable_backbone_layers)
    lines.append("--- module audit ---")
    for status, tree in (("TRAINABLE", trainable), ("FROZEN", frozen)):
        for name, sub in sorted(tree.items()):
            lines.append(f"{status:9s} {name}: {sum(x.numel() for x in tree_leaves(sub))} "
                         f"params")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _split_of(split: str) -> str:
    return "train" if split == "train" else "validation"


def save_panels(eval_step, params, loader, names, out_dir, option, max_images, device):
    """Prediction panels (train.py:329-423) of up to ``max_images`` images."""
    from snn_automotive_object_detection_tpu_torch.utils.plotting import save_prediction_panel

    img_dir = os.path.join(out_dir, "pred_images")
    count = 0
    for batch in loader:
        det = _host_det(eval_step(params, to_device_batch(batch, device)))
        for i, real in enumerate(batch["pad_mask"]):
            if not real:
                continue
            v = det["valid"][i]
            h, w = batch["image_sizes"][i]
            oh, ow = batch["original_sizes"][i]
            pred = {"boxes": det["boxes"][i][v] * np.array([w / ow, h / oh, w / ow, h / oh]),
                    "labels": det["labels"][i][v], "scores": det["scores"][i][v]}
            gt = None
            if "targets" in batch:
                gv = batch["targets"]["valid"][i]
                gt = {"boxes": batch["targets"]["boxes"][i][gv],
                      "labels": batch["targets"]["labels"][i][gv]}
            save_prediction_panel(os.path.join(img_dir, f"img_{count:05d}.png"),
                                  batch["images"][i][: int(h), : int(w)], pred, gt, names,
                                  option)
            count += 1
        if count >= max_images:
            break
    print(f"wrote {count} panels to {img_dir}")
    return count


# ------------------------------------------------------------------ main


def main(args):
    device = run_device(args)
    cfg, out_dir, config, params, make_loader = build_everything(args)
    params = load_weights(args, config, params)
    dump_hyperparams(os.path.join(out_dir, "hyperparams.txt"), args, config, params)

    # ---------------- evaluation and analysis
    if args.test_only:
        ds, loader = make_loader("validation", training=False)
        with _Profile(args.profile, device):
            return compute_mean_avg_precision(make_eval_step(config), params, loader, ds,
                                              device, rm_bg=args.rm_bg,
                                              print_freq=args.print_freq)

    if args.extract_proposals_and_detections:
        eval_step = make_eval_step(config)
        for split in args.extract_proposals_and_detections:
            _, loader = make_loader(_split_of(split), training=False)
            extract_proposals_and_detections(
                eval_step, params, loader,
                os.path.join(out_dir, f"{split}_results_per_img_{cfg['dataset']}.npz"),
                args.max_num_images_for_nod, device)
        return None

    if args.extract_spike_rates:
        eval_step = make_eval_step(config, collect_rates=True)
        for split in args.extract_spike_rates:
            _, loader = make_loader(_split_of(split), training=False)
            res = extract_spike_rates_run(eval_step, params, loader, config, device)
            np.savez(os.path.join(out_dir, f"spike_rates_{split}_{cfg['dataset']}.npz"),
                     **res["rpn_rates"], **res["det_rates"])
        return None

    if args.plot_images or args.save_images:
        _, loader = make_loader("validation", training=False)
        save_panels(make_eval_step(config), params, loader, class_names(cfg), out_dir,
                    args.save_images_option, args.max_plot_images, device)
        return None

    # ---------------- training
    start_epoch = args.start_epoch
    state = None
    if args.resume:
        if args.load_model:
            raise NotImplementedError("--resume with --load-model is not supported (as in "
                                      "the reference, train.py:651)")
        state = load_checkpoint(args.resume, map_location=device)
        params = replicate(load_weights_lenient(params, state["params"]))
        start_epoch = int(state["epoch"]) + 1
    trainable, frozen = split_trainable(
        params, args.freeze_fpn, args.freeze_rpn, args.freeze_detector,
        trainable_backbone_layers=args.trainable_backbone_layers)
    _, train_loader = make_loader("train", training=True)
    _, val_loader = make_loader("validation", training=False)
    schedule = build_schedule(args.lr, max(len(train_loader), 1),
                              milestones=args.lr_decay_milestones,
                              gamma=args.lr_decay_rate or 0.5, step_size=args.lr_decay_step,
                              constant_factor=args.constant_lr_scheduler)
    optimizer, scheduler = build_optimizer(trainable, args.opt, schedule, args.momentum,
                                           args.weight_decay)
    if state is not None:
        optimizer.load_state_dict(state["optimizer"])
        if scheduler is not None and state.get("scheduler") is not None:
            scheduler.load_state_dict(state["scheduler"])
    train_step = make_train_step(config, optimizer, scheduler)
    val_step = make_val_loss_step(config)
    # One seed on every rank: each draws the global batch's sampler draws
    # and keeps its own rows (parallel/collectives.rank_rand).
    generator = torch.Generator(device=device).manual_seed(args.seed)
    writer = ScalarWriter(os.path.join(out_dir, "runs",
                                       datetime.datetime.now().strftime("%y%m%d_%H%M")))
    global_step = 0
    t_start = time.time()
    for epoch in range(start_epoch, args.epochs + 1):
        train_loader.set_epoch(epoch)
        logger = MetricLogger()
        with _Profile(args.profile if epoch == start_epoch else "", device):
            for batch in logger.log_every(train_loader, args.print_freq, f"Epoch: [{epoch}]"):
                losses = train_step(trainable, frozen, to_device_batch(batch, device, True),
                                    generator)
                losses = {k: float(v) for k, v in losses.items()}
                logger.update(**losses)
                for k, v in losses.items():
                    writer.add_scalar(f"Loss/MiniBatch/{k}", v, global_step)
                global_step += 1
        logger.synchronize_between_processes()
        for k, m in logger.meters.items():
            writer.add_scalar(f"Loss/Epochs/{k}", m.global_avg, epoch)

        merged = merge_params(trainable, frozen)
        name = f"model_{args.save_name or cfg['dataset']}_{epoch}.pth"
        save_checkpoint(os.path.join(out_dir, name), {"params": merged}, args=vars(args))
        save_checkpoint(os.path.join(out_dir, "checkpoint.pth"),
                        {"params": merged, "optimizer": optimizer, "scheduler": scheduler,
                         "epoch": epoch}, args=vars(args))

        if epoch % args.validate_every_n_epochs == 0:
            vlogger = MetricLogger()
            for batch in vlogger.log_every(val_loader, args.print_freq, f"Val: [{epoch}]"):
                vl = val_step(merged, to_device_batch(batch, device, True), generator)
                vlogger.update(**{k: float(v) for k, v in vl.items()})
            vlogger.synchronize_between_processes()
            for k, m in vlogger.meters.items():
                writer.add_scalar(f"Loss/Epochs/val_{k}", m.global_avg, epoch)
    print(f"Training time {datetime.timedelta(seconds=int(time.time() - t_start))}")
    writer.close()
    return None


if __name__ == "__main__":
    main(get_args_parser().parse_args())
