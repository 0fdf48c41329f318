"""Optimizers, learning-rate schedules and parameter freezing.

Port of ``snn_automotive_object_detection_tpu/train/optim.py`` (the
reference's train.py:52-63, 679-700, 717-755): AdamW (default) or SGD with
momentum, MultiStepLR / StepLR / ConstantLR schedules stepped per epoch,
and the freeze flags for FPN, RPN and detector. The backbone body is
frozen unless the configuration trains stages of it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from snn_automotive_object_detection_tpu_torch.utils.weights import tree_leaves

Schedule = Union[float, Callable[[int], float]]


def build_schedule(base_lr: float, steps_per_epoch: int,
                   milestones: Sequence[int] = (), gamma: float = 0.5,
                   step_size: int = 0, constant_factor: float = 0.0) -> Schedule:
    """The epoch-indexed schedule as a function of the count of updates
    already made, or the plain ``base_lr`` when nothing varies.

    milestones: MultiStepLR epochs; step_size and gamma: StepLR;
    constant_factor: ConstantLR, the rate times the factor during the first
    epoch only, on top of whichever of the other two was chosen.
    """
    if milestones:
        bounds = sorted(int(m) * steps_per_epoch for m in milestones)

        def base(count):   # a boundary applies from the update with its count on
            return base_lr * gamma ** sum(1 for b in bounds if count >= b)
    elif step_size:
        def base(count):
            return base_lr * gamma ** ((count // steps_per_epoch) // step_size)
    else:
        def base(count):
            return base_lr
    if constant_factor:
        def sched(count):
            first_epoch = count // steps_per_epoch < 1
            return base(count) * (constant_factor if first_epoch else 1.0)
        return sched
    if not milestones and not step_size:
        return base_lr
    return base


def build_optimizer(trainable: Dict[str, Any], opt_name: str = "AdamW",
                    learning_rate: Schedule = 0.0025, momentum: float = 0.9,
                    weight_decay: float = 1e-4
                    ) -> Tuple[torch.optim.Optimizer, Optional[Any]]:
    """(optimizer over the leaves of ``trainable``, scheduler or None): the
    reference's train.py:717-755. A ``learning_rate`` from
    :func:`build_schedule` that is a function comes back as a ``LambdaLR``
    to step after every update."""
    leaves = tree_leaves(trainable)
    scheduled = callable(learning_rate)
    lr = 1.0 if scheduled else float(learning_rate)
    name = opt_name.lower()
    if name == "adamw":
        opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(leaves, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {opt_name!r} (AdamW or SGD)")
    sched = torch.optim.lr_scheduler.LambdaLR(opt, learning_rate) if scheduled else None
    return opt, sched


def split_trainable(params: Dict[str, Any], freeze_fpn: bool = False,
                    freeze_rpn: bool = False, freeze_detector: bool = False,
                    train_backbone: bool = False,
                    trainable_backbone_layers: int = 0
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition the parameter tree into (trainable, frozen) by module, and
    set ``requires_grad`` on the leaves to match (in place: the partitions
    share the tensors of ``params``).

    trainable_backbone_layers = N trains the top N ResNet stages (1: layer4
    ... 5: the stem too); train_backbone means all 5. With no trainable
    stage the FPN is frozen even without freeze_fpn: the detector detaches
    the backbone's output then, so the FPN's gradients are zero, and an
    optimizer's weight decay would erode weights that the reference leaves
    untouched.
    """
    n = 5 if train_backbone else trainable_backbone_layers
    trainable: Dict[str, Any] = {}
    frozen: Dict[str, Any] = {}

    bb = dict(params["backbone"])
    fpn = bb.pop("fpn")
    if n >= 5:
        trainable["backbone"] = bb
    elif n <= 0:
        frozen["backbone"] = bb
    else:   # layer{i} trains when i >= 5 - n
        t_bb = {k: v for k, v in bb.items()
                if k.startswith("layer") and int(k[len("layer"):]) >= 5 - n}
        trainable["backbone"] = t_bb
        frozen["backbone"] = {k: v for k, v in bb.items() if k not in t_bb}

    (frozen if freeze_fpn or n == 0 else trainable)["backbone_fpn"] = fpn
    (frozen if freeze_rpn else trainable)["rpn_head"] = params["rpn_head"]
    (frozen if freeze_detector else trainable)["box_head"] = params["box_head"]
    for tree, flag in ((trainable, True), (frozen, False)):
        for leaf in tree_leaves(tree):
            leaf.requires_grad_(flag)
    return trainable, frozen


def merge_params(trainable: Dict[str, Any], frozen: Dict[str, Any]) -> Dict[str, Any]:
    """The full parameter tree from a split."""
    parts = {**frozen, **trainable}
    backbone = {}
    for src in (frozen, trainable):   # the body may be split across both
        backbone.update(src.get("backbone", {}))
    backbone["fpn"] = parts["backbone_fpn"]
    return {"backbone": backbone, "rpn_head": parts["rpn_head"],
            "box_head": parts["box_head"]}
