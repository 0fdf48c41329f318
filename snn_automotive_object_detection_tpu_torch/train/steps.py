"""Train, validation-loss and eval steps.

Port of ``snn_automotive_object_detection_tpu/train/steps.py`` on one
device. PyTorch's optimizers hold their state and update the parameters in
place, so a step takes the two partitions and the batch and returns the
losses.
"""

from __future__ import annotations

import torch

from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
from snn_automotive_object_detection_tpu_torch.train.optim import merge_params


def make_train_step(config, optimizer: torch.optim.Optimizer, scheduler=None):
    """Returns step(trainable, frozen, batch, generator, draws=None) ->
    losses: one update of the leaves of ``trainable`` in place. The four
    losses and "loss_total" come back as tensors on the device (reading one
    waits for the step); the gradients stay in the leaves' ``.grad`` until
    the next step. ``optimizer`` and ``scheduler`` are
    ``optim.build_optimizer``'s over the same ``trainable``."""

    def step(trainable, frozen, batch, generator, draws=None):
        params = merge_params(trainable, frozen)
        optimizer.zero_grad(set_to_none=True)
        _, losses = detector_apply(params, batch, config, training=True,
                                   generator=generator, draws=draws)
        total = sum(losses.values())
        total.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss_total"] = total.detach()
        return losses

    return step


def make_eval_step(config, collect_rates: bool = False):
    """Returns step(params, batch) -> detections dict (fixed capacity)."""

    def step(params, batch):
        det, _ = detector_apply(params, batch, config, training=False,
                                collect_rates=collect_rates)
        return det

    return step


def make_val_loss_step(config):
    """Returns step(params, batch, generator, draws=None) -> losses: the
    training losses without an update (the reference's validate_one_epoch
    keeps the model in training mode under no_grad)."""

    def step(params, batch, generator, draws=None):
        with torch.no_grad():
            _, losses = detector_apply(params, batch, config, training=True,
                                       generator=generator, draws=draws)
        losses["loss_total"] = sum(losses.values())
        return losses

    return step
