"""Train, validation-loss and eval steps.

Port of ``snn_automotive_object_detection_tpu/train/steps.py``. PyTorch's
optimizers hold their state and update the parameters in place, so a step
takes the two partitions and the batch and returns the losses.

Data parallelism: with a process group up, each rank runs its own rows of
the global batch, each loss is already the rank's share of the global
batch's loss (its sums over counts summed over the ranks,
``models/rpn.py``, ``models/roi_heads.py``), and the step sums the
gradients over the ranks before the update: the gradient of the global
loss, as the JAX package's SPMD step computes it. The losses it returns are
summed over the ranks too: the global losses on every rank (the
reference's ``reduce_dict``). A group of one rank runs the same
collectives; without a group there are none.
"""

from __future__ import annotations

import torch

from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
from snn_automotive_object_detection_tpu_torch.parallel.collectives import (
    sum_grads_over_ranks,
    sum_losses_over_ranks,
)
from snn_automotive_object_detection_tpu_torch.parallel.mesh import group_active
from snn_automotive_object_detection_tpu_torch.train.optim import merge_params
from snn_automotive_object_detection_tpu_torch.utils.spans import span
from snn_automotive_object_detection_tpu_torch.utils.weights import tree_leaves


def _global_losses(losses, total):
    """The four losses and "loss_total", detached, over the global batch."""
    losses = {k: v.detach() for k, v in losses.items()}
    if not group_active():
        losses["loss_total"] = total.detach()
        return losses
    losses = sum_losses_over_ranks(losses)
    losses["loss_total"] = sum(losses.values())
    return losses


def make_train_step(config, optimizer: torch.optim.Optimizer, scheduler=None):
    """Returns step(trainable, frozen, batch, generator, draws=None) ->
    losses: one update of the leaves of ``trainable`` in place. The four
    losses and "loss_total" come back as tensors on the device (reading one
    waits for the step); the gradients stay in the leaves' ``.grad`` until
    the next step. ``optimizer`` and ``scheduler`` are
    ``optim.build_optimizer``'s over the same ``trainable``. With a process
    group, ``batch`` is this rank's rows and ``generator`` (or ``draws``)
    the global batch's (``parallel/collectives.py``)."""

    def step(trainable, frozen, batch, generator, draws=None):
        with span("train.step"):
            params = merge_params(trainable, frozen)
            optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                _, losses = detector_apply(params, batch, config, training=True,
                                           generator=generator, draws=draws)
                total = sum(losses.values())
            with span("train.backward"):
                total.backward()
            with span("train.grad_allreduce"):
                sum_grads_over_ranks(tree_leaves(trainable))
            with span("train.optimizer"):
                optimizer.step()
                if scheduler is not None:
                    scheduler.step()
            with span("train.losses"):
                return _global_losses(losses, total)

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
    keeps the model in training mode under no_grad), over the global batch
    as :func:`make_train_step` gives them."""

    def step(params, batch, generator, draws=None):
        with torch.no_grad():
            _, losses = detector_apply(params, batch, config, training=True,
                                       generator=generator, draws=draws)
            return _global_losses(losses, sum(losses.values()))

    return step
