"""Named spans at the port's layer boundaries, for ``torch.profiler``.

``with span(name):`` is ``torch.profiler.record_function(name)`` while a
profiler is running and does nothing otherwise: no dispatcher call, no
allocation, one read of ``torch.autograd.profiler._is_profiler_enabled``.
There is no flag of its own; the profiler being on is the switch (the
benchmark's ``--trace 1``, ``cli/train.py --profile``). Kineto records a
span on the clock of CUPTI's device activities, so a trace books device
time and device idle to the span the host was in.

Each span wraps a call site in its caller, never code inside a
``utils/graphs.graphed`` function. The spans of one call nest under its
root span (``detector`` or ``train.step``), which identifies the call in a
trace. The names (``NAMES``):

  * ``detector``: one ``models/detector.detector_apply`` call, evaluation
    or training; the anchors and the heads' routes are its own work.
  * ``detector.backbone``: ``backbone_features`` (stem, body, FPN).
  * ``detector.rpn_head``: the RPN head's apply in ``rpn.rpn_forward``.
  * ``detector.rpn_select``: ``rpn_forward`` from ``flatten_head_outputs``
    through ``filter_proposals`` (top-k, decode, per-level NMS, top-n).
  * ``detector.roi_align``: RoIAlign of the proposals or the sampled RoIs.
  * ``detector.box_head``: the box head's apply.
  * ``detector.postprocess`` (evaluation): ``_postproc_groups``,
    ``_batched_group_nms`` and ``_postproc_outputs``, or
    ``postprocess_detections_ann`` for an ANN box head.
  * ``detector.outputs`` (evaluation): the rescaled boxes and the output
    dict.
  * ``detector.rpn_loss`` (training): ``assign_targets_to_anchors`` and
    ``rpn_loss``.
  * ``detector.roi_sample`` (training): ``select_training_samples``.
  * ``detector.roi_loss`` (training): ``fastrcnn_loss``.
  * ``train.step``: one step of ``train/steps.make_train_step``.
  * ``train.forward``: ``detector_apply`` and the sum of the losses.
  * ``train.backward``: ``total.backward()``; autograd's device thread
    launches the backward's kernels while the caller waits in it.
  * ``train.grad_allreduce``: ``sum_grads_over_ranks``.
  * ``train.optimizer``: ``optimizer.step()`` and the scheduler's step.
  * ``train.losses``: ``_global_losses``, the losses' all-reduce included.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

NAMES = (
    "detector", "detector.backbone", "detector.rpn_head", "detector.rpn_select",
    "detector.roi_align", "detector.box_head", "detector.postprocess", "detector.outputs",
    "detector.rpn_loss", "detector.roi_sample", "detector.roi_loss",
    "train.step", "train.forward", "train.backward", "train.grad_allreduce",
    "train.optimizer", "train.losses",
)

# Shared by every span taken with no profiler running: entering and leaving
# it does nothing, so one instance serves nested and concurrent spans.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a ``record_function``
    range while a profiler runs, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
