"""Spiking RPN head and spiking box head, on the CUDA kernels.

Port of the SNN heads of ``snn_automotive_object_detection_tpu/models/
heads.py`` as the reference runs them at inference with its kernels on:

  * RPN head (reference rpn.py:33-121): per FPN level, T_rpn steps of
    encoder -> 3x3 conv -> LIF -> fused 1x1 cls+bbox readout -> LI; the
    final LI membranes are the logits. Runs as kernel K1
    (``snn/cuda_rpn.py``).
  * Box head (reference faster_rcnn.py:414-516): flattened 7x7x256 RoI
    features, T_det steps of encoder -> fc6 -> LIF -> fc7 -> LIF -> cls and
    bbox LI readouts. Runs as kernels K3 (encoder+fc6, ``snn/cuda_fc6.py``)
    and K4 (tail, ``snn/cuda_tail.py``), with the fc6 currents rounded to
    the compute dtype in between.

Neuron states are float32; matmul operands are in the compute dtype.
Rates follow the reference convention: mean spikes per neuron per step,
one value per image and level (RPN) or per RoI (box head).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from snn_automotive_object_detection_tpu_torch.snn.cuda_fc6 import encoder_fc6
from snn_automotive_object_detection_tpu_torch.snn.cuda_rpn import rpn_level
from snn_automotive_object_detection_tpu_torch.snn.cuda_tail import box_tail


def rpn_head_snn_apply(params: Dict, features: List[torch.Tensor],
                       num_steps: int, collect_rates: bool = False,
                       compute_dtype=torch.bfloat16):
    """features: list of [N, H_l, W_l, C]. Returns (objectness list
    [N, H_l, W_l, A] f32, bbox list [N, H_l, W_l, 4A] f32, rates): rates is
    None or {"encoder", "shared"}: [L, N]."""
    w_cls = params["conv_cls"]["w"]
    w_bbox = params["conv_bbox"]["w"]
    a = w_cls.shape[-1]
    c = params["shared_conv"]["w"].shape[2]
    w_out = torch.cat([w_cls, w_bbox], dim=-1).reshape(c, 5 * a)
    logits, bbox_reg, enc_rates, shared_rates = [], [], [], []
    for feat in features:
        x = feat.to(compute_dtype).contiguous()
        _, h, w, _ = x.shape
        out, enc, lif = rpn_level(x, params["shared_conv"]["w"], w_out,
                                  num_steps)
        logits.append(out[..., :a])
        bbox_reg.append(out[..., a:])
        denom = float(num_steps * h * w * c)
        enc_rates.append(enc.double() / denom)
        shared_rates.append(lif.double() / denom)
    rates = None
    if collect_rates:
        rates = {"encoder": torch.stack(enc_rates).float(),
                 "shared": torch.stack(shared_rates).float()}
    return logits, bbox_reg, rates


def fastrcnn_snn_apply(params: Dict, x: torch.Tensor, num_steps: int,
                       collect_rates: bool = False,
                       compute_dtype=torch.bfloat16):
    """x: [R, 7*7*C] flattened RoI features. Returns (class logits
    [R, n_cls] f32, box deltas [R, n_reg] f32, rates): rates is None or
    {"encoder", "fc6", "fc7"}: [R]."""
    x = x.to(compute_dtype).contiguous()
    d_in = x.shape[1]
    rep = params["fc6"]["w"].shape[1]
    cur6, enc = encoder_fc6(x, params["fc6"]["w"], num_steps)
    cls, box, c6, c7 = box_tail(
        cur6.to(compute_dtype).contiguous(), params["fc7"]["w"],
        params["cls_score"]["w"], params["bbox_pred"]["w"])
    rates = None
    if collect_rates:
        rates = {"encoder": (enc.double() / (num_steps * d_in)).float(),
                 "fc6": (c6.double() / (num_steps * rep)).float(),
                 "fc7": (c7.double() / (num_steps * rep)).float()}
    return cls, box, rates
