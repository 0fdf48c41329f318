"""RPN and box heads: the spiking ones on the CUDA kernels and as
differentiable step-by-step scans, and the ANN ones.

Port of the SNN heads of ``snn_automotive_object_detection_tpu/models/
heads.py``. At inference, as the reference runs them with its kernels on:

  * RPN head (reference rpn.py:33-121): per FPN level, T_rpn steps of
    encoder -> 3x3 conv -> LIF -> fused 1x1 cls+bbox readout -> LI; the
    final LI membranes are the logits. Runs as kernel K1, or pair by pair
    as kernel K8 (``snn/cuda_rpn.py``).
  * Box head (reference faster_rcnn.py:414-516): flattened 7x7x256 RoI
    features, T_det steps of encoder -> fc6 -> LIF -> fc7 -> LIF -> cls and
    bbox LI readouts. Runs as kernels K3 (encoder+fc6, ``snn/cuda_fc6.py``)
    and K4 (tail, ``snn/cuda_tail.py``), with the fc6 currents rounded to
    the compute dtype in between.

For training:

  * :func:`rpn_head_snn_train_apply` is the kernel-backed RPN head made
    differentiable for its weights: K1's training instance, which saves
    the per-step currents, and K7 backward on them
    (``snn/cuda_rpn.RpnLevelTrain``), for bf16 with a frozen backbone, with
    f32 or (their bf16-state instances) bf16 neuron states.
  * :func:`rpn_head_snn_scan_apply` and :func:`fastrcnn_snn_scan_apply` are
    the reference's scans written as Python loops of PyTorch ops under
    autograd, with the SuperSpike surrogate in every spike. Training uses
    them for the box head, for float32, for trainable backbone stages and
    for rate collection, and evaluation for float32, on either device;
    they are no kernel's plain version.

The ANN heads (reference rpn.py:203-245, faster_rcnn.py:320-411: a 3x3
conv with ReLU and two 1x1 convs; TwoMLPHead and FastRCNNPredictor) are
plain convolutions and linears with biases, as the JAX package leaves them
to XLA; no kernel.

Neuron states are float32 by default; with bf16 states (the reference's
--no-amp) the RPN head is K1's (or K8's) instance for bf16 states at
inference and K1's and K7's bf16-state instances in training, and the box
head at inference K3 followed by the tail as a scan with bf16 states
(:func:`box_tail_scan`), as the reference runs its tail with bf16 states.
Matmul operands are in the compute dtype. Rates follow the reference
convention: mean spikes per neuron per step, one value per image and level
(RPN) or per RoI (box head).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from snn_automotive_object_detection_tpu_torch.models.resnet_fpn import conv_nhwc
from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.snn.cuda_fc6 import encoder_fc6
from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
from snn_automotive_object_detection_tpu_torch.snn.cuda_rpn import RpnLevelTrain
from snn_automotive_object_detection_tpu_torch.snn.cuda_tail import box_tail


def _fused_readout(params: Dict):
    """(w_out [C, 5A], A): the cls and bbox 1x1 convs side by side."""
    w_cls = params["conv_cls"]["w"]
    c = params["shared_conv"]["w"].shape[2]
    a = w_cls.shape[-1]
    return torch.cat([w_cls, params["conv_bbox"]["w"]], dim=-1).reshape(c, 5 * a), a


def rpn_head_snn_apply(params: Dict, features: List[torch.Tensor],
                       num_steps: int, collect_rates: bool = False,
                       compute_dtype=torch.bfloat16, bf16_states: bool = False):
    """features: list of [N, H_l, W_l, C]. Returns (objectness list
    [N, H_l, W_l, A] f32, bbox list [N, H_l, W_l, 4A] f32, rates): rates is
    None or {"encoder", "shared"}: [L, N].

    A level takes the paired kernel (K8), which keeps no spike counts, when
    ``cuda_rpn.PAIR_IMAGES`` is on, no rates are collected and the level can
    pair (an even batch); else the per-image kernel (K1). Per image the two
    give the same bits. ``bf16_states`` takes K1's and K8's instances for
    bf16 neuron states, which give the same bits per image too."""
    w_out, a = _fused_readout(params)
    w_shared = params["shared_conv"]["w"]
    logits, bbox_reg, enc_rates, shared_rates = [], [], [], []
    for feat in features:
        x = feat.to(compute_dtype).contiguous()
        _, h, w, c = x.shape
        if pairs([x], collect_rates):
            out = cuda_rpn.rpn_level_x2(x, w_shared, w_out, num_steps,
                                        bf16_states=bf16_states)
        else:
            out, enc, lif = cuda_rpn.rpn_level(x, w_shared, w_out, num_steps,
                                               bf16_states=bf16_states)
            denom = float(num_steps * h * w * c)
            enc_rates.append(enc.double() / denom)
            shared_rates.append(lif.double() / denom)
        logits.append(out[..., :a])
        bbox_reg.append(out[..., a:])
    rates = None
    if collect_rates:
        rates = {"encoder": torch.stack(enc_rates).float(),
                 "shared": torch.stack(shared_rates).float()}
    return logits, bbox_reg, rates


def pairs(features: List[torch.Tensor], collect_rates: bool) -> bool:
    """Whether :func:`rpn_head_snn_apply` would take the paired kernel (K8)
    for any of these levels."""
    return (cuda_rpn.PAIR_IMAGES and not collect_rates
            and any(cuda_rpn.x2_feasible(f.shape) for f in features))


def rpn_head_snn_train_apply(params: Dict, features: List[torch.Tensor],
                             num_steps: int, compute_dtype=torch.bfloat16,
                             bf16_states: bool = False):
    """:func:`rpn_head_snn_apply` made differentiable for the three weights:
    per level K1's training instance forward and K7 backward on what it
    saved (on the CPU, their plain versions), with ``bf16_states`` their
    instances for bf16 neuron states. The features get no gradient; rates
    are not collected. Returns (objectness list, bbox list, None)."""
    w_out, a = _fused_readout(params)
    logits, bbox_reg = [], []
    for feat in features:
        x = feat.detach().to(compute_dtype).contiguous()
        out, _, _ = RpnLevelTrain.apply(x, params["shared_conv"]["w"], w_out,
                                        num_steps, bf16_states)
        logits.append(out[..., :a])
        bbox_reg.append(out[..., a:])
    return logits, bbox_reg, None


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def rpn_head_snn_scan_apply(params: Dict, features: List[torch.Tensor],
                            num_steps: int, collect_rates: bool = False,
                            compute_dtype=torch.bfloat16,
                            fast_encoder: bool = False,
                            state_dtype=torch.float32):
    """The spiking RPN head step by step under autograd: encoder -> 3x3
    conv -> LIF -> fused 1x1 readout -> LI; the last LI membranes are the
    logits. Conv operands are in ``compute_dtype``, neuron states in
    ``state_dtype``; ``fast_encoder`` takes the closed-form encoder periods
    in place of the carried membrane. Same returns as
    :func:`rpn_head_snn_apply`."""
    w_shared = params["shared_conv"]["w"]
    w_out, a = _fused_readout(params)
    w_out = w_out.reshape(1, 1, *w_out.shape)
    cd, sd = compute_dtype, state_dtype
    logits, bbox_reg, enc_rates, shared_rates = [], [], [], []
    for feat in features:
        x = feat.to(cd)
        n, h, w, c = x.shape
        periods = snnf.encoder_periods(x) if fast_encoder else None
        v_enc = torch.zeros(x.shape, dtype=sd, device=x.device)
        lif = snnf.zeros_lif_state(x.shape, sd, x.device)
        li_out = snnf.zeros_li_state((n, h, w, 5 * a), sd, x.device)
        cnt_enc = torch.zeros(n, device=x.device)
        cnt_shared = torch.zeros(n, device=x.device)
        for t in range(num_steps):
            if fast_encoder:
                z = snnf.encoder_spikes_at(periods, t, cd)
            else:
                z, v_enc = snnf.lif_current_encoder(x.to(sd), v_enc)
            s, lif = snnf.lif_feed_forward_step(
                conv_nhwc(z.to(cd), w_shared).to(sd), lif)
            _, li_out = snnf.li_feed_forward_step(
                conv_nhwc(s.to(cd), w_out).to(sd), li_out)
            if collect_rates:
                cnt_enc = cnt_enc + z.detach().float().sum(dim=(1, 2, 3))
                cnt_shared = cnt_shared + s.detach().float().sum(dim=(1, 2, 3))
        mem = li_out.v.float()
        logits.append(mem[..., :a])
        bbox_reg.append(mem[..., a:])
        enc_rates.append(cnt_enc / (num_steps * h * w * c))
        shared_rates.append(cnt_shared / (num_steps * h * w * c))
    rates = None
    if collect_rates:
        rates = {"encoder": torch.stack(enc_rates), "shared": torch.stack(shared_rates)}
    return logits, bbox_reg, rates


def fastrcnn_snn_scan_apply(params: Dict, x: torch.Tensor, num_steps: int,
                            collect_rates: bool = False,
                            compute_dtype=torch.bfloat16,
                            fast_encoder: bool = False,
                            state_dtype=torch.float32):
    """The spiking box head step by step under autograd: encoder -> fc6 ->
    LIF -> fc7 -> LIF -> cls and bbox LI readouts; the last LI membranes are
    the logits and deltas. Same dtypes and returns as
    :func:`rpn_head_snn_scan_apply` and :func:`fastrcnn_snn_apply`."""
    cd, sd = compute_dtype, state_dtype
    x = x.to(cd)
    r, d_in = x.shape
    w6, w7 = params["fc6"]["w"], params["fc7"]["w"]
    wc, wb = params["cls_score"]["w"], params["bbox_pred"]["w"]
    rep = w6.shape[1]
    dev = x.device
    periods = snnf.encoder_periods(x) if fast_encoder else None
    v_enc = torch.zeros(x.shape, dtype=sd, device=dev)
    l6 = snnf.zeros_lif_state((r, rep), sd, dev)
    l7 = snnf.zeros_lif_state((r, rep), sd, dev)
    li_c = snnf.zeros_li_state((r, wc.shape[1]), sd, dev)
    li_b = snnf.zeros_li_state((r, wb.shape[1]), sd, dev)
    c_enc = torch.zeros(r, device=dev)
    c6 = torch.zeros(r, device=dev)
    c7 = torch.zeros(r, device=dev)
    for t in range(num_steps):
        if fast_encoder:
            z = snnf.encoder_spikes_at(periods, t, cd)
        else:
            z, v_enc = snnf.lif_current_encoder(x.to(sd), v_enc)
        s6, l6 = snnf.lif_feed_forward_step(_linear(z.to(cd), w6).to(sd), l6)
        s7, l7 = snnf.lif_feed_forward_step(_linear(s6.to(cd), w7).to(sd), l7)
        _, li_c = snnf.li_feed_forward_step(_linear(s7.to(cd), wc).to(sd), li_c)
        _, li_b = snnf.li_feed_forward_step(_linear(s7.to(cd), wb).to(sd), li_b)
        if collect_rates:
            c_enc = c_enc + z.detach().float().sum(dim=1)
            c6 = c6 + s6.detach().float().sum(dim=1)
            c7 = c7 + s7.detach().float().sum(dim=1)
    rates = None
    if collect_rates:
        rates = {"encoder": c_enc / (num_steps * d_in),
                 "fc6": c6 / (num_steps * rep), "fc7": c7 / (num_steps * rep)}
    return li_c.v.float(), li_b.v.float(), rates


def box_tail_scan(cur6: torch.Tensor, w7: torch.Tensor, wc: torch.Tensor, wb: torch.Tensor,
                  compute_dtype=torch.bfloat16, state_dtype=torch.bfloat16):
    """The box head's LIF6, fc7, LIF7 and LI readouts step by step over the
    fc6 currents cur6 [T, R, rep] (in the compute dtype), neuron states in
    ``state_dtype``: the JAX package's ``_fastrcnn_snn_from_cur6``, which
    the reference's kernel route runs after its fc6 kernel where the states
    are bf16. Returns (class logits [R, C] f32, box deltas [R, B] f32, fc6
    and fc7 spike counts [R] f32)."""
    cd, sd = compute_dtype, state_dtype
    _, r, rep = cur6.shape
    dev = cur6.device
    l6 = snnf.zeros_lif_state((r, rep), sd, dev)
    l7 = snnf.zeros_lif_state((r, rep), sd, dev)
    li_c = snnf.zeros_li_state((r, wc.shape[1]), sd, dev)
    li_b = snnf.zeros_li_state((r, wb.shape[1]), sd, dev)
    c6 = torch.zeros(r, device=dev)
    c7 = torch.zeros(r, device=dev)
    for cur in cur6:
        s6, l6 = snnf.lif_feed_forward_step(cur.to(sd), l6)
        s7, l7 = snnf.lif_feed_forward_step(_linear(s6.to(cd), w7).to(sd), l7)
        _, li_c = snnf.li_feed_forward_step(_linear(s7.to(cd), wc).to(sd), li_c)
        _, li_b = snnf.li_feed_forward_step(_linear(s7.to(cd), wb).to(sd), li_b)
        c6 = c6 + s6.float().sum(dim=1)
        c7 = c7 + s7.float().sum(dim=1)
    return li_c.v.float(), li_b.v.float(), c6, c7


def fastrcnn_snn_apply(params: Dict, x: torch.Tensor, num_steps: int,
                       collect_rates: bool = False,
                       compute_dtype=torch.bfloat16, state_dtype=torch.float32):
    """x: [R, 7*7*C] flattened RoI features. Returns (class logits
    [R, n_cls] f32, box deltas [R, n_reg] f32, rates): rates is None or
    {"encoder", "fc6", "fc7"}: [R]. Encoder and fc6 run as K3; the tail as
    K4 with float32 states, else as :func:`box_tail_scan` in
    ``state_dtype``."""
    x = x.to(compute_dtype).contiguous()
    d_in = x.shape[1]
    rep = params["fc6"]["w"].shape[1]
    cur6, enc = encoder_fc6(x, params["fc6"]["w"], num_steps)
    tail_w = (params["fc7"]["w"], params["cls_score"]["w"], params["bbox_pred"]["w"])
    if state_dtype == torch.float32:
        cls, box, c6, c7 = box_tail(cur6.to(compute_dtype).contiguous(), *tail_w)
    else:
        cls, box, c6, c7 = box_tail_scan(cur6.to(compute_dtype), *tail_w, compute_dtype,
                                         state_dtype)
    rates = None
    if collect_rates:
        rates = {"encoder": (enc.double() / (num_steps * d_in)).float(),
                 "fc6": (c6.double() / (num_steps * rep)).float(),
                 "fc7": (c7.double() / (num_steps * rep)).float()}
    return cls, box, rates


def _linear_b(x: torch.Tensor, leaf: Dict) -> torch.Tensor:
    """x @ w (in x's dtype) + b: a bf16 product plus the f32 bias is f32, as
    in the JAX package."""
    return _linear(x, leaf["w"]) + leaf["b"]


def _conv_b(x: torch.Tensor, leaf: Dict) -> torch.Tensor:
    return conv_nhwc(x, leaf["w"]) + leaf["b"]


def rpn_head_ann_apply(params: Dict, features: List[torch.Tensor],
                       compute_dtype=torch.bfloat16):
    """The ANN RPN head (reference rpn.py:203-245): per level a 3x3 conv
    with bias and ReLU, then the 1x1 cls and bbox convs with biases.
    Returns (objectness list [N, H_l, W_l, A] f32, bbox list
    [N, H_l, W_l, 4A] f32, None)."""
    logits, bbox_reg = [], []
    for feat in features:
        t = torch.relu(_conv_b(feat.to(compute_dtype), params["conv"])).to(compute_dtype)
        logits.append(_conv_b(t, params["cls_logits"]).float())
        bbox_reg.append(_conv_b(t, params["bbox_pred"]).float())
    return logits, bbox_reg, None


def two_mlp_head_apply(params: Dict, x: torch.Tensor,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """TwoMLPHead (reference faster_rcnn.py:320-345): fc6 and fc7 with
    biases and ReLU; x [R, 7*7*C]. Returns [R, rep] f32."""
    x = torch.relu(_linear_b(x.to(compute_dtype), params["fc6"]))
    return torch.relu(_linear_b(x.to(compute_dtype), params["fc7"])).float()


def fastrcnn_predictor_apply(params: Dict, x: torch.Tensor):
    """FastRCNNPredictor (reference faster_rcnn.py:348-411): the cls and
    bbox linears with biases on the f32 representation. Returns (class
    logits [R, C], box deltas [R, 4C])."""
    return _linear_b(x, params["cls_score"]), _linear_b(x, params["bbox_pred"])
