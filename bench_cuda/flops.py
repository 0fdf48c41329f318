"""Dense FLOPs of one evaluation batch or training step, from the
configuration's sizes alone: the numerator of ``mfu``. A multiply-add is
two operations. The count is the dense model's and does not depend on
spikes or on what implements a layer:

  * the backbone's and the FPN's convolutions (BatchNorm affines,
    activations, pooling and the top-down adds are left out);
  * the RPN head's 3x3 conv and its 1x1 readouts on every FPN level, once
    per step (x ``t_rpn``);
  * the box head's fc6, fc7 and readouts on ``post_nms_top_n_test`` RoIs
    per image, once per step (x ``t_det``).

Encoders, LIF and LI updates, NMS and RoIAlign are not products.
"""

from __future__ import annotations

from typing import Dict

from bench_cuda.weights import RESNET_BLOCKS, RESNET_WIDTHS, V3_LARGE, _divisible

# MobileNetV3-Large strides, block by block.
V3_STRIDES = (1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1)
V3_C4, V3_LAST, V3_C4_CHANNELS = 12, 960, 160


def _down(n: int, s: int) -> int:
    return -(-n // s)


def conv(h: int, w: int, k: int, cin: int, cout: int, groups: int = 1) -> int:
    """FLOPs of one image's k x k convolution whose output is h x w."""
    return 2 * h * w * k * k * (cin // groups) * cout


def resnet50_fpn(h: int, w: int, c: int) -> int:
    f = conv(_down(h, 2), _down(w, 2), 7, 3, 64)
    hh, ww, cin, sizes = _down(h, 4), _down(w, 4), 64, []
    for stage, (n_blocks, cout) in enumerate(zip(RESNET_BLOCKS, RESNET_WIDTHS)):
        width = cout // 4
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ho, wo = _down(hh, s), _down(ww, s)
            bin_ = cin if b == 0 else cout
            f += conv(hh, ww, 1, bin_, width) + conv(ho, wo, 3, width, width)
            f += conv(ho, wo, 1, width, cout) + (conv(ho, wo, 1, bin_, cout) if b == 0 else 0)
            hh, ww = ho, wo
        sizes.append((hh, ww, cout))
        cin = cout
    return f + sum(conv(a, b, 1, ci, c) + conv(a, b, 3, c, c) for a, b, ci in sizes)


def mobilenet_v3_large_fpn(h: int, w: int, c: int) -> int:
    hh, ww = _down(h, 2), _down(w, 2)
    f = conv(hh, ww, 3, 3, 16)
    cin, c4_hw = 16, None
    for i, ((k, exp, out, se), stride) in enumerate(zip(V3_LARGE, V3_STRIDES)):
        if exp != cin:
            f += conv(hh, ww, 1, cin, exp)
        hh, ww = _down(hh, stride), _down(ww, stride)
        f += conv(hh, ww, k, exp, exp, groups=exp)
        if se:
            sq = _divisible(exp // 4)
            f += conv(1, 1, 1, exp, sq) + conv(1, 1, 1, sq, exp)
        f += conv(hh, ww, 1, exp, out)
        cin = out
        if i == V3_C4:
            c4_hw = (hh, ww)
    f += conv(hh, ww, 1, cin, V3_LAST)
    return f + (conv(*c4_hw, 1, V3_C4_CHANNELS, c) + conv(hh, ww, 1, V3_LAST, c)
                + conv(*c4_hw, 3, c, c) + conv(hh, ww, 3, c, c))


def level_shapes(cfg) -> list:
    h, w = cfg["min_size"], cfg["max_size"]
    strides = (4, 8, 16, 32, 64) if cfg["backbone"] == "resnet50_fpn" else (32, 32, 64)
    return [(_down(h, s), _down(w, s)) for s in strides]


def eval_batch(cfg, batch: int) -> Dict[str, int]:
    """Dense FLOPs of one evaluation batch of ``batch`` images, by part."""
    h, w, c = cfg["min_size"], cfg["max_size"], cfg["fpn_channels"]
    a = len(cfg["anchor_sizes"][0]) * len(cfg["aspect_ratios"])
    body = (resnet50_fpn if cfg["backbone"] == "resnet50_fpn" else mobilenet_v3_large_fpn)(h, w, c)
    rpn = sum(conv(lh, lw, 3, c, c) + conv(lh, lw, 1, c, 5 * a)
              for lh, lw in level_shapes(cfg)) * cfg["t_rpn"]
    rep, n_cls = cfg["representation_size"], cfg["num_classes"]
    rois = cfg["rpn"]["post_nms_top_n_test"]
    box = 2 * rois * (c * 49 * rep + rep * rep + rep * 5 * n_cls) * cfg["t_det"]
    parts = {"backbone_fpn": body * batch, "rpn_head": rpn * batch, "box_head": box * batch}
    parts["total"] = sum(parts.values())
    return parts


def train_step(cfg, batch: int) -> Dict[str, int]:
    """Dense FLOPs of one frozen-backbone training step of ``batch`` images:
    the backbone and FPN forward once; in the heads (the box head on
    ``batch_size_per_image`` sampled RoIs an image), a layer whose input is
    frozen (the RPN head's 3x3 conv on the FPN levels' spikes, fc6 on the
    RoI features) 2x its forward (the forward and the gradient into its
    weights), every other layer (the RPN readouts, fc7, the box readouts)
    3x (the gradient into its input too)."""
    ev = eval_batch(cfg, batch)
    rep, n_cls, c = cfg["representation_size"], cfg["num_classes"], cfg["fpn_channels"]
    a = len(cfg["anchor_sizes"][0]) * len(cfg["aspect_ratios"])
    steps = cfg["t_rpn"] * batch
    conv3 = sum(conv(lh, lw, 3, c, c) for lh, lw in level_shapes(cfg)) * steps
    readout = sum(conv(lh, lw, 1, c, 5 * a) for lh, lw in level_shapes(cfg)) * steps
    rois = cfg["roi"]["batch_size_per_image"] * batch * cfg["t_det"]
    fc6, rest = 2 * rois * c * 49 * rep, 2 * rois * (rep * rep + rep * 5 * n_cls)
    parts = {"backbone_fpn": ev["backbone_fpn"], "rpn_head": 2 * conv3 + 3 * readout,
             "box_head": 2 * fc6 + 3 * rest}
    parts["total"] = sum(parts.values())
    return parts
