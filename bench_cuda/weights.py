"""Seeded weights in the released checkpoints' layout.

:func:`make_state_dict` draws a torchvision 0.13 state dict for a
configuration file (``fasterrcnn_resnet50_fpn`` or
``fasterrcnn_mobilenet_v3_large_fpn`` with the reference's spiking heads:
``rpn.head.{shared_conv,conv_cls,conv_bbox}``,
``roi_heads.box_head_and_predictor.{fc6,fc7,cls_score,bbox_pred}``) on the
device, from ``seed``, in two draws (one normal, one uniform) that views
then scale. The program loads it as its users do
(``utils/checkpoint.convert_torch_state_dict``); the reference reads it as
it is. Distributions (the configuration's ``weights`` sets ``fpn_out_gain``):

  * backbone and FPN convs: He-normal, fan-out (torchvision's
    ``kaiming_normal_(mode="fan_out")``), times ``fpn_out_gain`` on the FPN's
    output convs; their biases zero;
  * frozen BatchNorm: weight 1, bias 0, running mean 0, running variance 1;
  * RPN head convs: normal, std ``RPN_STD`` (torchvision's ``RPNHead`` init);
  * box head linears: uniform in +-1/sqrt(fan-in), bias-free.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

RPN_STD = 0.01
RESNET_BLOCKS = (3, 4, 6, 3)
RESNET_WIDTHS = (256, 512, 1024, 2048)
# MobileNetV3-Large: (kernel, expanded, out, use_se); strides do not shape weights.
V3_LARGE = [
    (3, 16, 16, False), (3, 64, 24, False), (3, 72, 24, False), (5, 72, 40, True),
    (5, 120, 40, True), (5, 120, 40, True), (3, 240, 80, False), (3, 200, 80, False),
    (3, 184, 80, False), (3, 184, 80, False), (3, 480, 112, True), (3, 672, 112, True),
    (5, 672, 160, True), (5, 960, 160, True), (5, 960, 160, True),
]


def _divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def _bn(prefix: str, c: int, out: List):
    out += [(f"{prefix}.weight", (c,), "one"), (f"{prefix}.bias", (c,), "zero"),
            (f"{prefix}.running_mean", (c,), "zero"), (f"{prefix}.running_var", (c,), "one")]


def _conv(key: str, cout: int, cin: int, k: int, out: List, gain: float = 1.0):
    out.append((key, (cout, cin, k, k), ("he", gain)))


def resnet_layout() -> List[Tuple]:
    b = "backbone.body."
    out: List[Tuple] = []
    _conv(f"{b}conv1.weight", 64, 3, 7, out)
    _bn(f"{b}bn1", 64, out)
    cin = 64
    for stage, (n_blocks, cout) in enumerate(zip(RESNET_BLOCKS, RESNET_WIDTHS), start=1):
        width = cout // 4
        for blk in range(n_blocks):
            p = f"{b}layer{stage}.{blk}."
            bin_ = cin if blk == 0 else cout
            _conv(f"{p}conv1.weight", width, bin_, 1, out)
            _bn(f"{p}bn1", width, out)
            _conv(f"{p}conv2.weight", width, width, 3, out)
            _bn(f"{p}bn2", width, out)
            _conv(f"{p}conv3.weight", cout, width, 1, out)
            _bn(f"{p}bn3", cout, out)
            if blk == 0:
                _conv(f"{p}downsample.0.weight", cout, bin_, 1, out)
                _bn(f"{p}downsample.1", cout, out)
        cin = cout
    return out


def mobilenet_layout() -> List[Tuple]:
    b = "backbone.body."
    out: List[Tuple] = []
    _conv(f"{b}0.0.weight", 16, 3, 3, out)
    _bn(f"{b}0.1", 16, out)
    cin = 16
    for i, (k, exp, cout, se) in enumerate(V3_LARGE):
        p, j = f"{b}{i + 1}.block.", 0
        if exp != cin:
            _conv(f"{p}{j}.0.weight", exp, cin, 1, out)
            _bn(f"{p}{j}.1", exp, out)
            j += 1
        _conv(f"{p}{j}.0.weight", exp, 1, k, out)           # depthwise
        _bn(f"{p}{j}.1", exp, out)
        j += 1
        if se:
            sq = _divisible(exp // 4)
            _conv(f"{p}{j}.fc1.weight", sq, exp, 1, out)
            out.append((f"{p}{j}.fc1.bias", (sq,), "zero"))
            _conv(f"{p}{j}.fc2.weight", exp, sq, 1, out)
            out.append((f"{p}{j}.fc2.bias", (exp,), "zero"))
            j += 1
        _conv(f"{p}{j}.0.weight", cout, exp, 1, out)
        _bn(f"{p}{j}.1", cout, out)
        cin = cout
    _conv(f"{b}16.0.weight", 960, cin, 1, out)
    _bn(f"{b}16.1", 960, out)
    return out


def layout(cfg: Dict) -> List[Tuple]:
    """(key, shape, kind) of every leaf, in draw order. kind: "one", "zero",
    ("he", gain), ("normal", std) or ("uniform", bound)."""
    resnet = cfg["backbone"] == "resnet50_fpn"
    out = resnet_layout() if resnet else mobilenet_layout()
    c = cfg["fpn_channels"]
    gain = cfg["weights"]["fpn_out_gain"]
    for i, cin in enumerate(RESNET_WIDTHS if resnet else (160, 960)):
        _conv(f"backbone.fpn.inner_blocks.{i}.0.weight", c, cin, 1, out)
        out.append((f"backbone.fpn.inner_blocks.{i}.0.bias", (c,), "zero"))
        _conv(f"backbone.fpn.layer_blocks.{i}.0.weight", c, c, 3, out, gain)
        out.append((f"backbone.fpn.layer_blocks.{i}.0.bias", (c,), "zero"))
    a = len(cfg["anchor_sizes"][0]) * len(cfg["aspect_ratios"])
    out += [("rpn.head.shared_conv.weight", (c, c, 3, 3), ("normal", RPN_STD)),
            ("rpn.head.conv_cls.weight", (a, c, 1, 1), ("normal", RPN_STD)),
            ("rpn.head.conv_bbox.weight", (4 * a, c, 1, 1), ("normal", RPN_STD))]
    rep, n_cls, d_in = cfg["representation_size"], cfg["num_classes"], c * 7 * 7
    p = "roi_heads.box_head_and_predictor."
    for name, cout, cin in (("fc6", rep, d_in), ("fc7", rep, rep), ("cls_score", n_cls, rep),
                            ("bbox_pred", 4 * n_cls, rep)):
        out.append((f"{p}{name}.weight", (cout, cin), ("uniform", 1.0 / math.sqrt(cin))))
    return out


def _scale(shape, kind) -> float:
    if kind[0] == "he":
        cout, cin, kh, kw = shape
        fan_out = (1 if cin == 1 else cout) * kh * kw      # depthwise: k * k
        return kind[1] * math.sqrt(2.0 / fan_out)
    return kind[1]


def make_state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``cfg`` drawn from ``seed`` on ``device``, float32."""
    leaves = layout(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(math.prod(s) for _, s, k in leaves if k[0] in ("he", "normal"))
    n_uniform = sum(math.prod(s) for _, s, k in leaves if k[0] == "uniform")
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device).mul_(2.0).sub_(1.0)
    sd, off = {}, {"n": 0, "u": 0}
    for key, shape, kind in leaves:
        size = math.prod(shape)
        if kind in ("one", "zero"):
            sd[key] = (torch.ones if kind == "one" else torch.zeros)(shape, device=device)
            continue
        buf, slot = (uniform, "u") if kind[0] == "uniform" else (normal, "n")
        sd[key] = buf[off[slot]:off[slot] + size].view(shape).mul_(_scale(shape, kind))
        off[slot] += size
    return sd
