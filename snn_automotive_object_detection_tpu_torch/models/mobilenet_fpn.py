"""MobileNetV3-Large + FPN backbone, functional PyTorch, NHWC, frozen
BatchNorm.

Port of ``snn_automotive_object_detection_tpu/models/mobilenet_fpn.py``
(the reference's ``fasterrcnn_mobilenet_v3_large_fpn`` and ``..._320_fpn``
builders): MobileNetV3-Large, an FPN over the last two returned maps and a
LastLevelMaxPool level: 3 output levels with 256 channels. Both FPN inputs
are at stride 32 (see :data:`C4_IDX`), so the top-down step is an add of
equal shapes. Parameters keep the JAX layout: HWIO conv weights, depthwise
weights as [k, k, 1, C], BN as a per-channel affine. Every conv rounds its
output to the compute dtype, and the squeeze-excitation gates add their
float32 biases before they round, as the reference does.

Every op here is a PyTorch call (cuDNN convs, elementwise): the reference
runs this backbone without a kernel of its own too.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from snn_automotive_object_detection_tpu_torch.models.resnet_fpn import (
    _upsample_nearest_2x,
    conv_nhwc,
)
from snn_automotive_object_detection_tpu_torch.ops.cuda_fpn import FPN_CHANNELS
from snn_automotive_object_detection_tpu_torch.utils import init

# (kernel, expanded, out, use_se, use_hs, stride): MobileNetV3-Large.
V3_LARGE = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]
LAST_CONV = 960
# torchvision 0.13 returns the stages [0, 2, 4, 7, 13, 16] of the feature
# list and the FPN takes the last two: features[13], the stride-2 block with
# 160 channels (cumulative stride 32), and the final 1x1 conv (960 channels,
# stride 32). features[13] is blocks[C4_IDX] (features index = block + 1).
C4_IDX = 12
C4_CHANNELS = 160


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def init_mobilenet_v3_fpn(g: torch.Generator, device=None) -> Dict[str, Any]:
    """Backbone parameters drawn from ``g`` on ``device`` (None: the CUDA
    device; raises where there is none): He-normal convs (fan-out), unit
    frozen BN, zero biases. The tree is the JAX ``init_mobilenet_v3_fpn``'s."""
    device = init.draw_device(g, device)

    def conv(kh, kw, cin, cout):
        return init.conv_he(g, kh, kw, cin, cout, device)

    def zeros(c):
        return torch.zeros(c, device=device)

    params: Dict[str, Any] = {"stem": {"w": conv(3, 3, 3, 16),
                                       "bn": init.bn_affine(16, device)}}
    cin = 16
    blocks = []
    for k, exp, out, se, _, _ in V3_LARGE:
        p: Dict[str, Any] = {}
        if exp != cin:
            p["expand"] = {"w": conv(1, 1, cin, exp), "bn": init.bn_affine(exp, device)}
        # depthwise: HWIO with one input channel per group, fan-out k * k
        p["dw"] = {"w": init.normal(g, (k, k, 1, exp), math.sqrt(2.0 / (k * k)), device),
                   "bn": init.bn_affine(exp, device)}
        if se:
            sq = _make_divisible(exp // 4)
            p["se"] = {"fc1": {"w": conv(1, 1, exp, sq), "b": zeros(sq)},
                       "fc2": {"w": conv(1, 1, sq, exp), "b": zeros(exp)}}
        p["project"] = {"w": conv(1, 1, exp, out), "bn": init.bn_affine(out, device)}
        blocks.append(p)
        cin = out
    params["blocks"] = blocks
    params["last"] = {"w": conv(1, 1, cin, LAST_CONV),
                      "bn": init.bn_affine(LAST_CONV, device)}
    params["fpn"] = {
        "inner": [{"w": conv(1, 1, c, FPN_CHANNELS), "b": zeros(FPN_CHANNELS)}
                  for c in (C4_CHANNELS, LAST_CONV)],
        "layer": [{"w": conv(3, 3, FPN_CHANNELS, FPN_CHANNELS), "b": zeros(FPN_CHANNELS)}
                  for _ in range(2)],
    }
    return params


def _bn(x, p):
    return x * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def _dw_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise conv of NHWC ``x`` with a [k, k, 1, C] weight, padding
    k // 2."""
    k, c = w.shape[0], x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=k // 2, groups=c)
    return y.permute(0, 2, 3, 1)


def _block(x, p, spec):
    _, _, out, se, hs, stride = spec
    act = hardswish if hs else torch.relu
    y = x
    if "expand" in p:
        y = act(_bn(conv_nhwc(y, p["expand"]["w"]), p["expand"]["bn"]))
    y = act(_bn(_dw_conv(y, p["dw"]["w"], stride), p["dw"]["bn"]))
    if se:
        s = y.mean(dim=(1, 2), keepdim=True)
        # The float32 biases promote the sums before they round to y's dtype.
        s = torch.relu(conv_nhwc(s, p["se"]["fc1"]["w"]) + p["se"]["fc1"]["b"]).to(y.dtype)
        s = hardsigmoid(conv_nhwc(s, p["se"]["fc2"]["w"]) + p["se"]["fc2"]["b"]).to(y.dtype)
        y = y * s
    y = _bn(conv_nhwc(y, p["project"]["w"]), p["project"]["bn"])
    if stride == 1 and x.shape[-1] == out:
        y = y + x
    return y


def mobilenet_v3_fpn_apply(params: Dict[str, Any], x: torch.Tensor,
                           compute_dtype=torch.bfloat16) -> List[torch.Tensor]:
    """x: [N, H, W, 3] normalised float. Returns the 3 NHWC levels [P4
    (stride 32), P5 (stride 32), pool (stride 64)], 256 channels, in the
    compute dtype."""
    x = x.to(compute_dtype)
    y = hardswish(_bn(conv_nhwc(x, params["stem"]["w"], stride=2), params["stem"]["bn"]))
    c4 = None
    for i, (p, spec) in enumerate(zip(params["blocks"], V3_LARGE)):
        y = _block(y, p, spec)
        if i == C4_IDX:
            c4 = y
    c5 = hardswish(_bn(conv_nhwc(y, params["last"]["w"]), params["last"]["bn"]))

    fpn = params["fpn"]
    lat4 = conv_nhwc(c4, fpn["inner"][0]["w"]) + fpn["inner"][0]["b"].to(c4.dtype)
    lat5 = conv_nhwc(c5, fpn["inner"][1]["w"]) + fpn["inner"][1]["b"].to(c5.dtype)
    # Both levels are at stride 32: torchvision's interpolate-to-size is the
    # identity here, so the maps add as they are.
    p4 = (lat4 + lat5 if lat4.shape == lat5.shape
          else lat4 + _upsample_nearest_2x(lat5, lat4.shape[1:3]))
    outs = [conv_nhwc(p4, fpn["layer"][0]["w"]) + fpn["layer"][0]["b"].to(p4.dtype),
            conv_nhwc(lat5, fpn["layer"][1]["w"]) + fpn["layer"][1]["b"].to(lat5.dtype)]
    # LastLevelMaxPool: kernel 1, stride 2 (pure subsampling).
    outs.append(outs[-1][:, ::2, ::2])
    return [o.contiguous() for o in outs]
