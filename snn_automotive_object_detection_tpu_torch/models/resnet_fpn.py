"""ResNet-50 + FPN backbone, functional PyTorch, NHWC, frozen BatchNorm.

Port of ``snn_automotive_object_detection_tpu/models/resnet_fpn.py``.
Parameters keep the JAX layout: HWIO conv weights, BN as a per-channel
affine (scale, bias). Activations are NHWC in the compute dtype; every conv
rounds its output to that dtype, as the reference does.

The dtype picks the route, as in the reference (bf16 runs its fused
kernels, float32 keeps the unfused chain): a bf16 map takes the fused FPN
(``ops/cuda_fpn.py``: the K5 kernel on a CUDA device, its plain version on
the CPU), a float32 map the unfused FPN tail below. The fused stem
(``ops/cuda_stem.py``) replaces :func:`stem_apply_unfused` in front of
:func:`resnet50_fpn_apply_from_p1`; ``models/detector.py`` does that.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from snn_automotive_object_detection_tpu_torch.ops.cuda_fpn import fpn_apply

BLOCKS_PER_STAGE = (3, 4, 6, 3)
STAGE_WIDTHS = (256, 512, 1024, 2048)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding=None) -> torch.Tensor:
    """Conv of NHWC ``x`` with an HWIO weight, torch's symmetric padding
    (k // 2 by default); the weight is cast to x's dtype."""
    kh, kw = w.shape[0], w.shape[1]
    if padding is None:
        padding = (kh // 2, kw // 2)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _conv_bn(x, p, stride=1, relu=True):
    y = conv_nhwc(x, p["w"], stride)
    y = y * p["bn"]["scale"].to(y.dtype) + p["bn"]["bias"].to(y.dtype)
    return torch.relu(y) if relu else y


def _bottleneck(x, p, stride):
    out = _conv_bn(x, p["conv1"])
    out = _conv_bn(out, p["conv2"], stride=stride)
    out = _conv_bn(out, p["conv3"], relu=False)
    if "downsample" in p:
        x = _conv_bn(x, p["downsample"], stride=stride, relu=False)
    return torch.relu(out + x)


def _upsample_nearest_2x(x: torch.Tensor, target_hw) -> torch.Tensor:
    th, tw = target_hw
    y = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return y[:, :th, :tw, :]


def stem_apply_unfused(stem: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """7x7/2 conv (pad 3) + frozen BN + ReLU + 3x3/2 max-pool (pad 1) of the
    normalised image ``x`` [N, H, W, 3], op by op, in x's dtype."""
    y = conv_nhwc(x, stem["w"], stride=2, padding=(3, 3))
    y = y * stem["bn"]["scale"].to(y.dtype) + stem["bn"]["bias"].to(y.dtype)
    y = torch.relu(y)
    return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)


def fpn_unfused(fpn: Dict[str, Any], cs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The FPN tail op by op in the maps' dtype: lateral 1x1 convs, top-down
    nearest upsample and add, 3x3 output convs, and the pool level."""
    def inner(i, t):
        return conv_nhwc(t, fpn["inner"][i]["w"]) + fpn["inner"][i]["b"].to(t.dtype)

    def outer(i, t):
        return conv_nhwc(t, fpn["layer"][i]["w"]) + fpn["layer"][i]["b"].to(t.dtype)

    lat = [inner(i, c) for i, c in enumerate(cs)]
    p5 = lat[3]
    p4 = lat[2] + _upsample_nearest_2x(p5, lat[2].shape[1:3])
    p3 = lat[1] + _upsample_nearest_2x(p4, lat[1].shape[1:3])
    p2 = lat[0] + _upsample_nearest_2x(p3, lat[0].shape[1:3])
    outs = [outer(0, p2), outer(1, p3), outer(2, p4), outer(3, p5)]
    # LastLevelMaxPool: kernel 1, stride 2 (pure subsampling).
    outs.append(outs[3][:, ::2, ::2])
    return [o.contiguous() for o in outs]


def resnet50_fpn_apply_from_p1(params: Dict[str, Any], y: torch.Tensor,
                               trainable_layers: int = 0,
                               fused_fpn: bool = True) -> List[torch.Tensor]:
    """Layers 1-4 and the FPN from the stem's output ``y`` [N, H/4, W/4, 64].
    Returns the five NHWC levels [P2, P3, P4, P5, P6 (pool)], 256 channels,
    strides 4..64, in y's dtype. A bf16 ``y`` takes the fused FPN, which is
    for inference, unless ``fused_fpn`` is False.

    ``trainable_layers``: gradients reach the top N ResNet stages (1:
    layer4 ... 4: layer1, 5: the stem too). The map is detached where the
    first trainable stage begins, and so is each frozen stage's tap into
    the FPN, so the backward never walks a frozen stage. With 0 nothing is
    detached here: the caller detaches the levels. Frozen BatchNorm stays
    frozen either way."""
    if trainable_layers >= 5:
        first_trainable = 0
    elif trainable_layers <= 0:
        first_trainable = 4
    else:
        first_trainable = 4 - trainable_layers
    cs = []
    for stage in range(4):
        if 1 <= trainable_layers <= 4 and stage == first_trainable:
            y = y.detach()
        for b, bp in enumerate(params[f"layer{stage + 1}"]):
            y = _bottleneck(y, bp, 2 if (b == 0 and stage > 0) else 1)
        cs.append(y.detach() if stage < first_trainable else y)
    if fused_fpn and y.dtype == torch.bfloat16:
        return fpn_apply([c.contiguous() for c in cs], params["fpn"])
    return fpn_unfused(params["fpn"], cs)


def resnet50_fpn_apply(params: Dict[str, Any], x: torch.Tensor,
                       compute_dtype=torch.bfloat16, trainable_layers: int = 0,
                       fused_fpn: bool = True) -> List[torch.Tensor]:
    """x: [N, H, W, 3] normalised float. The unfused stem, then
    :func:`resnet50_fpn_apply_from_p1`."""
    return resnet50_fpn_apply_from_p1(
        params, stem_apply_unfused(params["stem"], x.to(compute_dtype)),
        trainable_layers, fused_fpn)
