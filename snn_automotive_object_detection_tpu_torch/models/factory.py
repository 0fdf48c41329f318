"""Detector configuration and seeded parameter initialisation.

Port of ``snn_automotive_object_detection_tpu/models/factory.py`` for the
flagship model: ResNet-50-FPN with the spiking RPN and box heads. The TPU
kernel toggles are gone (the CUDA kernels always run on a CUDA device, and
their plain versions on the CPU); neuron states are always float32, with
matmul operands in ``compute_dtype``. Parameters form the same tree as the
JAX package's ``init_params`` (HWIO convs, [in, out] linears), so a JAX
tree converts with ``utils/weights.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from snn_automotive_object_detection_tpu_torch.models.resnet_fpn import (
    BLOCKS_PER_STAGE,
    STAGE_WIDTHS,
)
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.models.transform import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from snn_automotive_object_detection_tpu_torch.ops.anchors import AnchorSpec
from snn_automotive_object_detection_tpu_torch.ops.cuda_fpn import FPN_CHANNELS
from snn_automotive_object_detection_tpu_torch.utils.constants import resolve_device


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    num_classes: int = 9
    t_rpn: int = 12
    t_det: int = 16
    image_mean: Tuple[float, float, float] = IMAGENET_MEAN
    image_std: Tuple[float, float, float] = IMAGENET_STD
    min_size: int = 768
    max_size: int = 1536
    rpn: RPNConfig = RPNConfig()
    roi: RoIConfig = RoIConfig()
    compute_dtype: Any = torch.bfloat16
    fpn_channels: int = FPN_CHANNELS
    representation_size: int = 1024
    # Let gradients reach the backbone in training: all of it, or the top N
    # ResNet stages (1: layer4 ... 4: layer1, 5: the stem too). The default
    # keeps the backbone frozen, as the reference does.
    train_backbone: bool = False
    trainable_backbone_layers: int = 0

    @property
    def bucket(self) -> Tuple[int, int]:
        return (self.min_size, self.max_size)

    @property
    def backbone_trainable_stages(self) -> int:
        return 5 if self.train_backbone else self.trainable_backbone_layers

    @property
    def anchor_spec(self) -> AnchorSpec:
        return AnchorSpec()


def _draw_device(g: torch.Generator, device) -> torch.device:
    """The device the parameters are drawn on (None: the CUDA device). The
    generator must live there too: a draw with a generator of another
    device would have to happen elsewhere and be copied."""
    device = resolve_device(device, "init_params")
    if g.device != device:
        raise ValueError(
            f"init_params: the generator lives on {g.device} but the "
            f"parameters are drawn on {device}; make it with "
            f"torch.Generator(device={str(device)!r})")
    return device


def _normal(g, shape, std, device):
    return torch.randn(shape, generator=g, device=device) * std


def _uniform(g, shape, bound, device):
    return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * bound


def _conv_he(g, kh, kw, cin, cout, device):
    """He / fan-out normal (torchvision's kaiming_normal_, mode fan_out)."""
    return _normal(g, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cout)), device)


def _bn(cout, device):
    return {"scale": torch.ones(cout, device=device),
            "bias": torch.zeros(cout, device=device)}


def init_resnet50_fpn(g: torch.Generator, device=None) -> Dict[str, Any]:
    """Backbone parameters drawn from ``g`` on ``device`` (None: the CUDA
    device; raises where there is none)."""
    device = _draw_device(g, device)
    params: Dict[str, Any] = {"stem": {"w": _conv_he(g, 7, 7, 3, 64, device),
                                       "bn": _bn(64, device)}}
    cin = 64
    for stage, (n_blocks, cout) in enumerate(zip(BLOCKS_PER_STAGE, STAGE_WIDTHS)):
        width = cout // 4
        blocks = []
        for b in range(n_blocks):
            bin_ = cin if b == 0 else cout
            blk = {
                "conv1": {"w": _conv_he(g, 1, 1, bin_, width, device), "bn": _bn(width, device)},
                "conv2": {"w": _conv_he(g, 3, 3, width, width, device), "bn": _bn(width, device)},
                "conv3": {"w": _conv_he(g, 1, 1, width, cout, device), "bn": _bn(cout, device)},
            }
            if b == 0:  # stride 2 or a width change: projection shortcut
                blk["downsample"] = {"w": _conv_he(g, 1, 1, bin_, cout, device),
                                     "bn": _bn(cout, device)}
            blocks.append(blk)
        params[f"layer{stage + 1}"] = blocks
        cin = cout
    params["fpn"] = {
        "inner": [{"w": _conv_he(g, 1, 1, c, FPN_CHANNELS, device),
                   "b": torch.zeros(FPN_CHANNELS, device=device)} for c in STAGE_WIDTHS],
        "layer": [{"w": _conv_he(g, 3, 3, FPN_CHANNELS, FPN_CHANNELS, device),
                   "b": torch.zeros(FPN_CHANNELS, device=device)} for _ in STAGE_WIDTHS],
    }
    return params


def init_params(config: DetectorConfig, g: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters with the JAX init's distributions: He-normal
    backbone, normal(0.01) RPN head, torch.nn.Linear's uniform box head
    (bias-free), drawn from the seeded generator ``g`` on ``device``. With
    ``device=None`` that is the CUDA device, and the call raises where there
    is none; the generator must live on the same device."""
    device = _draw_device(g, device)
    c = config.fpn_channels
    a = config.anchor_spec.num_anchors_per_location[0]
    rep = config.representation_size
    d_in = c * 7 * 7
    params: Dict[str, Any] = {"backbone": init_resnet50_fpn(g, device)}
    params["rpn_head"] = {
        "shared_conv": {"w": _normal(g, (3, 3, c, c), 0.01, device)},
        "conv_cls": {"w": _normal(g, (1, 1, c, a), 0.01, device)},
        "conv_bbox": {"w": _normal(g, (1, 1, c, 4 * a), 0.01, device)},
    }
    params["box_head"] = {
        "fc6": {"w": _uniform(g, (d_in, rep), 1.0 / math.sqrt(d_in), device)},
        "fc7": {"w": _uniform(g, (rep, rep), 1.0 / math.sqrt(rep), device)},
        "cls_score": {"w": _uniform(g, (rep, config.num_classes),
                                    1.0 / math.sqrt(rep), device)},
        "bbox_pred": {"w": _uniform(g, (rep, 4 * config.num_classes),
                                    1.0 / math.sqrt(rep), device)},
    }
    return params
