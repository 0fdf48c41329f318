"""Detector configuration and seeded parameter initialisation.

Port of ``snn_automotive_object_detection_tpu/models/factory.py`` for the
spiking RPN and box heads on its three backbones: ResNet-50-FPN (the
flagship) and the two MobileNetV3-Large-FPN presets. The TPU
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

from snn_automotive_object_detection_tpu_torch.models.mobilenet_fpn import (
    init_mobilenet_v3_fpn,
)
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
from snn_automotive_object_detection_tpu_torch.utils.init import (
    bn_affine,
    conv_he,
    draw_device,
    normal,
    uniform,
)

BACKBONES = ("resnet50_fpn", "mobilenet_v3_large_fpn", "mobilenet_v3_large_320_fpn")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    num_classes: int = 9
    # One of BACKBONES: the flagship ResNet-50-FPN (5 levels), or the
    # reference's MobileNetV3-Large-FPN families (3 levels, 15 anchors per
    # location); see :func:`mobilenet_320_preset` for the 320 one's sizes.
    backbone: str = "resnet50_fpn"
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

    def __post_init__(self):
        if self.backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {self.backbone!r}; one of {BACKBONES}")

    @property
    def backbone_trainable_stages(self) -> int:
        """Trainable stages: ``train_backbone`` means all 5; a stage count is
        for ResNet only (the MobileNet families train whole or not at all)."""
        n = 5 if self.train_backbone else self.trainable_backbone_layers
        if n and self.backbone != "resnet50_fpn" and not self.train_backbone:
            raise ValueError(
                "trainable_backbone_layers counts ResNet stages; use "
                "train_backbone for the MobileNet families")
        return n

    @property
    def anchor_spec(self) -> AnchorSpec:
        if self.backbone == "resnet50_fpn":
            return AnchorSpec()  # 5 levels x 1 size x 3 ratios
        # MobileNet FPN: 3 levels x 5 sizes x 3 ratios.
        return AnchorSpec(sizes=((32.0, 64.0, 128.0, 256.0, 512.0),) * 3,
                          aspect_ratios=((0.5, 1.0, 2.0),) * 3)

    @property
    def fpn_strides(self) -> Tuple[int, ...]:
        """Feature strides of the backbone's FPN levels: P2..P6 for ResNet;
        two stride-32 maps and the pool level for MobileNet."""
        if self.backbone == "resnet50_fpn":
            return (4, 8, 16, 32, 64)
        return (32, 32, 64)


def mobilenet_320_preset() -> Dict[str, Any]:
    """The fields of the low-resolution MobileNet preset (reference
    faster_rcnn.py:748-768): 320/640 input and reduced RPN budgets. Use as
    ``DetectorConfig(**mobilenet_320_preset(), ...)``."""
    return {"backbone": "mobilenet_v3_large_320_fpn", "min_size": 320, "max_size": 640,
            "rpn": RPNConfig(pre_nms_top_n_test=150, post_nms_top_n_test=150,
                             score_thresh=0.05)}


def init_resnet50_fpn(g: torch.Generator, device=None) -> Dict[str, Any]:
    """Backbone parameters drawn from ``g`` on ``device`` (None: the CUDA
    device; raises where there is none)."""
    device = draw_device(g, device)
    params: Dict[str, Any] = {"stem": {"w": conv_he(g, 7, 7, 3, 64, device),
                                       "bn": bn_affine(64, device)}}
    cin = 64
    for stage, (n_blocks, cout) in enumerate(zip(BLOCKS_PER_STAGE, STAGE_WIDTHS)):
        width = cout // 4
        blocks = []
        for b in range(n_blocks):
            bin_ = cin if b == 0 else cout
            blk = {
                "conv1": {"w": conv_he(g, 1, 1, bin_, width, device), "bn": bn_affine(width, device)},
                "conv2": {"w": conv_he(g, 3, 3, width, width, device), "bn": bn_affine(width, device)},
                "conv3": {"w": conv_he(g, 1, 1, width, cout, device), "bn": bn_affine(cout, device)},
            }
            if b == 0:  # stride 2 or a width change: projection shortcut
                blk["downsample"] = {"w": conv_he(g, 1, 1, bin_, cout, device),
                                     "bn": bn_affine(cout, device)}
            blocks.append(blk)
        params[f"layer{stage + 1}"] = blocks
        cin = cout
    params["fpn"] = {
        "inner": [{"w": conv_he(g, 1, 1, c, FPN_CHANNELS, device),
                   "b": torch.zeros(FPN_CHANNELS, device=device)} for c in STAGE_WIDTHS],
        "layer": [{"w": conv_he(g, 3, 3, FPN_CHANNELS, FPN_CHANNELS, device),
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
    device = draw_device(g, device)
    c = config.fpn_channels
    a = config.anchor_spec.num_anchors_per_location[0]
    rep = config.representation_size
    d_in = c * 7 * 7
    if config.backbone == "resnet50_fpn":
        backbone = init_resnet50_fpn(g, device)
    else:
        backbone = init_mobilenet_v3_fpn(g, device)
    params: Dict[str, Any] = {"backbone": backbone}
    params["rpn_head"] = {
        "shared_conv": {"w": normal(g, (3, 3, c, c), 0.01, device)},
        "conv_cls": {"w": normal(g, (1, 1, c, a), 0.01, device)},
        "conv_bbox": {"w": normal(g, (1, 1, c, 4 * a), 0.01, device)},
    }
    params["box_head"] = {
        "fc6": {"w": uniform(g, (d_in, rep), 1.0 / math.sqrt(d_in), device)},
        "fc7": {"w": uniform(g, (rep, rep), 1.0 / math.sqrt(rep), device)},
        "cls_score": {"w": uniform(g, (rep, config.num_classes),
                                    1.0 / math.sqrt(rep), device)},
        "bbox_pred": {"w": uniform(g, (rep, 4 * config.num_classes),
                                    1.0 / math.sqrt(rep), device)},
    }
    return params
