"""Detector configuration, seeded parameter initialisation and
``create_model``.

Port of ``snn_automotive_object_detection_tpu/models/factory.py`` (the
reference's model.py:7-189): the spiking or ANN RPN and box heads on its
three backbones, ResNet-50-FPN (the flagship) and the two
MobileNetV3-Large-FPN presets; per-dataset image statistics, the SNN and
ANN RoI operating points and the ``model.yaml`` key maps. The TPU kernel
toggles are gone (the CUDA kernels always run on a CUDA device, and their
plain versions on the CPU). Neuron states are in ``snn_state_dtype``
(float32 by default, the reference's AMP numerics; None: the compute
dtype), matmul operands in ``compute_dtype``. Parameters form the same tree
as the JAX package's ``init_params`` (HWIO convs, [in, out] linears), so a
JAX tree converts with ``utils/weights.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

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
    CITYSCAPES_MEAN,
    CITYSCAPES_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from snn_automotive_object_detection_tpu_torch.ops.anchors import AnchorSpec
from snn_automotive_object_detection_tpu_torch.ops.cuda_fpn import FPN_CHANNELS
from snn_automotive_object_detection_tpu_torch.utils.constants import resolve_device
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
    # Spiking (True) or ANN heads, each on its own; a box head of only one
    # class-agnostic box regresses 4 deltas per RoI.
    rpn_snn: bool = True
    detector_snn: bool = True
    t_rpn: int = 12
    t_det: int = 16
    only_one_bbox: bool = False
    image_mean: Tuple[float, float, float] = IMAGENET_MEAN
    image_std: Tuple[float, float, float] = IMAGENET_STD
    min_size: int = 768
    max_size: int = 1536
    rpn: RPNConfig = RPNConfig()
    roi: RoIConfig = RoIConfig()
    compute_dtype: Any = torch.bfloat16
    # The dtype of the neuron states (membranes, currents, LI readouts):
    # float32 with bf16 compute is the reference's AMP numerics (its
    # default); None means the compute dtype (its --no-amp).
    snn_state_dtype: Any = torch.float32
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
    def state_dtype(self):
        """The neuron states' dtype: ``snn_state_dtype``, or the compute
        dtype where that is None."""
        return self.snn_state_dtype or self.compute_dtype

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
    backbone; a normal(0.01) RPN head (the ANN one with zero biases);
    torch.nn.Linear's uniform box head, bias-free when spiking, and for the
    ANN box head its predictor (``box_predictor``, per-class boxes), drawn
    from the seeded generator ``g`` on ``device``. With ``device=None`` that
    is the CUDA device, and the call raises where there is none; the
    generator must live on the same device."""
    device = draw_device(g, device)
    c = config.fpn_channels
    a = config.anchor_spec.num_anchors_per_location[0]
    rep = config.representation_size
    n_cls = config.num_classes
    d_in = c * 7 * 7
    if config.backbone == "resnet50_fpn":
        backbone = init_resnet50_fpn(g, device)
    else:
        backbone = init_mobilenet_v3_fpn(g, device)
    params: Dict[str, Any] = {"backbone": backbone}
    if config.rpn_snn:
        params["rpn_head"] = {
            "shared_conv": {"w": normal(g, (3, 3, c, c), 0.01, device)},
            "conv_cls": {"w": normal(g, (1, 1, c, a), 0.01, device)},
            "conv_bbox": {"w": normal(g, (1, 1, c, 4 * a), 0.01, device)},
        }
    else:
        params["rpn_head"] = {
            "conv": {"w": normal(g, (3, 3, c, c), 0.01, device),
                     "b": torch.zeros(c, device=device)},
            "cls_logits": {"w": normal(g, (1, 1, c, a), 0.01, device),
                           "b": torch.zeros(a, device=device)},
            "bbox_pred": {"w": normal(g, (1, 1, c, 4 * a), 0.01, device),
                          "b": torch.zeros(4 * a, device=device)},
        }

    def linear(cin, cout, bias):
        leaf = {"w": uniform(g, (cin, cout), 1.0 / math.sqrt(cin), device)}
        if bias:
            leaf["b"] = uniform(g, (cout,), 1.0 / math.sqrt(cin), device)
        return leaf

    if config.detector_snn:
        n_reg = 4 if config.only_one_bbox else 4 * n_cls
        params["box_head"] = {"fc6": linear(d_in, rep, False), "fc7": linear(rep, rep, False),
                              "cls_score": linear(rep, n_cls, False),
                              "bbox_pred": linear(rep, n_reg, False)}
    else:
        params["box_head"] = {"fc6": linear(d_in, rep, True), "fc7": linear(rep, rep, True)}
        params["box_predictor"] = {"cls_score": linear(rep, n_cls, True),
                                   "bbox_pred": linear(rep, 4 * n_cls, True)}
    return params


# create_model's state dtype when the caller names none: the config's
# default (float32 states), where None would mean "the compute dtype".
_STATE_DTYPE_UNSET = object()

# model.yaml keys (its RPN and ROIHeads sections) -> RPNConfig / RoIConfig.
RPN_YAML_KEYS = {
    "rpn_pre_nms_top_n_train": "pre_nms_top_n_train",
    "rpn_pre_nms_top_n_test": "pre_nms_top_n_test",
    "rpn_post_nms_top_n_train": "post_nms_top_n_train",
    "rpn_post_nms_top_n_test": "post_nms_top_n_test",
    "rpn_nms_thresh": "nms_thresh",
    "rpn_fg_iou_thresh": "fg_iou_thresh",
    "rpn_bg_iou_thresh": "bg_iou_thresh",
    "rpn_batch_size_per_image": "batch_size_per_image",
    "rpn_positive_fraction": "positive_fraction",
    "rpn_score_thresh": "score_thresh",
}
ROI_YAML_KEYS = {
    "box_score_thresh": "score_thresh",
    "box_nms_thresh": "nms_thresh",
    "box_detections_per_img": "detections_per_img",
    "box_fg_iou_thresh": "fg_iou_thresh",
    "box_bg_iou_thresh": "bg_iou_thresh",
    "box_batch_size_per_image": "batch_size_per_image",
    "box_positive_fraction": "positive_fraction",
}


def create_model(dataset_name: str, num_classes: int, rpn_snn: bool, detector_snn: bool,
                 num_steps_rpn: int = 12, num_steps_detector: int = 16,
                 only_one_bbox: bool = False, seed: int = 0,
                 compute_dtype=torch.bfloat16, model_yaml: Optional[Dict[str, Any]] = None,
                 backbone: str = "resnet50_fpn", snn_state_dtype=_STATE_DTYPE_UNSET,
                 device=None) -> Tuple[DetectorConfig, Dict[str, Any]]:
    """(config, params) for a dataset, as the reference's model.py:7-189
    builds them: Cityscapes' image statistics for "cityscapes", ImageNet's
    otherwise; the RoI operating point of the spiking box head (score 0.4,
    NMS 0.5) or of the ANN one (0.10, 0.45); the 320 MobileNet preset's
    sizes and RPN budgets; then ``model_yaml`` (configs/model.yaml's RPN,
    ROIHeads and transform sections) over all of these. The parameters are
    drawn on ``device`` (None: the CUDA device) from a generator there
    seeded with ``seed``."""
    mean, std = ((CITYSCAPES_MEAN, CITYSCAPES_STD) if dataset_name == "cityscapes"
                 else (IMAGENET_MEAN, IMAGENET_STD))
    roi_kw: Dict[str, Any] = ({"score_thresh": 0.4, "nms_thresh": 0.5} if detector_snn
                              else {"score_thresh": 0.10, "nms_thresh": 0.45})
    rpn_kw: Dict[str, Any] = {}
    tr_kw: Dict[str, Any] = {}
    if backbone == "mobilenet_v3_large_320_fpn":
        preset = mobilenet_320_preset()
        rpn_kw = dataclasses.asdict(preset.pop("rpn"))
        tr_kw = {k: v for k, v in preset.items() if k != "backbone"}
    if model_yaml:
        for k, v in (model_yaml.get("RPN") or {}).items():
            if k in RPN_YAML_KEYS:
                rpn_kw[RPN_YAML_KEYS[k]] = v
        for k, v in (model_yaml.get("ROIHeads") or {}).items():
            if k in ROI_YAML_KEYS:
                roi_kw[ROI_YAML_KEYS[k]] = v
        for k in ("min_size", "max_size"):
            if k in (model_yaml.get("transform") or {}):
                tr_kw[k] = model_yaml["transform"][k]
    states = {} if snn_state_dtype is _STATE_DTYPE_UNSET else {"snn_state_dtype": snn_state_dtype}
    config = DetectorConfig(
        num_classes=num_classes, backbone=backbone, rpn_snn=rpn_snn,
        detector_snn=detector_snn, t_rpn=num_steps_rpn, t_det=num_steps_detector,
        only_one_bbox=only_one_bbox, image_mean=mean, image_std=std,
        rpn=RPNConfig(**rpn_kw), roi=RoIConfig(**roi_kw), compute_dtype=compute_dtype,
        **states, **tr_kw)
    device = resolve_device(device, "create_model")
    params = init_params(config, torch.Generator(device=device).manual_seed(seed), device)
    return config, params
