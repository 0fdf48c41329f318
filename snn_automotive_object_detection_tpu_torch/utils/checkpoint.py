"""Checkpoints: save and resume with ``torch.save``, and conversion of the
reference's ``.pth`` files into the port's parameter tree.

Port of ``snn_automotive_object_detection_tpu/utils/checkpoint.py``. The
reference's checkpoint story (its train.py:650-675, 764-787, 923-949):

  * per-epoch checkpoints {params, optimizer, scheduler, epoch, args},
    written by rank 0 only; the training loop writes the rolling
    ``checkpoint`` alias beside them with a second call
  * resume: params, optimizer and scheduler state and the epoch
  * weights only, tolerant of missing or extra keys (strict=False), with
    the bbox_pred surgery for --only-one-bbox (train.py:669-675: pop a
    shape-mismatched bbox_pred so the fresh 4-output init survives the
    lenient load)
  * released torchvision-layout ``.pth`` checkpoints convert via
    ``convert_torch_state_dict``

Layout notes for the conversion (the port keeps the JAX package's
layouts): torch conv [O,I,H,W] -> HWIO; torch linear [out,in] -> [in,out];
fc6's flattened input is (C,7,7)-ordered in torch but (7,7,C)-ordered here
(NHWC RoIAlign), so its rows are permuted; FrozenBN folds to scale =
g/sqrt(var+eps), bias = b - mean*scale.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from snn_automotive_object_detection_tpu_torch.parallel.mesh import group_active, is_main_process
from snn_automotive_object_detection_tpu_torch.utils.weights import (
    flatten_tree,
    from_numpy_tree,
)

BN_EPS = 1e-5


# ----------------------------------------------------------- save / load


def _state_dict(obj):
    """An optimizer's or scheduler's ``state_dict()``; anything else as it is."""
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def _plain(args: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in args.items()
            if isinstance(v, (str, int, float, bool, list, tuple, type(None)))}


def save_checkpoint(path: str, state: Dict[str, Any],
                    args: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state`` = {"params": tree, "optimizer": optimizer or its
    state_dict, "scheduler": scheduler or its state_dict, "epoch": int}
    (any of them may be left out) and the run's flags ``args`` to ``path``
    with ``torch.save``. Rank 0 writes (the reference's save_on_master);
    with a process group every rank then waits at a barrier, so that no
    rank reads ``path`` before it is in place."""
    if is_main_process():
        _write(path, state, args)
    if group_active():
        torch.distributed.barrier()


def _write(path, state, args):
    payload = {k: _state_dict(v) for k, v in state.items()}
    if "params" in payload:
        payload["params"] = _detached(payload["params"])
    payload["args"] = None if args is None else _plain(args)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def load_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    """What :func:`save_checkpoint` wrote: {"params", "optimizer",
    "scheduler", "epoch", "args"} (those it was given), the tensors on
    ``map_location`` (``torch.load``'s: None keeps the devices they were
    saved from, except that with a process group up tensors saved on any
    card go to this rank's card). Restore an optimizer or scheduler with
    its ``load_state_dict``."""
    if map_location is None and group_active() and torch.cuda.is_available():
        card = f"cuda:{torch.cuda.current_device()}"
        map_location = {f"cuda:{i}": card for i in range(torch.cuda.device_count())}
    return torch.load(path, map_location=map_location, weights_only=True)


def load_checkpoint_args(path: str) -> Optional[Dict[str, Any]]:
    """The run's flags saved with a checkpoint, or None."""
    if not os.path.exists(path):
        return None
    return load_checkpoint(path, map_location="cpu").get("args")


def load_weights_lenient(params: Dict[str, Any], loaded: Dict[str, Any],
                         verbose: bool = True) -> Dict[str, Any]:
    """strict=False load: copy leaves present in both trees with matching
    shape, onto each current leaf's device and dtype (and its
    ``requires_grad``); keep current values elsewhere. Returns the merged
    tree."""
    flat_l = flatten_tree(loaded)
    missing, mismatched = [], []

    def merge(tree, key):
        if isinstance(tree, dict):
            return {k: merge(v, f"{key}/{k}" if key else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(merge(v, f"{key}/{i}" if key else str(i))
                              for i, v in enumerate(tree))
        got = flat_l.get(key)
        if got is None or tuple(np.shape(got)) != tuple(tree.shape):
            (missing if got is None else mismatched).append(key)
            return tree
        out = torch.as_tensor(got).to(device=tree.device, dtype=tree.dtype)
        return out.requires_grad_(tree.requires_grad)

    out = merge(params, "")
    if verbose and (missing or mismatched):
        print(f"[load_weights_lenient] kept {len(missing)} missing and "
              f"{len(mismatched)} shape-mismatched leaves at their current values")
    return out


# ----------------------------------------------------------- torch .pth


def _t2np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _conv_w(sd, key):
    return _t2np(sd[key]).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _bn(sd, prefix):
    g = _t2np(sd[f"{prefix}.weight"])
    b = _t2np(sd[f"{prefix}.bias"])
    mean = _t2np(sd[f"{prefix}.running_mean"])
    var = _t2np(sd[f"{prefix}.running_var"])
    scale = g / np.sqrt(var + BN_EPS)
    return {"scale": scale, "bias": b - mean * scale}


def _linear(sd, key_w, key_b=None):
    out = {"w": _t2np(sd[key_w]).T}
    if key_b and key_b in sd:
        out["b"] = _t2np(sd[key_b])
    return out


def _fc6_permuted(sd, key, channels=256, res=7):
    """fc6 weight rows reordered from (C, H, W) to (H, W, C) flattening."""
    w = _t2np(sd[key])  # [out, C*7*7] with (C, H, W) input order
    out_dim = w.shape[0]
    w = w.reshape(out_dim, channels, res, res).transpose(0, 2, 3, 1)
    return {"w": w.reshape(out_dim, -1).T}


def _convert_mobilenet_body(sd: Dict[str, Any]) -> Dict[str, Any]:
    """torchvision 0.13 mobilenet_v3_large features -> models/mobilenet_fpn
    param tree (reference builders faster_rcnn.py:703-831).

    Key layout: backbone.body.0.{0,1} stem conv+BN; backbone.body.{i}.block
    .{j} for features 1..15, each block a Sequential of ConvNormActivation
    ([expand,] dw, [SE,] project) with SE as fc1/fc2 1x1 convs;
    backbone.body.16.{0,1} the final 1x1 conv."""
    from snn_automotive_object_detection_tpu_torch.models.mobilenet_fpn import V3_LARGE

    def pfx(k):
        for p in ("backbone.body.", "body.", "features.", ""):
            if f"{p}{k}" in sd or f"{p}{k}.weight" in sd:
                return f"{p}{k}"
        raise KeyError(k)

    body: Dict[str, Any] = {
        "stem": {"w": _conv_w(sd, pfx("0.0.weight")), "bn": _bn(sd, pfx("0.1"))}
    }
    cin = 16
    blocks = []
    for i, (k, exp, out, se, hs, stride) in enumerate(V3_LARGE):
        base = pfx(f"{i + 1}.block.0.0.weight")[: -len("0.0.weight")]
        j = 0
        p: Dict[str, Any] = {}
        if exp != cin:
            p["expand"] = {"w": _conv_w(sd, f"{base}{j}.0.weight"),
                           "bn": _bn(sd, f"{base}{j}.1")}
            j += 1
        p["dw"] = {"w": _conv_w(sd, f"{base}{j}.0.weight"),
                   "bn": _bn(sd, f"{base}{j}.1")}
        j += 1
        if se:
            p["se"] = {
                "fc1": {"w": _conv_w(sd, f"{base}{j}.fc1.weight"),
                        "b": _t2np(sd[f"{base}{j}.fc1.bias"])},
                "fc2": {"w": _conv_w(sd, f"{base}{j}.fc2.weight"),
                        "b": _t2np(sd[f"{base}{j}.fc2.bias"])},
            }
            j += 1
        p["project"] = {"w": _conv_w(sd, f"{base}{j}.0.weight"),
                        "bn": _bn(sd, f"{base}{j}.1")}
        blocks.append(p)
        cin = out
    body["blocks"] = blocks
    body["last"] = {"w": _conv_w(sd, pfx("16.0.weight")),
                    "bn": _bn(sd, pfx("16.1"))}
    return body


def _convert_resnet_body(sd: Dict[str, Any], bkey) -> Dict[str, Any]:
    """ResNet-50 trunk (stem + layer1-4) from torchvision keys; ``bkey``
    resolves prefix variants (bare classification keys vs the detector's
    backbone.body. prefix)."""
    backbone = {
        "stem": {"w": _conv_w(sd, bkey("conv1.weight")),
                 "bn": _bn(sd, bkey("bn1"))}
    }
    blocks_per_stage = (3, 4, 6, 3)
    for stage, n_blocks in enumerate(blocks_per_stage, start=1):
        blocks = []
        for b in range(n_blocks):
            pre = bkey(f"layer{stage}.{b}.conv1.weight")[: -len("conv1.weight")]
            blk = {
                "conv1": {"w": _conv_w(sd, f"{pre}conv1.weight"),
                          "bn": _bn(sd, f"{pre}bn1")},
                "conv2": {"w": _conv_w(sd, f"{pre}conv2.weight"),
                          "bn": _bn(sd, f"{pre}bn2")},
                "conv3": {"w": _conv_w(sd, f"{pre}conv3.weight"),
                          "bn": _bn(sd, f"{pre}bn3")},
            }
            if f"{pre}downsample.0.weight" in sd:
                blk["downsample"] = {
                    "w": _conv_w(sd, f"{pre}downsample.0.weight"),
                    "bn": _bn(sd, f"{pre}downsample.1"),
                }
            blocks.append(blk)
        backbone[f"layer{stage}"] = blocks
    return backbone


def convert_torch_backbone_state_dict(sd: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Convert a BARE torchvision CLASSIFICATION state_dict (resnet50 /
    mobilenet_v3_large ImageNet weights — trunk keys only, no FPN, no
    detection heads) into a partial parameter pytree ``{"backbone": body}``.

    This is the local-file analog of the reference's ``--pretrained`` /
    ``pretrained_backbone=True`` path (train.py:73-76, model.py:28-31,
    faster_rcnn.py:693-699): the trunk is seeded from ImageNet weights
    while FPN and heads keep their fresh initialization — merge the result
    onto an init tree with ``load_weights_lenient``. Classification-only
    keys (``fc.weight``, ``classifier.*``) are ignored. The leaves are
    float32 tensors on ``device`` (None: the CUDA device).
    """
    sd = {k: v for k, v in sd.items()}
    is_mobilenet = any(".block.0.0.weight" in k for k in sd)
    if is_mobilenet:
        return from_numpy_tree({"backbone": _convert_mobilenet_body(sd)}, device)

    def bkey(k):
        for p in ("backbone.body.", "body.", ""):
            if f"{p}{k}" in sd or f"{p}{k}.weight" in sd:
                return f"{p}{k}"
        raise KeyError(k)

    return from_numpy_tree({"backbone": _convert_resnet_body(sd, bkey)}, device)


def load_torch_backbone(path: str, device=None) -> Dict[str, Any]:
    """Load a local torchvision ImageNet classification ``.pth`` and return
    the partial ``{"backbone": ...}`` tree (see
    ``convert_torch_backbone_state_dict``)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj.get("state_dict", obj)) \
        if isinstance(obj, dict) else obj
    return convert_torch_backbone_state_dict(sd, device)


def convert_torch_state_dict(
    sd: Dict[str, Any],
    rpn_snn: bool = True,
    detector_snn: bool = True,
    device=None,
) -> Dict[str, Any]:
    """Convert a reference checkpoint state_dict into this framework's
    parameter pytree. Key layout follows torchvision 0.13's
    fasterrcnn_resnet50_fpn / fasterrcnn_mobilenet_v3_large_fpn (detected
    from the keys) with the reference's SNN replacements (backbone.body.*,
    backbone.fpn.*, rpn.head.*, roi_heads.box_head_and_predictor.* /
    box_head+box_predictor). The leaves are float32 tensors on ``device``
    (None: the CUDA device)."""
    return from_numpy_tree(_convert_numpy(sd, rpn_snn, detector_snn), device)


def _convert_numpy(sd, rpn_snn, detector_snn) -> Dict[str, Any]:
    """:func:`convert_torch_state_dict`'s tree with numpy leaves."""
    sd = {k: v for k, v in sd.items()}
    is_mobilenet = any(".block.0.0.weight" in k for k in sd)

    def bkey(k):
        # accept both bare resnet keys and the detector's backbone.body. prefix
        for p in ("backbone.body.", "body.", ""):
            if f"{p}{k}" in sd or f"{p}{k}.weight" in sd:
                return f"{p}{k}"
        raise KeyError(k)

    if is_mobilenet:
        backbone = _convert_mobilenet_body(sd)
    else:
        backbone = _convert_resnet_body(sd, bkey)

    # FPN: tv<=0.12 keys inner_blocks.<i>.weight, tv 0.13 Conv2dNormActivation
    # keys inner_blocks.<i>.0.weight — accept both. ResNet has 4 lateral
    # pairs, mobilenet 2 (C4/C5 of _mobilenet_extractor).
    def fpn_conv(group, i):
        for pat in (f"backbone.fpn.{group}.{i}.weight",
                    f"backbone.fpn.{group}.{i}.0.weight",
                    f"fpn.{group}.{i}.weight", f"fpn.{group}.{i}.0.weight"):
            if pat in sd:
                return {"w": _conv_w(sd, pat),
                        "b": _t2np(sd[pat.replace("weight", "bias")])}
        raise KeyError(f"fpn {group} {i}")

    n_fpn = 2 if is_mobilenet else 4
    backbone["fpn"] = {
        "inner": [fpn_conv("inner_blocks", i) for i in range(n_fpn)],
        "layer": [fpn_conv("layer_blocks", i) for i in range(n_fpn)],
    }

    params: Dict[str, Any] = {"backbone": backbone}

    if rpn_snn:
        params["rpn_head"] = {
            "shared_conv": {"w": _conv_w(sd, "rpn.head.shared_conv.weight")},
            "conv_cls": {"w": _conv_w(sd, "rpn.head.conv_cls.weight")},
            "conv_bbox": {"w": _conv_w(sd, "rpn.head.conv_bbox.weight")},
        }
    else:
        def rpn_conv(name):
            for pat in (f"rpn.head.{name}.weight", f"rpn.head.{name}.0.weight",
                        f"rpn.head.{name}.0.0.weight"):
                if pat in sd:
                    return {"w": _conv_w(sd, pat),
                            "b": _t2np(sd[pat.replace("weight", "bias")])}
            raise KeyError(name)
        params["rpn_head"] = {
            "conv": rpn_conv("conv"),
            "cls_logits": rpn_conv("cls_logits"),
            "bbox_pred": rpn_conv("bbox_pred"),
        }

    if detector_snn:
        pre = "roi_heads.box_head_and_predictor"
        params["box_head"] = {
            "fc6": _fc6_permuted(sd, f"{pre}.fc6.weight"),
            "fc7": _linear(sd, f"{pre}.fc7.weight"),
            "cls_score": _linear(sd, f"{pre}.cls_score.weight"),
            "bbox_pred": _linear(sd, f"{pre}.bbox_pred.weight"),
        }
    else:
        params["box_head"] = {
            "fc6": _fc6_permuted(sd, "roi_heads.box_head.fc6.weight"),
            "fc7": _linear(sd, "roi_heads.box_head.fc7.weight",
                           "roi_heads.box_head.fc7.bias"),
        }
        params["box_head"]["fc6"]["b"] = _t2np(sd["roi_heads.box_head.fc6.bias"])
        params["box_predictor"] = {
            "cls_score": _linear(sd, "roi_heads.box_predictor.cls_score.weight",
                                 "roi_heads.box_predictor.cls_score.bias"),
            "bbox_pred": _linear(sd, "roi_heads.box_predictor.bbox_pred.weight",
                                 "roi_heads.box_predictor.bbox_pred.bias"),
        }
    return params


def load_torch_checkpoint(path: str, rpn_snn: bool = True,
                          detector_snn: bool = True,
                          only_one_bbox: bool = False, device=None) -> Dict[str, Any]:
    """Load a reference .pth (full checkpoint dict or bare state_dict)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    params = convert_torch_state_dict(sd, rpn_snn, detector_snn, device)
    if only_one_bbox and detector_snn:
        # --only-one-bbox surgery (train.py:669-675): the reference POPS the
        # per-class bbox_pred weight from the checkpoint and relies on
        # strict=False, so the model keeps its fresh 4-output init. Dropping
        # the leaf here makes load_weights_lenient do the same.
        w = params["box_head"]["bbox_pred"]["w"]
        if w.shape[1] != 4:
            del params["box_head"]["bbox_pred"]
    return params
