"""Port vs JAX: checkpoints (``utils/checkpoint.py``).

The ``.pth`` converters run on synthetic torchvision-layout state dicts
(the reference's SNN detector as ``tools/torch_mirror.py`` builds it, on a
ResNet-50 and on a MobileNetV3-Large body, frozen-BN statistics drawn so
the folding matters; the ANN heads' keys of tests/test_checkpoint.py; a
bare classification trunk) and must return ``from_numpy_tree`` of the JAX
converters' trees leaf for leaf, bit for bit, including the
``only_one_bbox`` surgery. Then the port's own save and load: the round
trip of params, AdamW state, scheduler, epoch and flags, the rolling alias,
``map_location``, and ``load_weights_lenient`` against the JAX one.
"""

import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.utils import checkpoint as jckpt
from snn_automotive_object_detection_tpu_torch.models.factory import (
    DetectorConfig,
    init_params,
)
from snn_automotive_object_detection_tpu_torch.train.optim import (
    build_optimizer,
    build_schedule,
)
from snn_automotive_object_detection_tpu_torch.utils import checkpoint as ckpt
from snn_automotive_object_detection_tpu_torch.utils.weights import (
    flatten_tree,
    from_numpy_tree,
    tree_leaves,
)
from tests.test_checkpoint import _ann_head_state_dict


def _mirror_sd(backbone, num_classes=5, only_one_bbox=False, seed=0):
    from tools import torch_mirror as tm

    torch.manual_seed(seed)
    m = tm.MirrorDetector(num_classes=num_classes, t_rpn=2, t_det=2, backbone=backbone,
                          only_one_bbox=only_one_bbox)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, tm.FrozenBN):
                mod.running_mean.normal_(0, 0.05)
                mod.running_var.uniform_(0.7, 1.3)
    return dict(m.state_dict())


@pytest.fixture(scope="module")
def sds():
    return {"resnet50": _mirror_sd("resnet50"), "mobilenet": _mirror_sd("mobilenet")}


def _assert_same_tree(got, want_numpy):
    """``got`` (the port's tree) equals ``from_numpy_tree`` of the JAX tree
    leaf for leaf: the same keys, shapes and float32 bits."""
    want = flatten_tree(from_numpy_tree(want_numpy, device="cpu"))
    got = flatten_tree(got)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu", k
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("backbone", ["resnet50", "mobilenet"])
def test_convert_state_dict_equals_jax(sds, backbone):
    sd = sds[backbone]
    got = ckpt.convert_torch_state_dict(sd, device="cpu")
    _assert_same_tree(got, jckpt.convert_torch_state_dict(sd))
    assert got["box_head"]["fc6"]["w"].shape == (12544, 1024)


def test_convert_ann_heads_equals_jax(sds):
    sd = {k: v for k, v in sds["resnet50"].items()
          if not k.startswith(("rpn.head", "roi_heads"))}
    sd.update(_ann_head_state_dict())
    got = ckpt.convert_torch_state_dict(sd, rpn_snn=False, detector_snn=False, device="cpu")
    _assert_same_tree(got, jckpt.convert_torch_state_dict(sd, rpn_snn=False,
                                                          detector_snn=False))
    assert "b" in got["box_head"]["fc6"] and "box_predictor" in got


@pytest.mark.parametrize("backbone", ["resnet50", "mobilenet"])
def test_convert_backbone_state_dict_equals_jax(sds, backbone, tmp_path):
    """A bare classification trunk (detector prefix stripped, FPN and heads
    dropped, a classification head added) through the converter and
    through ``load_torch_backbone`` from a file."""
    sd = {k[len("backbone.body."):]: v for k, v in sds[backbone].items()
          if k.startswith("backbone.body.")}
    sd["fc.weight"] = torch.randn(1000, 64)
    got = ckpt.convert_torch_backbone_state_dict(sd, device="cpu")
    _assert_same_tree(got, jckpt.convert_torch_backbone_state_dict(sd))
    path = tmp_path / "trunk.pth"
    torch.save(sd, path)
    _assert_same_tree(ckpt.load_torch_backbone(str(path), device="cpu"),
                      jckpt.load_torch_backbone(str(path)))


def test_only_one_bbox_surgery_equals_jax(sds, tmp_path):
    path = tmp_path / "ckpt.pth"
    torch.save({"model": sds["resnet50"]}, path)   # per-class: bbox_pred has 20 outputs
    got = ckpt.load_torch_checkpoint(str(path), only_one_bbox=True, device="cpu")
    _assert_same_tree(got, jckpt.load_torch_checkpoint(str(path), only_one_bbox=True))
    assert "bbox_pred" not in got["box_head"]
    cfg = DetectorConfig(num_classes=5, t_rpn=2, t_det=2, min_size=64, max_size=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    merged = ckpt.load_weights_lenient(params, got, verbose=False)
    assert torch.equal(merged["box_head"]["bbox_pred"]["w"], params["box_head"]["bbox_pred"]["w"])
    assert torch.equal(merged["box_head"]["fc7"]["w"], got["box_head"]["fc7"]["w"])
    path4 = tmp_path / "ckpt4.pth"
    torch.save({"model": _mirror_sd("resnet50", only_one_bbox=True, seed=1)}, path4)
    kept = ckpt.load_torch_checkpoint(str(path4), only_one_bbox=True, device="cpu")
    assert kept["box_head"]["bbox_pred"]["w"].shape == (1024, 4)


def test_load_weights_lenient_equals_jax():
    """Leaves of matching shape come from the loaded tree (onto the current
    leaf's dtype and requires_grad), mismatched and missing ones stay, as
    in the JAX package's lenient load."""
    cfg = DetectorConfig(num_classes=4, t_rpn=2, t_det=2, min_size=64, max_size=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    loaded = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    loaded["box_head"]["cls_score"]["w"] = torch.zeros(1024, 7)   # mismatched
    del loaded["rpn_head"]["conv_bbox"]                           # missing
    params["rpn_head"]["shared_conv"]["w"].requires_grad_(True)
    got = ckpt.load_weights_lenient(params, loaded, verbose=False)

    def numpy_tree(t):
        if isinstance(t, dict):
            return {k: numpy_tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [numpy_tree(v) for v in t]
        return t.detach().numpy()

    want = jckpt.load_weights_lenient(numpy_tree(params), numpy_tree(loaded), verbose=False)
    _assert_same_tree(got, want)
    assert torch.equal(got["box_head"]["cls_score"]["w"], params["box_head"]["cls_score"]["w"])
    assert torch.equal(got["box_head"]["fc7"]["w"], loaded["box_head"]["fc7"]["w"])
    assert got["rpn_head"]["shared_conv"]["w"].requires_grad


def test_save_load_round_trip_and_rolling_alias(tmp_path):
    cfg = DetectorConfig(num_classes=4, t_rpn=2, t_det=2, min_size=64, max_size=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    head = {"box_head": params["box_head"]}
    opt, sched = build_optimizer(head, "AdamW", build_schedule(0.01, 2, milestones=(1,)))
    for leaf in tree_leaves(head):
        leaf.grad = torch.full_like(leaf, 1e-3)
    opt.step()
    sched.step()
    args = {"dataset": "cityscapes", "t_det": 2, "lr": 0.01, "milestones": [1],
            "fn": print}
    # As the training loop does: a weights-only file per epoch, then the
    # whole state to the rolling alias.
    for epoch in (0, 1):
        ckpt.save_checkpoint(str(tmp_path / f"model_{epoch}.pth"), {"params": params},
                             args=args)
        ckpt.save_checkpoint(str(tmp_path / "checkpoint.pth"),
                             {"params": params, "optimizer": opt, "scheduler": sched,
                              "epoch": epoch}, args=args)
    # Each call writes the file it names and nothing else.
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint.pth", "model_0.pth",
                                                           "model_1.pth"]
    rolling = tmp_path / "checkpoint.pth"
    assert set(ckpt.load_checkpoint(str(tmp_path / "model_0.pth"))) == {"params", "args"}
    full = ckpt.load_checkpoint(str(rolling), map_location="cpu")
    assert full["epoch"] == 1
    assert set(full) == {"params", "optimizer", "scheduler", "epoch", "args"}
    assert ckpt.load_checkpoint_args(str(rolling)) == {k: v for k, v in args.items()
                                                       if k != "fn"}
    assert ckpt.load_checkpoint_args(str(tmp_path / "absent.pth")) is None
    got, want = flatten_tree(full["params"]), flatten_tree(params)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    head2 = {"box_head": full["params"]["box_head"]}
    opt2, sched2 = build_optimizer(head2, "AdamW", build_schedule(0.01, 2, milestones=(1,)))
    opt2.load_state_dict(full["optimizer"])
    sched2.load_state_dict(full["scheduler"])
    for a, b in zip(tree_leaves(head), tree_leaves(head2)):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[a][k], opt2.state[b][k])
    assert sched2.last_epoch == sched.last_epoch == 1
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    # A directory that does not exist yet is made.
    ckpt.save_checkpoint(str(tmp_path / "sub" / "only.pth"), {"epoch": 5})
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == ["only.pth"]
