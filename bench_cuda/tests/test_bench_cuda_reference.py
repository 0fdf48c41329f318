"""The benchmark's plain reference against the port's float32 route, at
64 x 128 on the CPU, for both configurations: stage by stage on the same
inputs, and end to end through the comparison that decides ``correct``."""

import ast
from pathlib import Path

import pytest
import torch

from bench_cuda import harness, weights
from bench_cuda.reference import model as ref

SMALL = {"config": {"min_size": 64, "max_size": 128,
                    "rpn": {"pre_nms_top_n_test": 50, "post_nms_top_n_test": 30}},
         "mix": {"batch": 2, "distinct_batches": 2, "warmup_calls": 1, "traced_batches": 4}}
CELLS = ("r50_eval_b8", "mnv3_eval_b16")
PORT = "snn_automotive_object_detection_tpu_torch"


def _small(cell, **config):
    ov = {"config": {**SMALL["config"], **config}, "mix": dict(SMALL["mix"])}
    return harness.cell_files(harness.manifest(), cell, ov)[1:3], ov


@pytest.mark.parametrize("cell", CELLS)
def test_stages_equal_the_port_float32_route(cell):
    from snn_automotive_object_detection_tpu_torch.models import detector as det
    from snn_automotive_object_detection_tpu_torch.ops.roi_align import multiscale_roi_align
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
        convert_torch_state_dict,
    )

    (cfg, mix), _ = _small(cell, compute_dtype="float32")
    pcfg = harness.port_config(cfg)
    sd = weights.make_state_dict(cfg, 3, "cpu")
    params = convert_torch_state_dict(sd, True, True, device="cpu")
    images = harness.eval_batches(mix, cfg, 3, "cpu")[0]["images"]
    with torch.inference_mode():
        feats = det.backbone_features(params, images, pcfg, False)
        want = ref.backbone_features(sd, cfg, images)
        for f, w in zip(feats, want):
            # The same float32 ops; the convs' layouts (NHWC there, NCHW here)
            # sum in another order.
            gap = (f.permute(0, 3, 1, 2) - w).abs().max() / w.abs().max()
            assert float(gap) < 1e-5
        nchw = [f.permute(0, 3, 1, 2) for f in feats]
        rpn_apply, box_apply = det.make_head_applies(pcfg, params, False)
        objs, dels, _ = rpn_apply(feats)
        robjs, rdels, spikes = ref.rpn_head(sd, nchw, cfg["t_rpn"])
        for a, b in zip(objs + dels, robjs + rdels):
            assert torch.equal(a, b)
        assert float(spikes.sum()) > 0
        boxes = torch.tensor([[[3.0, 4.0, 40.0, 50.0], [10.0, 0.0, 120.0, 60.0],
                               [0.0, 0.0, 20.0, 12.0]]] * 2)
        pooled = multiscale_roi_align(feats[:-1], boxes, cfg["bucket"])
        rpooled = ref.roi_align(nchw[:-1], boxes, cfg["bucket"])
        assert torch.equal(pooled.permute(0, 1, 4, 2, 3), rpooled)
        cls, reg, _ = box_apply(pooled.reshape(6, -1))
        rcls, rreg = ref.box_head(sd, rpooled.reshape(6, -1), cfg["t_det"])
        assert torch.equal(cls, rcls) and torch.equal(reg, rreg)


@pytest.mark.parametrize("cell", CELLS)
def test_heads_in_bf16_equal_the_port_plain_versions(cell):
    """The heads as the judge runs them (what the configuration stores in
    bf16 rounded to it) against the port's bf16 route on the CPU, where its
    kernels run as their plain versions, on the same FPN levels: the same
    bits."""
    from snn_automotive_object_detection_tpu_torch.models import detector as det
    from snn_automotive_object_detection_tpu_torch.ops.cuda_roi_align import roi_align
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
        convert_torch_state_dict,
    )

    (cfg, mix), _ = _small(cell)
    pcfg = harness.port_config(cfg)
    sd = weights.make_state_dict(cfg, 4, "cpu")
    params = convert_torch_state_dict(sd, True, True, device="cpu")
    images = harness.eval_batches(mix, cfg, 4, "cpu")[0]["images"]
    heads = ref.Precision(cast=torch.bfloat16)
    with torch.inference_mode():
        feats = det.backbone_features(params, images, pcfg, False)
        nchw = [f.float().permute(0, 3, 1, 2) for f in feats]
        rpn_apply, box_apply = det.make_head_applies(pcfg, params, False)
        objs, dels, _ = rpn_apply(feats)
        robjs, rdels, _ = ref.rpn_head(sd, nchw, cfg["t_rpn"], heads)
        for a, b in zip(objs + dels, robjs + rdels):
            assert torch.equal(a, b)
        boxes = torch.tensor([[[3.0, 4.0, 40.0, 50.0], [10.0, 0.0, 120.0, 60.0],
                               [0.0, 0.0, 20.0, 12.0]]] * 2)
        cls, reg, _ = box_apply(roi_align(feats[:-1], boxes, cfg["bucket"]).reshape(6, -1))
        rcls, rreg = ref.box_head(sd, ref.roi_align(nchw[:-1], boxes, cfg["bucket"]).reshape(6, -1),
                                  cfg["t_det"], heads)
        assert torch.equal(cls, rcls) and torch.equal(reg, rreg)


@pytest.mark.parametrize("cell", CELLS)
def test_port_float32_route_passes_the_comparison(cell):
    """The port's float32 route, judged as a run judges the bf16 one: every
    reading near zero and the postprocess followed exactly."""
    _, ov = _small(cell, compute_dtype="float32")
    line = harness.run(cell, 5, 0.0, False, 0.0, device="cpu", overrides=ov)
    r = line["readings"]
    assert r["detections"] == 0 and r["proposals"] == 0
    assert r["objectness"] < 1e-5 and r["objectness_scale"] < 1e-5
    assert r["class_scores"] < 0.05 and r["box_shifts"] < 0.05


def test_reference_imports_nothing_of_the_program():
    banned = {PORT, *harness.BANNED}
    for path in (Path(harness.ROOT) / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in banned, (path.name, name)
                # Within the benchmark only the reference itself.
                assert (not name.startswith("bench_cuda")
                        or name.startswith("bench_cuda.reference")), (path.name, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_follows_the_port(dtype):
    """The frozen-backbone step: the reference's first three steps against
    the port's, in float32 (the scans) and in bf16 (the training kernels'
    plain versions on the CPU), at 64 x 128."""
    ov = {"config": {"min_size": 64, "max_size": 128, "compute_dtype": dtype,
                     "rpn": {"pre_nms_top_n_train": 60, "post_nms_top_n_train": 40},
                     "roi": {"batch_size_per_image": 32}},
          "mix": {"batch": 2, "distinct_batches": 4, "max_boxes": 4}}
    r = harness.run("r50_train_frozen_b16", 7, 0.0, False, 0.0, device="cpu",
                    overrides=ov)["readings"]
    assert r["loss"] < 2e-3 and r["first_gradient"] < 2e-3 and r["change"] < 2e-3
