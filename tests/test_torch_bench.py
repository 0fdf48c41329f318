"""The port's benchmark (``bench_torch/``) on the CPU.

The cells' data files load into ``DetectorConfig``; ``flops.py`` gives the
hand-worked dense count of the flagship at 768 x 1536 and of a small
configuration; every cell's measurement function runs once at the 64 x 128
bucket with ``device="cpu"`` (the kernels' plain versions) and its JSON
line has its keys, units and a true correctness flag (never a time is
checked); check (c)'s statistics turn false on a perturbed output, a
perturbed head readout and an update that leaves the weights as they were;
the first update AdamW makes is the one the update check computes;
``bounds.py`` writes the bounds from three runs; ``python -m bench_torch``
exits non-zero without a card and prints no line.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_torch import bounds, flops, profile
from bench_torch import cells
from bench_torch.cells import (
    HEAD_TOL,
    LOSS_NAMES,
    LOSS_RTOL,
    MODES,
    RATE_TOL,
    UPDATE_TOL,
    Taps,
    adamw_first_update,
    cell_names,
    heads_gaps,
    held,
    leaf_gaps,
    load_cell,
    losses_gap,
    outputs_equal,
    rates_gap,
    rel_gap,
    run_cell,
    scale_gap,
)
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
CELLS = ("mnv3_eval_b2", "r50_dataset_eval_b2", "r50_eval_b2", "r50_rates_b2",
         "r50_train_frozen_b2", "r50_train_n3_b2")
# The cells at the 64 x 128 bucket with few RoIs; the dataset pass stores
# 128 x 256 images. The flagship's 8 and 12 steps: with fewer, so few spikes
# reach the readouts that the float32 route's gaps are those of single
# spikes. Training takes 4 box-head steps, the fewest that carry a spike to
# the box head's readouts (so that every trained group has a gradient),
# and K7's RPN head its 8.
SMALL = {"min_size": 64, "max_size": 128, "t_rpn": 8, "t_det": 12,
         "rpn": {"pre_nms_top_n_test": 100, "post_nms_top_n_test": 50,
                 "pre_nms_top_n_train": 100, "post_nms_top_n_train": 50,
                 "batch_size_per_image": 64},
         "roi": {"batch_size_per_image": 32}, "image_hw": (128, 256)}
SMALL_TRAIN = {**SMALL, "t_det": 4}


def test_cell_files_load():
    assert tuple(cell_names()) == CELLS
    for name in CELLS:
        cell = load_cell(name)
        assert isinstance(cell.config, DetectorConfig)
        assert cell.mode in MODES and cell.batch == 2 and cell.why
        assert cell.config.bucket == (768, 1536)
        assert (cell.config.t_rpn, cell.config.t_det, cell.config.num_classes) == (8, 12, 9)
        assert cell.config.compute_dtype == torch.bfloat16
        assert cell.config.snn_state_dtype == torch.float32
        assert set(cell.launches) <= set(cb.KERNELS) and all(cell.launches.values())
    assert load_cell("r50_train_n3_b2").config.backbone_trainable_stages == 3
    assert load_cell("r50_train_frozen_b2").config.backbone_trainable_stages == 0
    assert load_cell("mnv3_eval_b2").config.backbone == "mobilenet_v3_large_fpn"
    assert load_cell("mnv3_eval_b2").fpn_out_gain == 6.0
    assert load_cell("r50_dataset_eval_b2").image_hw == (1024, 2048)
    small = load_cell("r50_eval_b2", SMALL)
    assert small.config.bucket == (64, 128) and small.config.rpn.post_nms_top_n_test == 50
    assert small.config.rpn.nms_thresh == RPNConfig().nms_thresh


def test_flops_flagship_hand_worked():
    """ResNet-50-FPN at 768 x 1536, T_rpn 8, T_det 12, 1000 RoIs an image,
    batch 2; a multiply-add is two FLOPs."""
    cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12)
    got = flops.batch_flops(cfg, 2, training=False)
    n = 2
    # The stem: 7x7x3 -> 64 at 384 x 768.
    assert got["stem"] == n * 2 * 384 * 768 * 7 * 7 * 3 * 64
    # layer1 at 192 x 384: block 0 (conv1 64->64, conv2 3x3 64->64, conv3
    # 64->256, projection 64->256), blocks 1-2 (256->64, 3x3, 64->256).
    px = 192 * 384
    per_px = (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256) + 2 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    assert got["layer1"] == n * 2 * px * per_px
    # The FPN: a lateral 1x1 (C -> 256) and a 3x3 (256 -> 256) per level.
    levels = ((192, 384, 256), (96, 192, 512), (48, 96, 1024), (24, 48, 2048))
    assert got["fpn"] == n * 2 * sum(h * w * (c * 256 + 9 * 256 * 256) for h, w, c in levels)
    # The RPN head: 3x3 256 -> 256 and 256 -> 15 readouts on P2-P6, x 8 steps.
    pixels = 192 * 384 + 96 * 192 + 48 * 96 + 24 * 48 + 12 * 24
    assert got["rpn_head"] == n * 2 * pixels * (9 * 256 * 256 + 256 * 15) * 8
    # The box head: fc6 12544 -> 1024, fc7, readouts 1024 -> 9 + 36, x 12
    # steps over 1000 RoIs an image.
    assert got["box_head"] == n * 1000 * 2 * (12544 * 1024 + 1024 * 1024 + 1024 * 45) * 12
    # Pinned: about 3.19 TFLOP a batch (backbone 0.38, FPN 0.27, RPN 1.87,
    # box head 0.67).
    assert got["stem"] + sum(got[f"layer{i}"] for i in range(1, 5)) == 384_357_629_952
    assert got["total"] == 3_186_406_588_416
    # Training, frozen: the heads 3x over 512 sampled RoIs, the rest 1x.
    train = flops.batch_flops(cfg, 2, training=True)
    assert train["rpn_head"] == 3 * got["rpn_head"] and train["fpn"] == got["fpn"]
    assert train["box_head"] == 3 * got["box_head"] * 512 // 1000
    assert train["total"] == 7_276_410_961_920
    # N = 3: layer2-4 and the FPN 3x too.
    n3 = flops.batch_flops(dataclasses.replace(cfg, trainable_backbone_layers=3), 2, True)
    assert n3["layer2"] == 3 * got["layer2"] and n3["layer1"] == got["layer1"]
    assert n3["total"] == 8_431_824_273_408


def test_flops_small_config_hand_worked():
    """64 x 128, T 2 and 3, 5 classes, 20 RoIs an image, batch 1; and
    MobileNetV3-Large-FPN at the flagship's bucket."""
    cfg = DetectorConfig(num_classes=5, t_rpn=2, t_det=3, min_size=64, max_size=128,
                         rpn=RPNConfig(post_nms_top_n_test=20))
    got = flops.batch_flops(cfg, 1, training=False)
    pixels = 16 * 32 + 8 * 16 + 4 * 8 + 2 * 4 + 1 * 2
    assert got["rpn_head"] == 2 * pixels * (9 * 256 * 256 + 256 * 15) * 2
    assert got["box_head"] == 20 * 2 * (12544 * 1024 + 1024 * 1024 + 1024 * 25) * 3
    assert got["stem"] == 2 * 32 * 64 * 7 * 7 * 3 * 64
    assert got["total"] == 5_552_388_096
    mnv3 = flops.batch_flops(DetectorConfig(num_classes=9, t_rpn=8, t_det=12,
                                            backbone="mobilenet_v3_large_fpn"), 2, False)
    # Two stride-32 levels of 24 x 48 and the pool level of 12 x 24; 15
    # anchors a location (75 readout channels).
    assert mnv3["rpn_head"] == 2 * 2 * (2 * 24 * 48 + 12 * 24) * (9 * 256 * 256 + 256 * 75) * 8
    assert mnv3["fpn"] == 2 * 2 * 24 * 48 * (160 * 256 + 960 * 256 + 2 * 9 * 256 * 256)
    assert mnv3["total"] == 746_374_725_120


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_cpu(name):
    """The cell's measurement at 64 x 128 on the CPU, on the plain versions:
    its JSON line's keys and units, correct, no launch and no plain version
    counted on a card; device metrics not measured on the CPU."""
    cell = load_cell(name, SMALL_TRAIN if name.startswith("r50_train") else SMALL)
    line = run_cell(cell, "cpu", seed=0, repeats=2, iters=1, warmup=0)
    json.dumps(line)                                  # one JSON line
    assert line["correct"] is True, line["checks"]
    assert line["cell"] == name and line["device"] == {"type": "cpu"} and line["seed"] == 0
    metric, unit = (("steps_per_s", "steps/s") if cell.mode == "train"
                    else ("images_per_s", "images/s"))
    m = line["metrics"][metric]
    assert m["unit"] == unit and m["better"] == "higher" and m["n"] == 2
    assert {"value", "median", "q1", "q3", "samples", "window"} <= set(m)
    # The rate is all the work over all the seconds of the windows.
    work = 1 if cell.mode == "train" else 2
    assert m["value"] == pytest.approx(work * 2 / sum(line["window_s"]))
    assert line["metrics"]["peak_mem_gib"]["unit"] == "GiB"
    assert line["metrics"]["peak_mem_gib"]["value"] is None
    assert line["metrics"]["mfu"]["value"] is None
    assert line["metrics"]["mfu"]["flops_per_batch"]["total"] == flops.batch_flops(
        cell.config, 2, cell.mode == "train")["total"]
    assert line["failures"] == {"failed": 0, "attempted": 2}
    assert len(line["window_s"]) == 2 and all(t > 0 for t in line["window_s"])
    checks = line["checks"]
    assert {"launches", "outputs", "repeat"} <= set(checks)
    assert "vs_direct_batch" in checks if cell.mode == "dataset_eval" else "vs_float32" in checks
    assert checks["launches"]["want"] == {} and checks["launches"]["plain_versions_on_card"] == {}
    if cell.mode == "train":
        assert line["fg_detections"] is None and line["full_nms_batches"] is None
        assert set(checks["vs_float32"]["losses"]) == set(LOSS_NAMES) | {"loss_total"}
        assert "grads/rpn_losses/rpn_head/scale" in checks["vs_float32"]["gaps"]
        assert all(checks["outputs"]["gradient_reaches"].values())
        update = checks["update"]
        assert update["ok"] and all(update["moved_in_timed_steps"].values())
        assert {"first_step/rpn_head", "after_timed/box_head/scale"} <= set(update["gaps"])
    else:
        # 50 RoIs an image are no more than the pruned NMS's 128 rows: every
        # timed batch takes the full branch here.
        assert line["full_nms_batches"] == 2 and line["fg_detections"] >= 0
    if cell.mode in ("eval", "eval_rates"):
        rates = checks["vs_float32"]["rates"]
        levels = len(cell.config.fpn_strides)
        assert len(rates) == 2 * levels + 3
        assert set(HEAD_TOL[cell.config.backbone]) <= set(checks["vs_float32"]["gaps"])
    assert line["layers"] is None and line["breakdown"] is None


def test_check_c_turns_false_on_a_perturbed_output():
    # The flagship's rates on the card are about 0.5 (encoders), 0.19 (the
    # RPN's LIF layer) and 0.26 / 0.15 (fc6 / fc7); a K1 that drops one of
    # eight steps takes about an eighth of the LIF layer's spikes.
    rates = {"rpn/encoder/0": 0.47, "rpn/shared/0": 0.19, "det/fc6": 0.26}
    assert rates_gap(rates, dict(rates)) == 0.0
    assert rates_gap({**rates, "rpn/shared/0": 0.19 * 7 / 8}, rates) > RATE_TOL
    assert rates_gap({**rates, "det/fc6": 0.26 + 1e-3}, rates) <= RATE_TOL
    assert rates_gap({k: v for k, v in rates.items() if k != "det/fc6"}, rates) == float("inf")
    losses = {"loss_objectness": 0.69, "loss_rpn_box_reg": 1.3, "loss_classifier": 2.2,
              "loss_box_reg": 0.07}

    def agree(got):
        return held(losses_gap(got, losses), LOSS_RTOL)["ok"]

    assert agree(dict(losses))
    assert max(losses_gap(losses, dict(losses)).values()) == 0.0
    assert not agree({**losses, "loss_box_reg": 0.07 * 1.5})
    assert not agree({**losses, "loss_classifier": 2.2 * 1.03})
    assert losses_gap({**losses, "loss_classifier": float("nan")},
                      losses)["loss_classifier"] == float("inf")
    assert not agree({k: v for k, v in losses.items() if k != "loss_objectness"})
    out = {"scores": torch.rand(2, 5), "det_rates": {"fc6": torch.rand(10)}}
    same = {"scores": out["scores"].clone(), "det_rates": {"fc6": out["det_rates"]["fc6"].clone()}}
    assert outputs_equal(out, same)
    same["det_rates"]["fc6"][3] = torch.nextafter(same["det_rates"]["fc6"][3], torch.tensor(2.0))
    assert not outputs_equal(out, same)
    assert not outputs_equal(out, {"scores": out["scores"]})


def test_gap_statistics():
    g = torch.Generator().manual_seed(0)
    want = torch.randn(1000, generator=g)
    noise = 0.1 * torch.randn(1000, generator=g)
    # Differences either way: the relative norm sees them, the scale hardly.
    assert rel_gap(want + noise, want) == pytest.approx(0.1, rel=0.1)
    assert scale_gap(want + noise, want) < 0.01
    # A share of the signal lost: the scale sees it.
    assert scale_gap(0.875 * want, want) == pytest.approx(0.125)
    # The same values in other places: the relative norm sees it.
    assert rel_gap(want.flip(0), want) > 1.0
    zero = torch.zeros(3)
    assert rel_gap(zero, zero) == scale_gap(zero, zero) == 0.0
    assert rel_gap(torch.ones(3), zero) == scale_gap(torch.ones(3), zero) == float("inf")
    assert rel_gap(torch.tensor([float("nan")]), torch.ones(1)) == float("inf")
    assert rel_gap([want[:10], want[10:]], [want[:10], want[10:]]) == 0.0
    leaves = {"rpn_head/a": want, "rpn_head/b": 2 * want, "box_head/c": want}
    got = leaf_gaps("g", {**leaves, "rpn_head/b": 1.5 * want}, leaves)
    assert got["g/rpn_head/scale"] == pytest.approx(0.25) and got["g/box_head"] == 0.0
    missing = leaf_gaps("g", {k: v for k, v in leaves.items() if k != "box_head/c"}, leaves)
    assert missing["g/box_head"] == float("inf") and missing["g/rpn_head"] == 0.0
    check = held({"a": 0.1, "b": 3.0}, {"a": 0.2})
    assert check["ok"] and check["tols"] == {"a": 0.2}
    assert not held({"a": 0.3}, {"a": 0.2})["ok"]


def test_adamw_first_update_is_torchs():
    """The update check's AdamW update is what torch's AdamW does on its
    first step, leaf by leaf; a step that leaves the weights as they were is
    as far from it as can be."""
    cell = load_cell("r50_train_frozen_b2")
    g = torch.Generator().manual_seed(3)
    leaves = {"rpn_head/w": torch.randn(64, 32, generator=g) * 0.05,
              "box_head/w": torch.randn(128, generator=g),
              "box_head/none": torch.randn(16, generator=g)}
    params = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    grads = {"rpn_head/w": torch.randn(64, 32, generator=g) * 1e-3,
             "box_head/w": torch.randn(128, generator=g) * 1e-9}
    for k, v in grads.items():
        params[k].grad = v.clone()
    o = cell.optimizer
    opt = torch.optim.AdamW(list(params.values()), lr=o["lr"], eps=o["eps"],
                            weight_decay=o["weight_decay"])
    opt.step()
    change = {k: params[k].detach() - leaves[k] for k in leaves}
    want = adamw_first_update(cell, leaves, grads)
    gaps = leaf_gaps("first_step", change, want)
    assert held(gaps, UPDATE_TOL)["ok"], gaps
    assert torch.equal(change["box_head/none"], torch.zeros(16))
    frozen = leaf_gaps("first_step", {k: torch.zeros_like(v) for k, v in leaves.items()}, want)
    assert frozen["first_step/rpn_head"] == 1.0 and not held(frozen, UPDATE_TOL)["ok"]


def test_heads_check_turns_false_on_a_perturbed_readout():
    """The heads' readouts of a call, recorded by Taps, against the float32
    heads: within HEAD_TOL as they are, not with a share of the objectness
    or class logits lost (a step left out of a readout)."""
    cell = load_cell("r50_eval_b2", SMALL)
    cfg = cell.config
    params = cells._params(cell, torch.device("cpu"), 0)
    batch = cells._image_batch(torch.Generator().manual_seed(1), 2, cfg, torch.device("cpu"))
    originals = cells.detector_mod.make_head_applies, cells.roi_mod.roi_align
    with Taps() as taps:
        cells.detector_apply(params, batch, cfg)
    got = taps.got
    assert {"features", "objectness", "rpn_deltas", "proposals", "class_logits",
            "box_deltas"} <= set(got)
    assert (cells.detector_mod.make_head_applies, cells.roi_mod.roi_align) == originals
    tols = HEAD_TOL[cfg.backbone]
    sound = heads_gaps(params, cfg, got)
    assert held(sound, tols)["ok"], sound
    for key in ("objectness", "class_logits"):
        scaled = [t * 0.875 for t in got[key]] if isinstance(got[key], list) else got[key] * 0.875
        broken = heads_gaps(params, cfg, {**got, key: scaled})
        assert broken[f"{key}/scale"] == pytest.approx(
            1 - 0.875 * (1 + sound[f"{key}/scale"]), abs=0.02)
        assert not held(broken, tols)["ok"]


def test_layer_names():
    assert profile.layer_of("void rpn_level_kernel<true, 2, false>(CUtensorMap_st)") == \
        "K1 rpn_head, training instance"
    assert profile.layer_of("void rpn_level_kernel<false, 2, false>(CUtensorMap_st)") == \
        "K1 rpn_head"
    assert profile.layer_of("void sgemm::spike_gemm_kernel<128, 8, sgemm::StoreF32T<0> >()") == \
        "K3 encoder_fc6"
    assert profile.layer_of("void sgemm::spike_gemm_kernel<128, 4, sgemm::LifCodesT<0> >()") == \
        "K4 box_tail"
    assert profile.layer_of("void sgemm::spike_gemm_kernel<64, 8, sgemm::LiOutF32T<0> >()") == \
        "K9 box_head_fused"
    assert profile.layer_of("void wgrad_kernel<8>(CUtensorMap_st)") == "K7 rpn_head_bwd"
    assert profile.layer_of("sm90_xmma_wgrad_implicit_gemm_bf16bf16") == "cuDNN convolutions"
    assert profile.layer_of("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n") == "cuBLAS GEMMs"
    assert profile.layer_of("Memcpy HtoD (Pinned -> Device)") == "copies"
    assert profile.layer_of("void at::native::vectorized_elementwise_kernel<4, "
                            "at::native::AddFunctor<float> >()") == "elementwise"
    assert profile.layer_of("void at::native::reduce_kernel<512, 1>()") == "other"


def _run_lines(scale):
    """One synthetic run's lines: every cell correct, rates scaled."""
    lines = []
    for name in CELLS:
        metric = "steps_per_s" if load_cell(name).mode == "train" else "images_per_s"
        lines.append({"cell": name, "correct": True, "device": {"smi": "card, 700.00 W"},
                      "metrics": {metric: {"unit": "x/s", "value": 10.0 * scale,
                                           "median": 9.0 * scale,
                                           "samples": [8.0 * scale, 9.0 * scale, 10.0 * scale]},
                                  "peak_mem_gib": {"value": 4.0},
                                  "mfu": {"unit": "fraction", "value": 0.1 * scale}},
                      "layers": {"device_busy_share": 0.3, "launches_per_batch": 1200.0,
                                 "device_busy_ms_per_batch": 15.0 * scale,
                                 "device_ms_per_batch": {"K1 rpn_head": 5.0 * scale}},
                      "fg_detections": 0, "full_nms_batches": 0})
    return lines


def test_bounds_from_three_runs():
    out = bounds.benchmark([_run_lines(1.0), _run_lines(1.02), _run_lines(0.9)])
    assert out["paths"] == ["bench_torch"] and out["runs"] == 3
    assert [w["name"] for w in out["workloads"]] == list(CELLS)
    w = out["workloads"][0]
    assert w["chips"] == 1 and w["config"] == "bench_torch/configs/mnv3_eval_b2.json"
    rate = w["metrics"]["images_per_s"]
    assert rate["baseline"] == 10.0 and rate["bound"] == pytest.approx(1.5 * 1.2 / 10.0)
    assert w["metrics"]["peak_mem_gib"]["bound"] == bounds.FLOOR["peak_mem_gib"]
    assert w["metrics"]["mfu"]["bound"] == rate["bound"]
    assert w["layer_metrics"]["device_ms_per_batch/K1 rpn_head"]["median"] == 5.0
    assert w["layer_metrics"]["images_per_s/window_median"]["median"] == 9.0
    assert w["layer_metrics"]["images_per_s/window_spread"]["readings"] == \
        pytest.approx([2.0 / 9.0] * 3)
    busy = w["layer_metrics"]["device_busy_ms_per_batch"]
    assert busy["baseline"] == 15.0 and busy["better"] == "lower"
    assert busy["bound"] == pytest.approx(1.5 * (15.0 * 1.02 - 15.0 * 0.9) / 15.0)
    with pytest.raises(ValueError):
        bounds.benchmark([_run_lines(1.0), _run_lines(1.0)])


def test_main_exits_nonzero_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "bench_torch", "--cell", "r50_eval_b2"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr
