#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  1. device  - a CUDA device must be present; prints its name and power
               limit as nvidia-smi reports them.
  2. build   - compiles the four hand-written kernels from
               snn_automotive_object_detection_tpu_torch/csrc (one nvcc per
               source, all started together).
  3. kernels - at the flagship shapes (768x1536 bucket, batch 2, 1000
               proposals per image, T_rpn=8, T_det=12), runs each kernel and
               its plain PyTorch version on the same seeded inputs, checks
               the stated tolerance element by element and exact encoder
               spike counts, prints the largest output beside each error,
               spike rates, flipped LIF spikes and median times from CUDA
               events.
  4. main    - the flagship detector (ResNet-50-FPN, spiking RPN and box
               heads, bf16 GEMMs, f32 neuron states, random weights from a
               seed) on synthetic 2 x 768 x 1536 batches through
               detector_apply; every kernel must have launched, no plain
               version may have run on the GPU, outputs must be finite and
               well formed; prints images/s, then one more batch under
               torch.profiler: device time by kernel and the busy share.

The line before last is a JSON object listing the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def _median_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_kernels(dev, results):
    import torch

    from snn_automotive_object_detection_tpu_torch.ops import cuda_roi_align as k2
    from snn_automotive_object_detection_tpu_torch.ops.roi_align import level_geometry
    from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6 as k3
    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1
    from snn_automotive_object_detection_tpu_torch.snn import cuda_tail as k4
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    g = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    levels = [(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)]

    # K1: spiking RPN head, all five levels (features spread over the
    # encoder's range so every period 1..T and "never" occurs).
    feats = [torch.rand((2, h, w, 256), generator=g, device=dev).mul(2.0).to(bf)
             for h, w in levels]
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.01
    w9 = w_shared.reshape(9, 256, 256).to(bf).contiguous()
    wo = w_out.to(bf).contiguous()

    def k1_kernel(spike_sum=False):
        return [k1._launch(f, w9, wo, 8, spike_sum) for f in feats]

    def k1_plain(spike_sum=False):
        return [k1.rpn_level_plain(f, w_shared, w_out, 8, spike_sum) for f in feats]

    got, want = k1_kernel(True), k1_plain(True)
    out_k = torch.cat([a[0].flatten() for a in got])
    out_p = torch.cat([b[0].flatten() for b in want])
    err = (out_k - out_p).abs().max().item()
    worst = kc.excess(out_k, out_p)
    enc_k = sum(a[1].sum().item() for a in got)
    enc_p = sum(b[1].sum().item() for b in want)
    lif_p = sum(b[2].sum().item() for b in want)
    # A neuron whose spike train differs has another LI-weighted spike sum.
    flips = sum((a[3] != b[3]).sum().item() for a, b in zip(got, want))
    neurons = sum(2 * h * w * 256 * 8 for h, w in levels)
    print(f"K1 rpn_head: max|out diff| {err:.3g} at max|out| "
          f"{out_p.abs().max().item():.4g}, {worst:.3g} of the bound "
          f"2^-7|want| + {kc.ATOL}; bf16-valued {kc.bf16_valued(out_k)}; "
          f"encoder spikes {enc_k} vs {enc_p}; LIF spikes {lif_p}, neurons with "
          f"a flipped spike {flips}; rates encoder {enc_p / neurons:.4f} "
          f"LIF {lif_p / neurons:.4f}")
    if enc_k != enc_p or worst > 1 or not kc.bf16_valued(out_k) or \
            lif_p == 0 or flips > 1e-3 * lif_p:
        _fail("K1 disagrees with its plain version")
    ms, pms = _median_ms(k1_kernel, 10), _median_ms(k1_plain, 5)
    results.append(dict(name="rpn_head", route="cuda",
                        source="snn_automotive_object_detection_tpu_torch/csrc/rpn_head.cu",
                        replaces="snn_automotive_object_detection_tpu/snn/pallas_rpn.py:449",
                        max_abs_err=err, ms=ms, plain_ms=pms))
    print(f"K1 rpn_head: {ms:.3f} ms kernel, {pms:.3f} ms plain (5 levels)")

    # K2: RoIAlign of 2 x 1000 boxes over P2..P5.
    pooled_feats = [torch.randn((2, h, w, 256), generator=g, device=dev).to(bf)
                    for h, w in levels[:4]]
    ctr = torch.rand((2, 1000, 2), generator=g, device=dev) * torch.tensor(
        [1536.0, 768.0], device=dev)
    size = torch.rand((2, 1000, 2), generator=g, device=dev) * 400.0 + 4.0
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], dim=-1).contiguous()
    got = k2._launch(pooled_feats, boxes, (768, 1536))
    want = k2.plain(pooled_feats, boxes, (768, 1536))
    err = (got - want).abs().max().item()
    lv, _ = level_geometry(pooled_feats, boxes, (768, 1536))
    print(f"K2 roi_align: max|diff| {err:.3g} (tol 1e-5) at max|out| "
          f"{want.abs().max().item():.4g}; boxes per level "
          f"{torch.bincount(lv.flatten().long(), minlength=4).tolist()}")
    if err > 1e-5 or not torch.isfinite(got).all():
        _fail("K2 disagrees with its plain version")
    ms = _median_ms(lambda: k2._launch(pooled_feats, boxes, (768, 1536)), 10)
    pms = _median_ms(lambda: k2.plain(pooled_feats, boxes, (768, 1536)), 5)
    results.append(dict(name="roi_align", route="cuda",
                        source="snn_automotive_object_detection_tpu_torch/csrc/roi_align.cu",
                        replaces="snn_automotive_object_detection_tpu/ops/pallas_roi_align.py:309",
                        max_abs_err=err, ms=ms, plain_ms=pms))
    print(f"K2 roi_align: {ms:.3f} ms kernel, {pms:.3f} ms plain")

    # K3: encoder + fc6, R = 2000 rows of 7*7*256.
    x = (torch.rand((2000, 12544), generator=g, device=dev) * 2.5).to(bf)
    w6 = ((torch.rand((12544, 1024), generator=g, device=dev) * 2 - 1)
          / 112.0).to(bf).contiguous()
    got, cnt_k = k3._launch(x, w6, 12)
    want, cnt_p = k3.encoder_fc6_plain(x, w6, 12)
    err = (got - want).abs().max().item()
    rate = cnt_p.sum().item() / (2000 * 12544 * 12)
    print(f"K3 encoder_fc6: max|cur6 diff| {err:.3g} (tol 1e-3) at max|cur6| "
          f"{want.abs().max().item():.4g}; encoder "
          f"counts equal {bool(torch.equal(cnt_k, cnt_p))}; encoder rate {rate:.4f}")
    if err > 1e-3 or not torch.equal(cnt_k, cnt_p) or rate == 0:
        _fail("K3 disagrees with its plain version")
    ms = _median_ms(lambda: k3._launch(x, w6, 12), 10)
    pms = _median_ms(lambda: k3.encoder_fc6_plain(x, w6, 12), 3)
    results.append(dict(name="encoder_fc6", route="cuda",
                        source="snn_automotive_object_detection_tpu_torch/csrc/encoder_fc6.cu",
                        replaces="snn_automotive_object_detection_tpu/snn/pallas_fc6.py:227",
                        max_abs_err=err, ms=ms, plain_ms=pms))
    print(f"K3 encoder_fc6: {ms:.3f} ms kernel, {pms:.3f} ms plain")

    # K4: box-head tail on bf16 fc6 currents around the LIF threshold.
    cur6 = (torch.randn((12, 2000, 1024), generator=g, device=dev) * 0.15).to(bf)
    w7 = ((torch.rand((1024, 1024), generator=g, device=dev) * 2 - 1) / 32.0)
    wc = ((torch.rand((1024, 9), generator=g, device=dev) * 2 - 1) / 32.0)
    wb = ((torch.rand((1024, 36), generator=g, device=dev) * 2 - 1) / 32.0)
    w7b = w7.to(bf).contiguous()
    wro = torch.cat([wc, wb], 1).to(bf).contiguous()
    got = k4._launch(cur6, w7b, wro, 9)
    want = k4.box_tail_plain(cur6, w7, wc, wb)
    err = max((got[0] - want[0]).abs().max().item(),
              (got[1] - want[1]).abs().max().item())
    worst = max(kc.excess(got[0], want[0]), kc.excess(got[1], want[1]))
    top = max(want[0].abs().max().item(), want[1].abs().max().item())
    d6 = (got[2] - want[2]).abs().sum().item()
    d7 = (got[3] - want[3]).abs().sum().item()
    r6 = want[2].sum().item() / (2000 * 1024 * 12)
    r7 = want[3].sum().item() / (2000 * 1024 * 12)
    print(f"K4 box_tail: max|logit diff| {err:.3g} at max|logit| {top:.4g}, "
          f"{worst:.3g} of the bound 2^-7|want| + {kc.ATOL}; spike-count diffs "
          f"per row fc6 {d6} fc7 {d7}; rates fc6 {r6:.4f} fc7 {r7:.4f}")
    if worst > 1 or d6 != 0 or d7 > 1e-3 * want[3].sum().item() or r7 == 0:
        _fail("K4 disagrees with its plain version")
    ms = _median_ms(lambda: k4._launch(cur6, w7b, wro, 9), 10)
    pms = _median_ms(lambda: k4.box_tail_plain(cur6, w7, wc, wb), 5)
    results.append(dict(name="box_tail", route="cuda",
                        source="snn_automotive_object_detection_tpu_torch/csrc/box_tail.cu",
                        replaces="snn_automotive_object_detection_tpu/snn/pallas_tail.py:241",
                        max_abs_err=err, ms=ms, plain_ms=pms))
    print(f"K4 box_tail: {ms:.3f} ms kernel, {pms:.3f} ms plain")


def _pre_nms_rows(cfg):
    h, w = cfg.bucket
    return sum(min(cfg.rpn.pre_nms_top_n_test, (h // s) * (w // s) * 3)
               for s in (4, 8, 16, 32, 64))


def _check_outputs(out, n, p, d, c, s):
    import torch

    shapes = {"boxes": (n, d + p, 4), "scores": (n, d + p), "labels": (n, d + p),
              "valid": (n, d + p), "proposals": (n, s, 4), "objectness": (n, s),
              "all_scores": (n, p, c), "all_boxes": (n, p, c, 4)}
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp:
            _fail(f"{k}: shape {tuple(out[k].shape)} != {shp}")
        if out[k].is_floating_point() and not torch.isfinite(out[k]).all():
            _fail(f"{k}: non-finite values")
    sc = out["scores"]
    if (sc < 0).any() or (sc > 1).any() or (out["labels"] >= c).any():
        _fail("scores outside [0, 1] or labels outside the classes")
    for group in ("rpn_rates", "det_rates"):
        for k, v in out[group].items():
            if not torch.isfinite(v).all() or (v < 0).any() or (v > 1).any():
                _fail(f"{group}/{k}: rates outside [0, 1]")


def _profile(run):
    """Device time of one ``run()`` by kernel, the device's busy share of
    the wall time, and the host-side ops with the most self time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            rows.append((e.self_cuda_time_total if us is None else us, e.count, e.key))
        else:  # host-side ops; the kernels they launch are rows of their own
            host.append((e.self_cpu_time_total, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        _fail("the profiler recorded no device time")
    print(f"profile: one batch {wall_us / 1e3:.3f} ms wall, {busy / 1e3:.3f} ms "
          f"kernel and copy time on the device ({100 * busy / wall_us:.1f}% busy), "
          f"{sum(r[1] for r in rows)} device events")
    for us, count, key in rows[:25]:
        print(f"profile: {us / 1e3:10.3f} ms {100 * us / busy:5.1f}% x{count:<4d} {key[:90]}")
    for us, count, key in host[:10]:
        print(f"profile host: {us / 1e3:10.3f} ms self x{count:<5d} {key[:80]}")


def main_path(dev, iters=5):
    import torch

    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n, (h, w) = 2, cfg.bucket
    g = torch.Generator(device=dev).manual_seed(1)
    batches = [{"images": torch.rand((n, h, w, 3), generator=g, device=dev),
                "image_sizes": torch.tensor([[h, w]] * n, device=dev),
                "original_sizes": torch.tensor([[1024, 2048]] * n, device=dev)}
               for _ in range(2)]
    detector_apply(params, batches[0], cfg, collect_rates=True)  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    cb.reset_counts()
    t0 = time.perf_counter()
    for i in range(iters):
        out = detector_apply(params, batches[i % 2], cfg, collect_rates=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cb.LAUNCHES)
    plain_calls = dict(cb.PLAIN_CUDA_CALLS)

    print(f"main path: {iters} batches of {n} x {h} x {w}: launches {launches}, "
          f"plain versions on the GPU {plain_calls}")
    if any(v == 0 for v in launches.values()):
        _fail("a kernel of the main path never launched")
    if any(v != 0 for v in plain_calls.values()):
        _fail("a plain version ran on the GPU in the main path")
    _check_outputs(out, n, cfg.rpn.post_nms_top_n_test,
                   cfg.roi.detections_per_img, cfg.num_classes, _pre_nms_rows(cfg))
    fg = (out["valid"] & (out["labels"] > 0)).sum().item()
    rr = {k: [round(x, 4) for x in v.mean(dim=1).tolist()]
          for k, v in out["rpn_rates"].items()}
    dr = {k: round(v.mean().item(), 4) for k, v in out["det_rates"].items()}
    print(f"main path: {fg} FG detections in the last batch; RPN rates per "
          f"level {rr}; box-head rates {dr}")
    ips = n * iters / dt
    print(f"main path: {ips:.3f} images/s ({dt / iters * 1000:.1f} ms per batch, "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB)")
    _profile(lambda: detector_apply(params, batches[0], cfg, collect_rates=True))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    # f32 products and convolutions run in full f32, not TF32: the plain
    # versions are the references the kernels are held against, and the
    # f32 readouts in them must not lose precision to TF32. For the same
    # reason cuBLAS may not reduce bf16 products in bf16: the references
    # round each product once, from f32, as the kernels do.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = cb.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    results = []
    check_kernels(dev, results)
    launches = main_path(dev)
    for r in results:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
