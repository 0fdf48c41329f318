#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  1. device  - a CUDA device must be present; prints its name and power
               limit as nvidia-smi reports them.
  2. build   - compiles the hand-written kernels (the nine TPU kernels'
               counterparts and the bf16-state instances of K1, its
               training instance, K7 and K8; K8 and K1's instances live in
               K1's source, K7's in K7's) from
               snn_automotive_object_detection_tpu_torch/csrc (one nvcc per
               source, all started together).
  3. kernels - at the flagship shapes (768x1536 bucket, batch 2, 1000
               proposals per image, T_rpn=8, T_det=12), runs each kernel and
               its plain PyTorch version on the same seeded inputs, checks
               the stated tolerance element by element and exact encoder
               spike counts, prints the largest output beside each error,
               spike rates, flipped LIF spikes and median times from CUDA
               events; beside each time the least time the card could take
               (compulsory bytes over 3.35 TB/s against operations over the
               dense bf16 tensor-core and the f32 peak, counting the spikes
               these inputs produce), and for the stem and the FPN the time
               of the unfused cuDNN chain in bf16 on the same inputs (for
               the FPN level by level too); for the box head's encoder +
               fc6 (K3) and tail (K4) and the RPN head's weight gradient
               (K7), which no single call computes, cuBLAS's time for the
               dense product alone on materialised spikes (the T R encoder
               spikes by w6, the fc6 spikes by w7, per tap the shifted
               encoder spikes by dc), and K3's dense TFLOP/s; K3 and K4 are
               held and timed again at T = 20 and 32 (two code planes, two
               GEMM passes), K9 at T = 32, 40 and 48 (three planes). K1's
               instance for bf16 neuron states is held to its plain version
               on the five flagship levels with flipped spikes counted, and
               with none allowed on weights whose conv sums are exact in any
               order, and timed in turns with K1. With bf16 states too,
               K1's training instance (held as that instance, its readout,
               counts and spike sums that instance's bits, no flip and its
               currents the plain version's bits on those weights), K7 on
               its saved tensors (K7's bounds) and K8 (K1's bf16-state bits),
               each timed in turns with the instance it extends. The RPN head
               (K1) is held to the plain version with flipped LIF spikes
               counted neuron by neuron, timed level by level and with the
               dense TFLOP/s it reaches; its training instance must give
               the evaluation instance's readout, counts and spike sums bit
               for bit, the plain version's periods and its currents within
               one bf16 ulp, and is timed in turns with it. The RPN head's
               backward kernel (K7) gets seeded cotangents and K1's saved
               tensors: both weight gradients within 5e-4 of their largest
               element of its plain version on the same saved tensors (and
               of the replaying plain version where K1's currents are that
               version's bits), the sweep's spike sums equal to K1's neuron
               by neuron, the same bits on a second run; its sweep and
               weight gradient are timed apart. K1 and K7 also run at 75 readout
               channels on one [2, 24, 48, 256] level. The paired RPN head
               (K8) must give K1's readout and spike sums bit for bit and
               is held to its plain version on the five levels, on a batch
               of four and on MobileNet's three levels at 75 channels, and
               timed in turns with K1 on the flagship's and MobileNet's
               levels. The fused box head (K9) is held to its plain
               version at R = 2000 spike by spike: its fc6 spike trains
               against the plain version's and, on its own fc6 spikes, the
               plain tail's fc7 trains against its own (flipped bits at
               most 1e-3 of the spikes), every row whose fc7 trains agree
               within 1e-3 (1 + |want|) of that tail, all rows within 0.25
               (1 + |want|) of the whole plain head; it is timed in turns
               with the two-kernel route (K3 then K4) on the same inputs.
               The
               RoIAlign (K2) is held to its plain version within 1e-5 (the
               count of differing elements printed) on 2 x 1000 boxes with
               boxes on the level mapper's borders among them, and on two
               levels of one stride; one call must run one device kernel
               and nothing else. K2 and the stem (K6) print the time of a
               call (wrapper included) beside that of a bare launch
               through the C interface (``bare_ms`` in the JSON line). K6's
               check instance (``stem_late_bf16``), which asks for each
               image window only at its own tile, is held to the plain
               version too: it gives the right results only if every block
               waits for each window on its barrier.
  4. main    - the flagship detector (ResNet-50-FPN, spiking RPN and box
               heads, bf16 GEMMs, f32 neuron states, random weights from a
               seed) on synthetic 2 x 768 x 1536 batches through
               detector_apply, which with bf16 takes the fused stem and the
               fused FPN; every kernel must have launched, no plain version
               may have run on the GPU, outputs must be finite and well
               formed; prints images/s, then one more batch under
               torch.profiler: device time by kernel and the busy share.
  5. train   - the same configuration with a frozen backbone through
               make_train_step (AdamW) on a seeded 2 x 768 x 1536 batch with
               seeded targets: one warm-up step, two timed ones. The four
               losses must be finite, the gradients of the RPN head and the
               box head finite and not all zero, every trainable leaf must
               have moved and no frozen one; per step the stem kernel
               launches once, the RPN head's forward (K1's training
               instance) and backward kernels five times each and the other
               six kernels never,
               and no plain version runs on the GPU. Prints steps/s,
               images/s, peak memory and one profiled step by kernel with
               its count of stream synchronisations. Then the same step
               with bf16 neuron states (--no-amp): the RPN head on K1's and
               K7's bf16-state instances, five launches each a step.

  6. eval    - detector_apply(training=False, collect_rates=False), the
               plain evaluation call, on the flagship and on
               MobileNetV3-Large-FPN (9 classes, T_rpn=8, T_det=12) at 2 x
               768 x 1536: with the pairing switch on the paired RPN kernel
               runs on every level and the per-image kernel never, with it
               off the other way round, and every output the same bits
               either way (K8 gives K1's bits); the MobileNet backbone
               launches neither the fused stem nor the fused FPN. Prints
               images/s of each.
  7. fused   - the fused box head's own entry point on 2000 RoI rows: one
               launch of its wrapper for all 12 steps, which runs the
               kernel's four passes on the device.
  8. float32 - detector_apply(training=False) with float32 on one
               flagship batch: the reference's scans and the gather
               RoIAlign, no kernel launched, outputs finite and well
               formed.
  9. dataset_eval - a COCO-format dataset of 8 seeded 1024 x 2048 images
               through the port's host side and the flagship evaluation:
               CocoDataset, DetectionLoader (batch 2, 768 x 1536, 4
               workers), to_device_batch, detector_apply (rates off),
               CocoEvaluator; launches per batch, the loader's batch equal
               bit for bit to one built without it, GT as detections giving
               AP 1.0, a checkpoint round trip giving the same detections,
               12 finite stats; prints images/s with loading (host clock)
               and one loader batch's host synchronisations.
 10. routes  - detector_apply evaluation with rates on the factory's other
               heads and states at the flagship width: an ANN RPN head with
               the spiking box head, the reverse, both ANN, and both spiking
               with bf16 neuron states, each with exact launch counts
               (ANN RPN: no K1; ANN box head: no K3 or K4; bf16 states:
               K1's bf16-state instance x5, K3, no K4), finite, well-formed
               outputs and images/s; bf16 states also rates off in turns
               with the pairing switch on (K8's bf16-state instance x5) and
               off, the same bits either way.
 11. cli     - the port's training CLI and T-sweep CLI on a seeded
               COCO-format set in a temporary directory (flagship
               configuration at its bucket): one epoch, a second from
               --resume, --test-only --load-model of its checkpoint (12 stats, exact launches per
               evaluation batch), the NOD dump, spike rates, the sweep
               over t_det 8, 12, 40 (the scan above 32 steps), the noise
               sweeps (gaussian 0 and 0.05, rain 0 and 50), new-object
               discovery on the dump, the energy recompute from the rates
               and one --no-amp epoch (K1's and K7's bf16-state instances).
 12. dist    - data parallelism on torch.distributed at the flagship width
               (frozen backbone, bf16, seeded batch of two at 768 x 1536):
               (i) two gloo ranks on this one card (NCCL refuses two ranks
               on one card; gloo stages CUDA tensors through the host), one
               image each by the sampler-draw rule: their losses and
               updated leaves bit-equal; each rank's RPN input features
               equal to one process's on its image alone; their losses
               within 1e-2 relative (DIST_LOSS_RTOL) of one process's step
               on both images with those features as the frozen body's
               output (a batch of two takes other cuDNN kernels in the
               body, which move most features by ulps and flip encoder
               spikes: that step's losses, the differing features and the
               flipped spikes are printed beside), per rank and step K6 x1, K1's
               training instance x5, K7 x5 and no plain version; each
               rank's steps/s, device time and all-reduce time from its
               profile (two ranks share the card: not a one-card figure);
               (ii) a one-rank NCCL group running the same step: the same
               bits as without a group, four NCCL all-reduce ops a step in
               the profile (two loss counts, the gradients, the losses) and
               NCCL's device kernels counted; (iii) cli/train.py
               --test-only on two gloo ranks of -b 1 over 3 seeded images
               (one padded by the loader's wrap-around), exactly the 12
               stats of one process, rates-off launches per rank.
 13. bench_weights - tools/make_bench_weights.py of the port at the
               flagship configuration: 700 AdamW steps on fresh batches of
               the synthetic shape set (about a minute), launches per step
               K6 x1, K1's training instance x5, K7 x5, the held-out
               evaluation's
               rates-off launches, 12 finite stats, the .pth read back by
               --eval-only --load giving the same stats; prints the
               held-out mAP, the foreground detections and in how many
               evaluation batches the full NMS branch ran.
 14. joint   - training with trainable backbone stages at the flagship
               width (bf16, f32 states, the seeded batch of phase 5):
               torchvision's default N = 3 stages, then train_backbone (N
               = 5), each a warm-up and two timed steps through
               make_train_step (AdamW). The RPN head runs as the scan under
               autograd (the feature gradient through the encoder's
               surrogate), the FPN unfused, RoIAlign the gather version;
               per step K6 x1 for N = 3 (the frozen stem) and no launch at
               all for N = 5, no plain version on the card; finite losses,
               every trainable leaf moved (each trained stage, the FPN, the
               heads; for N = 5 the stem), every frozen leaf bit-equal
               without a gradient. Prints steps/s, peak memory and one
               profiled step. Then one epoch of cli/train.py with
               --trainable-backbone-layers 3 on the seeded set of phase 11
               (K6 x1 a step and a validation batch; layer2-4, the FPN and
               the RPN head moved in its checkpoint, the stem and layer1
               not).
 15. chain   - the bench recipe (scripts/chain_recipe.sh) through the
               port's tools: its three phases through make_bench_weights
               with the script's arguments, 30 steps and 8 held-out images
               each (phase 1 joint: no launch a step; phases 2 and 3
               frozen: K6 x1, K1's training instance x5, K7 x5), each
               loading the one before; ablate_bf16 over 8 held-out images
               with its five variants (launches exact per variant; the
               kernels-off names refused), then parity_vs_reference on the
               seeded set of phase 11 with a .pth in the reference's layout
               (tools/torch_mirror.py's detector, gains on its weights so
               that every layer spikes): its four CLI runs' launches exact,
               every line of both tools' output checked. Prints each
               phase's held-out mAP and foreground detections.
 16. bench   - every cell of the port's benchmark (bench_torch/configs):
               its checks as python -m bench_torch makes them (the launches
               of one batch or step against the cell's table, no plain
               version on the card, well-formed finite outputs, against the
               float32 route the spike rates and the heads' readouts or the
               first step's losses and gradients, the update, the same bits
               on a second run) and one short timed window of 3 batches or
               steps, untraced; prints each cell's JSON line.

 17. graphs  - evaluation's box postprocess (proposal filtering, the
               detection NMS, the outputs around them) as CUDA graph
               replays: the flagship with rates on and off, MobileNet and
               the float32 route, 4 seeded batches in turn, twice, each
               turn eager (the graphed functions' originals patched in)
               and graphed; every output the same bits and the same kernel
               launches either way; prints the wall ms a batch of both, the
               host's and the device's ms in each segment of a batch (the
               backbone, the RPN, the RoI heads with the branch test's
               sync, the outputs; CUDA events at the boundaries) and, from
               one profiled batch each, the host's kernel launches, CUDA
               graph launches and synchronisations.

The line before last is a JSON object listing the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import json
import os
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


# Published peaks of one H100 SXM: device memory, dense bf16 tensor cores,
# f32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
LOSS_NAMES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(n_bytes, tensor_ops, f32_ops=0.0):
    """The least time for the work, in ms, and which resource sets it: each
    input byte read once and each output byte written once over the memory
    rate, against the operations over the peak rate for their type."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = tensor_ops / PEAK_BF16_FLOPS + f32_ops / PEAK_F32_FLOPS
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _record(results, name, replaces, err, ms, pms, bound, library_ms=None,
            product_only_ms=None, bare_ms=None, **extra):
    """One kernel's entry of the JSON line. ``library_ms`` is a PyTorch call
    that computes the kernel's whole function; ``product_only_ms``, where no
    call does, cuBLAS's time for the kernel's dense product alone on
    materialised spikes (an extra key); ``bare_ms``, the time of a bare
    launch through the C interface beside ``ms``, the call's (an extra
    key); ``extra``, further keys as they are (times in turns with another
    route, flip counts)."""
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    if product_only_ms is not None:
        extra["product_only_ms"] = product_only_ms
    if bare_ms is not None:
        extra["bare_ms"] = bare_ms
    results.append(dict(
        name=name, route="cuda",
        source=f"snn_automotive_object_detection_tpu_torch/csrc/{cb.SOURCE[name]}.cu",
        replaces=f"snn_automotive_object_detection_tpu/{replaces}",
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=library_ms, **bound, **extra))
    lib = "" if library_ms is None else f", {library_ms:.3f} ms unfused cuDNN chain in bf16"
    if product_only_ms is not None:
        lib += f", {product_only_ms:.3f} ms cuBLAS product only"
    print(f"{name}: {ms:.3f} ms kernel, {pms:.3f} ms plain{lib}; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
          f"({ms / bound['bound_ms']:.1f}x)")


def _hold_rpn_eval(got, want, wo, what, label="K1 rpn_head"):
    """An RPN head kernel's (readout, encoder counts, LIF counts, spike
    sums) on levels against the plain version's; K8 has no counts (None).
    The kernels sum the conv in another order than the plain version, so a
    current may round to the neighbouring bf16 value and flip a LIF spike:
    such neurons are counted through the spike sums (at most 0.1% of the
    neurons that spiked), and on a level with one the readout, linear in
    the spike sums, is held against the plain product of the kernel's own
    sums. Returns (max |out diff|, encoder spikes, flipped neurons, neurons
    that spiked)."""
    import torch

    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    err = worst = 0.0
    enc = flips = spiked = 0
    equal_enc = True
    for a, b in zip(got, want):
        f = int((a[3] != b[3]).sum())
        ref = b[0] if f == 0 else torch.matmul(a[3], wo.float()).to(torch.bfloat16).float()
        err = max(err, (a[0] - ref).abs().max().item())
        worst = max(worst, kc.excess(a[0], ref))
        if a[1] is not None:
            equal_enc = equal_enc and torch.equal(a[1], b[1])
            enc += int(b[1].sum())
        flips += f
        spiked += int((b[3] != 0).sum())
    top = max(b[0].abs().max().item() for b in want)
    ok_bf16 = all(kc.bf16_valued(a[0]) for a in got)
    print(f"{label} {what}: max|out diff| {err:.3g} at max|out| {top:.4g} (where a "
          f"spike flipped, against the plain readout of the kernel's own spike sums), "
          f"{worst:.3g} of the bound 2^-7|want| + {kc.ATOL}; bf16-valued {ok_bf16}; encoder "
          f"counts equal {equal_enc}; neurons with a flipped LIF spike {flips} of {spiked} "
          f"that spiked ({flips / max(spiked, 1):.2e})")
    if not equal_enc or worst > 1 or not ok_bf16 or spiked == 0 or flips > 1e-3 * spiked:
        _fail(f"{label} disagrees with its plain version {what}")
    return err, enc, flips, spiked


def check_rpn_head(dev, g, results):
    """K1, the RPN head, on the five flagship levels (T = 8, 15 readout
    channels) against its plain version; timed twice and level by level."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1

    bf = torch.bfloat16
    levels = [(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)]
    # Features spread over the encoder's range so every period 1..T and
    # "never" occurs.
    feats = [torch.rand((2, h, w, 256), generator=g, device=dev).mul(2.0).to(bf)
             for h, w in levels]
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.01
    w9t, wo = k1._taps_t(w_shared), w_out.to(bf).contiguous()

    def k1_kernel(spike_sum=False):
        return [k1._launch(f, w9t, wo, 8, spike_sum) for f in feats]

    def k1_plain(spike_sum=False):
        return [k1.rpn_level_plain(f, w_shared, w_out, 8, spike_sum) for f in feats]

    got, want = k1_kernel(True), k1_plain(True)
    err, enc, flips, spiked = _hold_rpn_eval(got, want, wo, "on the five flagship levels")
    neurons = sum(2 * h * w * 256 * 8 for h, w in levels)
    lif = sum(int(b[2].sum()) for b in want)
    print(f"K1 rpn_head: rates encoder {enc / neurons:.4f} LIF {lif / neurons:.4f}")
    ms = [_median_ms(k1_kernel, 10), _median_ms(k1_kernel, 10)]
    for (h, w), f in zip(levels, feats):
        l1 = _median_ms(lambda: k1._launch(f, w9t, wo, 8), 10)
        print(f"K1 rpn_head [2, {h}, {w}, 256]: {l1:.3f} ms")
    pms = _median_ms(k1_plain, 5)
    dense = sum(2.0 * 2 * h * w * 2304 * 256 * 8 for h, w in levels)
    print(f"K1 rpn_head: five levels {ms[0]:.3f} and {ms[1]:.3f} ms; dense 3x3 products "
          f"{dense / 1e12:.3f} TFLOP, {dense / min(ms) / 1e9:.1f} TFLOP/s dense")
    # A sparse conv does 2 x 256 operations for each of the (at most) 9
    # outputs an encoder spike reaches; the readout is dense, the LIF update
    # about 10 f32 operations per neuron and step.
    _record(results, "rpn_head", "snn/pallas_rpn.py:449", err, min(ms), pms,
            _bound(_nbytes(*feats, w9t, wo, *[a[0] for a in got], *[a[1] for a in got],
                           *[a[2] for a in got]),
                   2.0 * enc * 9 * 256 + sum(2.0 * 2 * h * w * 256 * 15 for h, w in levels),
                   10.0 * neurons))


def _loop_ms(fn, reps=20, iters=5):
    """Median over ``iters`` of the CUDA-event time of ``reps`` calls in a
    row, per call: the device time of a bare launch, with the host's work
    per call hidden behind the launches queued before it."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _device_kernels(run):
    """The names of the device kernels one ``run()`` launches. The tracer
    has once returned no device event at all for a short run that launched
    kernels; such an empty trace is taken again, up to twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            return names
        print(f"profile: no device event in trace {attempt + 1} of 3")
    return names


def check_kernels(dev, results):
    import torch

    g = torch.Generator(device=dev).manual_seed(1234)
    for check in KERNEL_CHECKS:
        check(dev, g, results)


def check_roi_align(dev, g, results):
    """K2: RoIAlign of 2 x 1000 boxes over P2..P5, with boxes on the level
    mapper's borders among them; and two levels of one stride, as the
    MobileNet route passes them."""
    import torch

    from snn_automotive_object_detection_tpu_torch.ops import cuda_roi_align as k2
    from snn_automotive_object_detection_tpu_torch.ops.roi_align import (
        assign_fpn_levels, level_geometry, rows_read)
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    bf = torch.bfloat16
    size = (768, 1536)
    levels = [(192, 384), (96, 192), (48, 96), (24, 48)]
    pooled_feats = [torch.randn((2, h, w, 256), generator=g, device=dev).to(bf)
                    for h, w in levels]
    ctr = torch.rand((2, 1000, 2), generator=g, device=dev) * torch.tensor(
        [1536.0, 768.0], device=dev)
    wh = torch.rand((2, 1000, 2), generator=g, device=dev) * 400.0 + 4.0
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    border = kc.level_border_boxes(lambda b: assign_fpn_levels(b, 4), dev)
    boxes[:, :border.shape[0]] = border
    boxes = boxes.contiguous()

    def hold(feats, bxs, what):
        got = k2._launch(feats, bxs, size)
        want = k2.plain(feats, bxs, size)
        err = (got - want).abs().max().item()
        diff = int((got != want).sum())
        lv, _ = level_geometry(feats, bxs, size)
        per_level = torch.bincount(lv.flatten().long(), minlength=len(feats)).tolist()
        print(f"K2 roi_align {what}: max|diff| {err:.3g} (tol 1e-5) at max|out| "
              f"{want.abs().max().item():.4g}, {diff} of {want.numel()} elements differ; "
              f"boxes per level {per_level}")
        if err > 1e-5 or not torch.isfinite(got).all():
            _fail(f"K2 disagrees with its plain version ({what})")
        return got, err

    got, err = hold(pooled_feats, boxes, "P2..P5")
    # The same-stride pair draws from a generator of its own, so that the
    # phases after this one keep their inputs.
    g2 = torch.Generator(device=dev).manual_seed(5)
    top = [torch.randn((2, 24, 48, 256), generator=g2, device=dev).to(bf) for _ in range(2)]
    hold(top, boxes, "two levels of stride 32")
    kernels = _device_kernels(lambda: k2.roi_align(pooled_feats, boxes, size))
    print(f"K2 roi_align: one call runs {kernels}")
    if len(kernels) != 1:
        _fail("a K2 call runs other device work than its one kernel")

    geo = k2.geometry(tuple(levels), size)
    out = torch.empty_like(got)
    ptrs = [f.data_ptr() for f in pooled_feats] + [pooled_feats[0].data_ptr()]
    fn = cb.function(k2.NAME, "roi_align_bf16", k2._ARGTYPES)
    args = (*ptrs, ctypes.addressof(geo), boxes.data_ptr(), 2000, 1000, 256, out.data_ptr(),
            cb.stream_ptr(dev))
    bare = _loop_ms(lambda: cb.check(fn(*args), k2.NAME))
    ms = _median_ms(lambda: k2._launch(pooled_feats, boxes, size), 10)
    pms = _median_ms(lambda: k2.plain(pooled_feats, boxes, size), 5)
    print(f"K2 roi_align: {ms:.4f} ms a call, {bare:.4f} ms a bare launch")
    # The compulsory reads are the feature rows that this run's samples
    # weight nonzero, each once, not the whole pooled maps. Each output is
    # the mean of 2 x 2 samples of 4 corners: about 8 x 4 f32 operations.
    rows = rows_read(pooled_feats, boxes, size)
    total = sum(h * w for h, w in levels) * 2
    print(f"K2 roi_align: the samples read {rows} of the {total} feature rows "
          f"({rows / total:.3f}), {rows * 256 * 2 / 1e6:.1f} MB")
    _record(results, "roi_align", "ops/pallas_roi_align.py:309", err, ms, pms,
            _bound(rows * 256 * 2 + _nbytes(boxes, got), 0.0, 32.0 * got.numel()),
            bare_ms=bare)


# Steps past one 16-bit code plane, held and timed beside T = 12 in the
# K3, K4 and K9 phases: the kernels run such trains as two GEMM passes.
LONG_T = (20, 32)
# K9 takes any T: two code planes at 32, three at 40 and 48.
K9_LONG_T = (32, 40, 48)


def _encoder_fc6_at(x, w6, t):
    """K3 at ``t`` steps on (x, w6) held to its plain version as at T = 12;
    returns the numbers of the JSON line's ``long_t`` entry."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6 as k3

    got, cnt_k = k3._launch(x, w6, t)
    want, cnt_p = k3.encoder_fc6_plain(x, w6, t)
    err = (got - want).abs().max().item()
    same = bool(torch.equal(cnt_k, cnt_p))
    rate = cnt_p.sum().item() / (x.shape[0] * x.shape[1] * t)
    ms = _median_ms(lambda: k3._launch(x, w6, t), 10)
    pms = _median_ms(lambda: k3.encoder_fc6_plain(x, w6, t), 3)
    bound = _bound(_nbytes(x, w6, got, cnt_k), 2.0 * cnt_p.sum().item() * w6.shape[1])
    print(f"K3 encoder_fc6 at T = {t}: max|cur6 diff| {err:.3g} (tol 1e-3) at max|cur6| "
          f"{want.abs().max().item():.4g}; encoder counts equal {same}; encoder rate "
          f"{rate:.4f}; {ms:.3f} ms kernel, {pms:.3f} ms plain; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({ms / bound['bound_ms']:.1f}x)")
    if err > 1e-3 or not same or rate == 0:
        _fail(f"K3 disagrees with its plain version at T = {t}")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, **bound)


def check_encoder_fc6(dev, g, results):
    """K3: encoder + fc6 on R = 2000 rows of 7*7*256, T = 12, against its
    plain version; timed beside cuBLAS's product alone on materialised
    spikes. Then the same inputs at T = 20 and 32 (``LONG_T``)."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6 as k3

    bf = torch.bfloat16
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
    # No single call computes the kernel's function; cuBLAS's product of
    # the materialised [T R, 12544] encoder spikes by w6 is its dense part.
    codes, _ = k3.encoder_codes_plain(x, 12)
    z = torch.cat([((codes >> t) & 1).to(bf) for t in range(12)])
    del codes
    product_ms = _median_ms(lambda: torch.matmul(z, w6), 10)
    del z
    dense = 2.0 * 12 * 2000 * 12544 * 1024
    print(f"K3 encoder_fc6: {dense / ms / 1e9:.1f} dense TFLOP/s; cuBLAS product only "
          f"(materialised spikes x w6, bf16) {product_ms:.3f} ms")
    # A sparse product adds one 1024-wide w6 row for each encoder spike.
    bound = _bound(_nbytes(x, w6, got, cnt_k), 2.0 * cnt_p.sum().item() * 1024)
    del got, want
    long_t = {t: _encoder_fc6_at(x, w6, t) for t in LONG_T}
    _record(results, "encoder_fc6", "snn/pallas_fc6.py:227", err, ms, pms, bound,
            product_only_ms=product_ms, long_t=long_t)


def _hold_box_tail(cur6, w7, wc, wb, w7b, wro):
    """K4 on (cur6, w7b, wro) held to its plain version: logits within
    ``kc.excess``'s bound, fc6 counts equal, fc7 counts within 1e-3 of the
    spikes. Returns (err, kernel outputs, plain outputs)."""
    from snn_automotive_object_detection_tpu_torch.snn import cuda_tail as k4
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    t, r, rep = cur6.shape
    got = k4._launch(cur6, w7b, wro, wc.shape[1])
    want = k4.box_tail_plain(cur6, w7, wc, wb)
    err = max((got[0] - want[0]).abs().max().item(),
              (got[1] - want[1]).abs().max().item())
    worst = max(kc.excess(got[0], want[0]), kc.excess(got[1], want[1]))
    top = max(want[0].abs().max().item(), want[1].abs().max().item())
    d6 = (got[2] - want[2]).abs().sum().item()
    d7 = (got[3] - want[3]).abs().sum().item()
    r6 = want[2].sum().item() / (r * rep * t)
    r7 = want[3].sum().item() / (r * rep * t)
    print(f"K4 box_tail at T = {t}: max|logit diff| {err:.3g} at max|logit| {top:.4g}, "
          f"{worst:.3g} of the bound 2^-7|want| + {kc.ATOL}; spike-count diffs "
          f"per row fc6 {d6} fc7 {d7}; rates fc6 {r6:.4f} fc7 {r7:.4f}")
    if worst > 1 or d6 != 0 or d7 > 1e-3 * want[3].sum().item() or r7 == 0:
        _fail(f"K4 disagrees with its plain version at T = {t}")
    return err, got, want


def _box_tail_bound(cur6, w7b, wro, got, want):
    """fc7 adds one 1024-wide row for each fc6 spike and the readout one
    45-wide row for each fc7 spike; two LIF layers and the LI readout take
    about 10 f32 operations per neuron and step."""
    t, r, rep = cur6.shape
    n_out = wro.shape[1]
    return _bound(_nbytes(cur6, w7b, wro, *got),
                  2.0 * want[2].sum().item() * rep + 2.0 * want[3].sum().item() * n_out,
                  10.0 * t * r * (2 * rep + n_out))


def check_box_tail(dev, g, results):
    """K4: the box-head tail on bf16 fc6 currents around the LIF threshold,
    R = 2000, T = 12, 9 classes, against its plain version; timed beside
    cuBLAS's fc7 product alone on materialised fc6 spikes. Then T = 20 and
    32 (``LONG_T``) on currents of their own generator, so that the phases
    after this one keep their inputs."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_tail as k4

    bf = torch.bfloat16
    cur6 = (torch.randn((12, 2000, 1024), generator=g, device=dev) * 0.15).to(bf)
    w7 = ((torch.rand((1024, 1024), generator=g, device=dev) * 2 - 1) / 32.0)
    wc = ((torch.rand((1024, 9), generator=g, device=dev) * 2 - 1) / 32.0)
    wb = ((torch.rand((1024, 36), generator=g, device=dev) * 2 - 1) / 32.0)
    w7b = w7.to(bf).contiguous()
    wro = torch.cat([wc, wb], 1).to(bf).contiguous()
    err, got, want = _hold_box_tail(cur6, w7, wc, wb, w7b, wro)
    ms = _median_ms(lambda: k4._launch(cur6, w7b, wro, 9), 10)
    pms = _median_ms(lambda: k4.box_tail_plain(cur6, w7, wc, wb), 5)
    codes6, _ = k4.lif6_codes_plain(cur6)
    s6 = torch.cat([((codes6 >> t) & 1).to(bf) for t in range(12)])
    product_ms = _median_ms(lambda: torch.matmul(s6, w7b), 10)
    print(f"K4 box_tail: cuBLAS product only (materialised fc6 spikes x w7, bf16) "
          f"{product_ms:.3f} ms")
    bound = _box_tail_bound(cur6, w7b, wro, got, want)
    long_t = {}
    for t in LONG_T:
        gt = torch.Generator(device=dev).manual_seed(t)
        cur_t = (torch.randn((t, 2000, 1024), generator=gt, device=dev) * 0.15).to(bf)
        err_t, got_t, want_t = _hold_box_tail(cur_t, w7, wc, wb, w7b, wro)
        ms_t = _median_ms(lambda: k4._launch(cur_t, w7b, wro, 9), 10)
        pms_t = _median_ms(lambda: k4.box_tail_plain(cur_t, w7, wc, wb), 3)
        bound_t = _box_tail_bound(cur_t, w7b, wro, got_t, want_t)
        print(f"K4 box_tail at T = {t}: {ms_t:.3f} ms kernel, {pms_t:.3f} ms plain; bound "
              f"{bound_t['bound_ms']:.4f} ms by {bound_t['bound_by']} "
              f"({ms_t / bound_t['bound_ms']:.1f}x)")
        long_t[t] = dict(max_abs_err=err_t, ms=ms_t, plain_ms=pms_t, **bound_t)
    _record(results, "box_tail", "snn/pallas_tail.py:241", err, ms, pms, bound,
            product_only_ms=product_ms, long_t=long_t)


def check_fpn(dev, g, results):
    """K5: the four FPN levels at flagship shapes, each level on the plain
    version's coarser merged map so that both sides get the same inputs."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models import resnet_fpn
    from snn_automotive_object_detection_tpu_torch.ops import cuda_fpn as k5
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    bf = torch.bfloat16
    shapes = [(192, 384, 256), (96, 192, 512), (48, 96, 1024), (24, 48, 2048)]
    # Inputs and weights scaled so that the merged maps and P are O(1).
    cs = [torch.randn((2, h, w, c), generator=g, device=dev).to(bf) for h, w, c in shapes]
    fpn = {"inner": [{"w": torch.randn((1, 1, c, 256), generator=g, device=dev) / c ** 0.5,
                      "b": torch.randn(256, generator=g, device=dev) * 0.1}
                     for _, _, c in shapes],
           "layer": [{"w": torch.randn((3, 3, 256, 256), generator=g, device=dev) / 48.0,
                      "b": torch.randn(256, generator=g, device=dev) * 0.1}
                     for _ in shapes]}
    ops = [dict(zip(("wlat", "blat", "w9", "bout"),
                    k5.kernel_weights(fpn["inner"][i]["w"], fpn["inner"][i]["b"],
                                      fpn["layer"][i]["w"], fpn["layer"][i]["b"])))
           for i in range(len(shapes))]

    def launch(i, merged_next, store_merged):
        o = ops[i]
        return k5._launch(cs[i], merged_next, o["wlat"], o["blat"], o["w9"], o["bout"],
                          store_merged)

    def library_level(i, merged_next):
        """The level as the unfused cuDNN chain in bf16: lateral 1x1 + bias,
        upsample and add, 3x3 + bias."""
        inner, layer = fpn["inner"][i], fpn["layer"][i]
        merged = resnet_fpn.conv_nhwc(cs[i], inner["w"]) + inner["b"].to(bf)
        if merged_next is not None:
            merged = merged + resnet_fpn._upsample_nearest_2x(merged_next, merged.shape[1:3])
        return resnet_fpn.conv_nhwc(merged, layer["w"]) + layer["b"].to(bf), merged

    err = worst = top = 0.0
    m_next = None
    for i in (3, 2, 1, 0):
        h, w, _ = shapes[i]
        inner, layer = fpn["inner"][i], fpn["layer"][i]
        got_p, got_m = launch(i, m_next, True)
        want_m = k5.lateral_plain(cs[i], m_next, inner["w"], inner["b"])
        addends = [ops[i]["blat"]]
        if m_next is not None:
            up = m_next.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :h, :w]
            addends += [up, up]
        ex_m = kc.chain_excess(got_m, want_m, 2 if m_next is None else 3, addends)
        # P from the kernel's own merged map: the 3x3 alone, same inputs.
        want_p = k5.outer_plain(got_m, layer["w"], layer["b"])
        ex_p = kc.chain_excess(got_p, want_p, 2, (ops[i]["bout"],))
        dm, dp = kc.differing(got_m, want_m), kc.differing(got_p, want_p)
        # ... and from the plain merged map: the flips of the merged map reach P.
        full_p = k5.outer_plain(want_m, layer["w"], layer["b"])
        out1 = int(((got_p.float() - full_p.float()).abs()
                    > kc.BF16_REL * full_p.float().abs() + kc.ATOL).sum())
        e = max((got_m.float() - want_m.float()).abs().max().item(),
                (got_p.float() - want_p.float()).abs().max().item())
        lvl_ms = _median_ms(lambda: launch(i, m_next, i > 0), 10)
        lib_ms = _median_ms(lambda: library_level(i, m_next), 10)
        print(f"K5 fpn_level C{i + 2} [2, {h}, {w}, {shapes[i][2]}], {k5.tile_rows(cs[i])} x 16 "
              f"pixels per block: {lvl_ms:.3f} ms, "
              f"unfused cuDNN chain {lib_ms:.3f} ms; merged "
              f"{ex_m:.3g} of its bound, {dm} of {want_m.numel()} differ, max |merged| "
              f"{want_m.float().abs().max().item():.4g}; P {ex_p:.3g} of its bound, "
              f"{dp} differ, max |P| {want_p.float().abs().max().item():.4g}; max |diff| "
              f"{e:.3g}; against the whole plain level {out1} P elements outside one ulp")
        if ex_m > 1 or ex_p > 1 or max(dm, dp) > kc.MAX_DIFFERING * want_m.numel() \
                or not torch.isfinite(got_p.float()).all():
            _fail(f"K5 disagrees with its plain version on C{i + 2}")
        if i == 0:   # the finest level stores no merged map: same P
            only_p, none = launch(0, m_next, False)
            if none is not None or not torch.equal(only_p, got_p):
                _fail("K5 without the merged output gives another P")
        err, worst = max(err, e), max(worst, ex_m, ex_p)
        top = max(top, want_p.float().abs().max().item())
        m_next = want_m
    print(f"K5 fpn_level: max |diff| {err:.3g} at max |P| {top:.4g}, {worst:.3g} of the "
          f"bound 2^-7 (roundings |want| + |addends|) + {kc.ATOL}")

    def chain(level):
        merged = None
        for i in (3, 2, 1, 0):
            _, merged = level(i, merged, i > 0)

    def plain_level(i, merged, store_merged):
        return k5.fpn_level_plain(cs[i], merged, fpn["inner"][i]["w"], fpn["inner"][i]["b"],
                                  fpn["layer"][i]["w"], fpn["layer"][i]["b"], store_merged)

    ms = _median_ms(lambda: chain(launch), 10)
    pms = _median_ms(lambda: chain(plain_level), 5)
    lms = _median_ms(lambda: resnet_fpn.fpn_unfused(fpn, cs), 10)
    px = [2 * h * w for h, w, _ in shapes]
    n_bytes = _nbytes(*cs, *[t for o in ops for t in o.values()]) \
        + sum(p * 256 * 2 for p in px) + 2 * sum(p * 256 * 2 for p in px[1:])
    flops = sum(2.0 * p * (c * 256 + 2304 * 256) for p, (_, _, c) in zip(px, shapes))
    _record(results, "fpn_level", "ops/pallas_fpn.py:249", err, ms, pms,
            _bound(n_bytes, flops), lms)


def check_stem(dev, g, results):
    """K6: the fused stem on a flagship image pair."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models import resnet_fpn, transform
    from snn_automotive_object_detection_tpu_torch.ops import cuda_stem as k6
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    mean, std = transform.IMAGENET_MEAN, transform.IMAGENET_STD
    images = torch.rand((2, 768, 1536, 3), generator=g, device=dev)
    # He-normal weights times a frozen-BN scale, a BN bias around zero.
    stem = {"w": torch.randn((7, 7, 3, 64), generator=g, device=dev) * (2.0 / (49 * 64)) ** 0.5,
            "bn": {"scale": torch.rand(64, generator=g, device=dev) + 0.5,
                   "bias": torch.randn(64, generator=g, device=dev) * 0.2}}
    wf, bias = k6.fold_stem_weights(stem["w"], stem["bn"]["scale"], stem["bn"]["bias"],
                                    mean, std)
    wk, bias = k6.kernel_weights(wf), bias.contiguous()
    got = k6._launch(images, wk, bias, mean)
    want = k6._folded_plain(images, wf, bias, mean)
    err = (got.float() - want.float()).abs().max().item()
    worst = kc.chain_excess(got, want, 2, (bias,))
    diff = kc.differing(got, want)
    out1 = int(((got.float() - want.float()).abs()
                > kc.BF16_REL * want.float().abs() + kc.ATOL).sum())
    print(f"K6 stem: max |diff| {err:.3g} at max |out| {want.float().abs().max().item():.4g}, "
          f"{worst:.3g} of the bound 2^-7 (2 |want| + |bias|) + {kc.ATOL}; {diff} of "
          f"{want.numel()} elements differ, {out1} by more than one ulp of the value; "
          f"{(want == 0).float().mean().item():.3f} of the outputs are zero")
    if worst > 1 or diff > kc.MAX_DIFFERING * want.numel() or got.dtype != torch.bfloat16 \
            or tuple(got.shape) != (2, 192, 384, 64) or not (want > 0).any():
        _fail("K6 disagrees with its plain version")
    # The check instance loads each window only at its own tile: it gives
    # these results only if every block waits for each window on its
    # barrier (in the production instance the windows land early anyway).
    late = k6._launch(images, wk, bias, mean, late=True)
    late_worst, late_diff = kc.chain_excess(late, want, 2, (bias,)), kc.differing(late, want)
    late_ms = _median_ms(lambda: k6._launch(images, wk, bias, mean, late=True), 5)
    print(f"K6 stem, check instance (each window loaded at its own tile, {late_ms:.4f} ms): "
          f"{late_worst:.3g} of the bound, {late_diff} elements differ; "
          f"{int((late != got).sum())} differ from the production instance's")
    if late_worst > 1 or late_diff > kc.MAX_DIFFERING * want.numel():
        _fail("K6's check instance disagrees with its plain version")

    def library():
        x = transform.normalize_images(images, mean, std).to(torch.bfloat16)
        return resnet_fpn.stem_apply_unfused(stem, x)

    out = torch.empty_like(got)
    fn = cb.function(k6.NAME, "stem_bf16", k6._ARGTYPES)
    args = (images.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(), *mean,
            2, 768, 1536, cb.stream_ptr(dev))
    bare = _loop_ms(lambda: cb.check(fn(*args), k6.NAME))
    ms = _median_ms(lambda: k6._launch(images, wk, bias, mean), 10)
    pms = _median_ms(lambda: k6._folded_plain(images, wf, bias, mean), 5)
    lms = _median_ms(library, 10)
    print(f"K6 stem: {ms:.4f} ms a call, {bare:.4f} ms a bare launch")
    _record(results, "stem", "ops/pallas_stem.py:347", err, ms, pms,
            _bound(_nbytes(images, wk, bias, got), 2.0 * 147 * 64 * 2 * 384 * 768), lms,
            bare_ms=bare)


def _hold_rpn_bwd(a, a2, own, b, fw, cot, cur_same):
    """One level of K7 against its plain version: ``a`` and ``a2`` are two
    runs of the kernel (the first with the sweep's spike sums), ``own`` its
    plain version (dw_shared, dw_out) on K1's saved tensors, ``b`` the
    replaying plain version's (dw_shared, dw_out, spike sum), ``fw`` K1's
    spike sums, ``cot`` the cotangent, ``cur_same`` whether K1's currents are
    the plain conv's bits. K7 is held to ``own`` within GRAD_REL of the
    largest element. Against the replay, whose conv sums in another order
    than K1's (a current one bf16 ulp apart moves a stored membrane and the
    surrogate's slope), the distance is printed, and held to the same bound
    where the currents are the same bits. Returns (max |diff| to ``own``,
    share of the bound) and fails outside it."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    shape = f"[{', '.join(str(d) for d in cot.shape[:3])}, 256] x {cot.shape[3]}"
    own9, want9 = own[0].reshape(9, 256, 256), b[0].reshape(9, 256, 256)
    swept = int((a[2] != fw).sum())            # the sweep's LIF against K1's
    flips = int((fw != b[2]).sum())            # K1 against the plain version
    ex9, exo = kc.grad_excess(a[0], own9), kc.grad_excess(a[1], own[1])
    e9, eo = (a[0] - own9).abs().max().item(), (a[1] - own[1]).abs().max().item()
    # dwout is linear in the spike sums: where K1 and the plain version
    # differ in a spike it is held against the plain product of K1's own.
    want_out = b[1] if flips == 0 else k1.dwout_plain(fw, cot)
    rx9, rxo = kc.grad_excess(a[0], want9), kc.grad_excess(a[1], want_out)
    same = bool(torch.equal(a[0], a2[0]) and torch.equal(a[1], a2[1]))
    print(f"K7 rpn_head_bwd {shape}: against its plain version on K1's saved tensors max|dw9 "
          f"diff| {e9:.3g} at max|dw9| {own9.abs().max().item():.4g} ({ex9:.3g} of the bound "
          f"{kc.GRAD_REL} of the largest element), max|dwout diff| {eo:.3g} at max|dwout| "
          f"{own[1].abs().max().item():.4g} ({exo:.3g}); against the replaying plain version "
          f"{rx9:.3g} and {rxo:.3g} of the bound (K1's currents the plain conv's bits "
          f"{cur_same}); neurons whose swept spike sum differs from K1's {swept}, K1's from "
          f"the plain version's {flips}; same bits on a second run {same}")
    if not (ex9 <= 1 and exo <= 1) or (cur_same and not (rx9 <= 1 and rxo <= 1)) \
            or swept != 0 or not same or flips > 1e-3 * int((b[2] != 0).sum()) \
            or not want9.abs().max().item() > 0:
        _fail(f"K7 disagrees with its plain version on {shape}")
    return max(e9, eo), max(ex9, exo)


def _fresh(saved):
    """K1's saved tensors with a copy of the currents, which K7 overwrites."""
    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1

    return k1.Saved(saved.cur.clone(), saved.per, saved.ssum)


def _median_ms_fresh(prepare, fn, iters, warmup=2):
    """As _median_ms, for a function that consumes its input: ``fn(prepare())``,
    with only ``fn`` between the events."""
    import torch

    for _ in range(warmup):
        fn(prepare())
    times = []
    for _ in range(iters):
        x = prepare()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _k7_product_only_ms(dev, dcs, dw9s):
    """cuBLAS's time for K7's weight-gradient product alone: per level the
    9 taps' materialised bf16 encoder spikes [256, P T] (the period map
    shifted by the tap, zero outside the image) by dc [P T, 256], not
    counting the materialisation. On the smallest level the f32 product
    must give K7's dw9, which shows the spikes are the kernel's."""
    import torch
    import torch.nn.functional as F

    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    total = 0.0
    for i, (s, dw9) in enumerate(zip(dcs, dw9s)):
        n, h, w, t, c = s.cur.shape
        per = F.pad(s.per.int(), (0, 0, 1, 1, 1, 1))
        steps = torch.arange(1, t + 1, device=dev, dtype=torch.int32).view(1, 1, 1, t, 1)
        dc = s.cur.reshape(-1, c)
        zs = []
        for k in range(9):
            dy, dx = divmod(k, 3)
            p = per[:, dy:dy + h, dx:dx + w].unsqueeze(3)
            z = (steps % p.clamp(min=1) == 0) & (p > 0)
            zs.append(z.to(torch.bfloat16).reshape(-1, c).t())
            del z
        if i == len(dcs) - 1:
            ref = torch.stack([torch.matmul(zk.float(), dc.float()) for zk in zs])
            ex = kc.grad_excess(ref, dw9)
            print(f"K7 product only: f32 product of the materialised spikes on [{n}, {h}, "
                  f"{w}, 256] against K7's dw9: {ex:.3g} of the bound")
            if ex > 1:
                _fail("the materialised spikes of K7's product are not the kernel's")
        total += _median_ms(lambda: [torch.matmul(zk, dc) for zk in zs], 5)
        del zs
    return total


def check_rpn_bwd(dev, g, results):
    """K1's training instance and K7 on all five levels at flagship shapes,
    T = 8, features over the encoder's whole range. The training instance's
    readout, counts and spike sums equal the evaluation instance's bits,
    its periods the plain version's and its currents the plain version's
    within one bf16 ulp. K7 against its plain version on K1's saved tensors
    (and against the replaying plain version where K1's currents are its
    bits; printed everywhere), its sweep's spike sums equal to K1's, the
    same bits on a second run; the training forward, the sweep and the
    weight gradient timed apart, beside cuBLAS's product alone."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    bf = torch.bfloat16
    levels = [(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)]
    # Features over [0, 3): every period 1 .. T + 1 occurs, so every step's
    # dc plane reaches dw9 (period 1, a spike at step 0, needs x > 2.5).
    feats = [torch.rand((2, h, w, 256), generator=g, device=dev).mul(3.0).to(bf)
             for h, w in levels]
    cots = [torch.randn((2, h, w, 15), generator=g, device=dev) for h, w in levels]
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.01
    w9t, wo = k1._taps_t(w_shared), w_out.to(bf).contiguous()

    evals = [k1._launch(f, w9t, wo, 8, True) for f in feats]
    trains = [k1._launch(f, w9t, wo, 8, True, True) for f in feats]
    saved = [t[4] for t in trains]
    same = all(torch.equal(a[i], b[i]) for a, b in zip(trains, evals) for i in range(4))
    cur_ex = cur_diff = 0.0
    per_equal = True
    cur_same = []
    for f, sv in zip(feats, saved):
        p = k1.rpn_level_plain(f, w_shared, w_out, 8, save=True)[3]
        per_equal = per_equal and torch.equal(sv.per, p.per)
        cur_same.append(torch.equal(sv.cur, p.cur))
        cur_ex = max(cur_ex, kc.excess(sv.cur.float(), p.cur.float()))
        cur_diff = max(cur_diff, kc.differing(sv.cur, p.cur) / p.cur.numel())
        del p
    print(f"K1 rpn_head training instance: readout, counts and spike sums equal the "
          f"evaluation instance's bits {same}; periods equal the plain version's "
          f"{per_equal}; currents {cur_ex:.3g} of the bound 2^-7|want| + {kc.ATOL}, "
          f"{cur_diff:.2e} of them differ")
    if not same or not per_equal or cur_ex > 1 or cur_diff > kc.MAX_DIFFERING:
        _fail("K1's training instance disagrees with its evaluation instance or its plain "
              "version")

    dcs = [_fresh(sv) for sv in saved]
    got = [k1._launch_bwd(d, wo, c, 8, True) for d, c in zip(dcs, cots)]
    again = [k1._launch_bwd(_fresh(sv), wo, c, 8) for sv, c in zip(saved, cots)]
    # K7's plain version on K1's own saved tensors (the same dc planes), and
    # the replaying plain version of the whole level.
    own = [k1.rpn_level_bwd_from_saved_plain(sv, w_out, c, 8) for sv, c in zip(saved, cots)]
    want = [k1.rpn_level_bwd_plain(f, w_shared, w_out, c, 8, True)
            for f, c in zip(feats, cots)]
    err = worst = 0.0
    for a, a2, o, b, tr, c, cs in zip(got, again, own, want, trains, cots, cur_same):
        e, ex = _hold_rpn_bwd(a, a2, o, b, tr[3], c, cs)
        err, worst = max(err, e), max(worst, ex)
    print(f"K7 rpn_head_bwd: max |diff| {err:.3g}, {worst:.3g} of the bound")

    def forward(save):
        return [k1._launch(f, w9t, wo, 8, False, save) for f in feats]

    # In turns, so that both see the same clocks.
    t_eval = [_median_ms(lambda: forward(False), 10), 0.0]
    t_train = [_median_ms(lambda: forward(True), 10), _median_ms(lambda: forward(True), 10)]
    t_eval[1] = _median_ms(lambda: forward(False), 10)

    def k7(phases):
        return lambda xs: [k1._launch_bwd(x, wo, c, 8, phases=phases)
                           for x, c in zip(xs, cots)]

    def prepare():
        return [_fresh(sv) for sv in saved]

    ms = _median_ms_fresh(prepare, k7(7), 10)
    sweep_ms = _median_ms_fresh(prepare, k7(1), 10)
    wgrad_ms = _median_ms(lambda: k7(2)(dcs), 10)
    dwout_ms = _median_ms(lambda: k7(4)(dcs), 10)
    pms = _median_ms(lambda: [k1.rpn_level_bwd_from_saved_plain(sv, w_out, c, 8)
                              for sv, c in zip(saved, cots)], 3)
    product_ms = _k7_product_only_ms(dev, dcs, [a[0] for a in got])
    dense = sum(2.0 * 2 * h * w * 8 * 2304 * 256 for h, w in levels)
    print(f"K1 training forward, five levels: {t_train[0]:.3f} and {t_train[1]:.3f} ms, "
          f"evaluation instance {t_eval[0]:.3f} and {t_eval[1]:.3f} ms in turns")
    print(f"K7 rpn_head_bwd, five levels: {ms:.3f} ms; sweep {sweep_ms:.3f} ms, weight "
          f"gradient {wgrad_ms:.3f} ms ({dense / wgrad_ms / 1e9:.1f} dense TFLOP/s), dwout "
          f"{dwout_ms:.3f} ms; cuBLAS product only (materialised spikes x dc, bf16, 9 taps) "
          f"{product_ms:.3f} ms; plain version from the saved tensors {pms:.3f} ms")
    # The weight gradient does 2 x 256 operations for each of the (at most)
    # 9 taps an encoder spike reaches; gw and dwout are dense products with
    # the readout channels; the sweep's LIF rerun and reverse step take about
    # 25 f32 operations per neuron and step. Bytes: the currents read, dc
    # written, the periods, spike sums, cotangent and weights read once.
    enc = sum(int(t[1].sum()) for t in trains)
    px = [2 * h * w for h, w in levels]
    _record(results, "rpn_head_bwd", "snn/pallas_rpn.py:1012", err, ms, pms,
            _bound(2 * _nbytes(*[sv.cur for sv in saved])
                   + _nbytes(*[sv.per for sv in saved], *[sv.ssum for sv in saved], *cots, wo,
                             *[a[0] for a in got], *[a[1] for a in got]),
                   2.0 * enc * 9 * 256,
                   sum(2 * 2.0 * p * 256 * 15 for p in px) + 25.0 * 8 * 256 * sum(px)),
            product_only_ms=product_ms)


def check_wide_readout(dev, g, results):
    """K1 (both instances) and K7 at 75 readout channels (15 anchors per
    location, the MobileNet families' head) on one MobileNet-sized level."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1

    bf = torch.bfloat16
    feat = torch.rand((2, 24, 48, 256), generator=g, device=dev).mul(3.0).to(bf)
    cot = torch.randn((2, 24, 48, 75), generator=g, device=dev)
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, 75), generator=g, device=dev) * 0.01
    w9t, wo = k1._taps_t(w_shared), w_out.to(bf).contiguous()
    want = k1.rpn_level_plain(feat, w_shared, w_out, 8, True)
    ev = k1._launch(feat, w9t, wo, 8, True)
    _hold_rpn_eval([ev], [want], wo, "at 75 readout channels [2, 24, 48, 256]")
    tr = k1._launch(feat, w9t, wo, 8, True, True)
    if not all(torch.equal(tr[i], ev[i]) for i in range(4)):
        _fail("K1's training instance differs from its evaluation instance at 75 channels")
    a = k1._launch_bwd(_fresh(tr[4]), wo, cot, 8, True)
    a2 = k1._launch_bwd(_fresh(tr[4]), wo, cot, 8)
    own = k1.rpn_level_bwd_from_saved_plain(tr[4], w_out, cot, 8)
    b = k1.rpn_level_bwd_plain(feat, w_shared, w_out, cot, 8, True)
    cur_same = torch.equal(tr[4].cur, k1.rpn_level_plain(feat, w_shared, w_out, 8,
                                                         save=True)[3].cur)
    _hold_rpn_bwd(a, a2, own, b, tr[3], cot, cur_same)


def _max_clusters(pair):
    """How many clusters of K1's evaluation instance (two blocks) or of its
    pair instance K8 (four blocks) the card holds at once."""
    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    out = ctypes.c_int(0)
    fn = cb.function(k1.NAME, "rpn_level_max_clusters", [ctypes.c_int, ctypes.c_void_p])
    cb.check(fn(int(pair), ctypes.addressof(out)), k1.X2_NAME)
    return out.value


def _turns(first, second, iters=10):
    """Median times of ``first`` and ``second`` in turns (first, second,
    second, first), so that both see the same clocks: ([a1, a2], [b1, b2])."""
    a = [_median_ms(first, iters), 0.0]
    b = [_median_ms(second, iters), _median_ms(second, iters)]
    a[1] = _median_ms(first, iters)
    return a, b


def check_rpn_x2(dev, g, results):
    """K8, the paired RPN head (K1's kernel with the two images of a pair in
    one cluster of four), on the five flagship levels (N = 2), on one level
    with two pairs and on the three MobileNet levels at 75 readout channels:
    its readout and spike sums equal to K1's bit for bit, and held to the
    plain version with flipped spikes counted; timed in turns with K1 on
    the flagship levels and on MobileNet's, which is the measurement that
    would set ``cuda_rpn.PAIR_IMAGES``."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1

    bf = torch.bfloat16
    levels = [(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)]
    feats = [torch.rand((2, h, w, 256), generator=g, device=dev).mul(2.0).to(bf)
             for h, w in levels]
    feats4 = torch.rand((4, 48, 96, 256), generator=g, device=dev).mul(2.0).to(bf)
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.01
    w9t, wo = k1._taps_t(w_shared), w_out.to(bf).contiguous()
    # MobileNet's levels at 768 x 1536 (strides 32, 32, 64), 15 anchors, from
    # a generator of their own, so that the phases after this one keep the
    # inputs they had before these were added.
    g_m = torch.Generator(device=dev).manual_seed(8)
    m_levels = [(24, 48), (24, 48), (12, 24)]
    m_feats = [torch.rand((2, h, w, 256), generator=g_m, device=dev).mul(2.0).to(bf)
               for h, w in m_levels]
    m_out = torch.randn((256, 75), generator=g_m, device=dev) * 0.01
    m_wo = m_out.to(bf).contiguous()

    err = 0.0
    enc = flips = spiked = 0
    cases = ([(f, w_out, wo, True) for f in feats] + [(feats4, w_out, wo, False)]
             + [(f, m_out, m_wo, False) for f in m_feats])
    for f, o, wf, flagship in cases:
        shape = f"{list(f.shape)} x {o.shape[1]}"
        out, ssum = k1._launch_x2(f, w9t, wf, 8, True)
        one = k1._launch(f, w9t, wf, 8, True)
        equal = bool(torch.equal(out, one[0]) and torch.equal(ssum, one[3]))
        p_out, p_ssum = k1.rpn_level_x2_plain(f, w_shared, o, 8, True)
        e, _, f_flips, f_spiked = _hold_rpn_eval(
            [(out, None, None, ssum)], [(p_out, None, None, p_ssum)], wf, shape,
            label="K8 rpn_head_x2")
        print(f"K8 rpn_head_x2 {shape}: readout and spike sums equal to K1's bit for bit "
              f"{equal}")
        if not equal:
            _fail(f"K8 differs from K1 on {shape}")
        for pair in (False, True):
            if k1.launch_dims_on_card(f.shape, pair) != k1.level_grid(f.shape, pair):
                _fail(f"cuda_rpn.level_grid on {shape} (pair {pair}) is not the launch's "
                      f"{k1.launch_dims_on_card(f.shape, pair)}")
        if flagship:
            err = max(err, e)
            enc += int(one[1].sum())
            flips, spiked = flips + f_flips, spiked + f_spiked
    k1c, k8c = _max_clusters(False), _max_clusters(True)
    print(f"K8 rpn_head_x2: the card holds {k8c} clusters of four at once ({132 - 4 * k8c} "
          f"of 132 SMs idle); K1: {k1c} clusters of two ({132 - 2 * k1c} idle)")

    def paired(fs, wf):
        return lambda: [k1._launch_x2(f, w9t, wf, 8) for f in fs]

    def single(fs, wf):
        return lambda: [k1._launch(f, w9t, wf, 8) for f in fs]

    t1, t8 = _turns(single(feats, wo), paired(feats, wo))
    m1, m8 = _turns(single(m_feats, m_wo), paired(m_feats, m_wo))
    spread = max(abs(t1[0] - t1[1]), abs(t8[0] - t8[1]))
    gain = min(t1) - max(t8)
    print(f"K8 against K1, five flagship levels, T = 8: K1 {t1[0]:.3f} and {t1[1]:.3f} ms, "
          f"K8 {t8[0]:.3f} and {t8[1]:.3f} ms; spread of the repeats {spread:.3f} ms; "
          f"pairing is {'faster' if gain > spread else 'not faster'} by more than the "
          f"spread (default {'on' if k1.PAIR_IMAGES else 'off'})")
    print(f"K8 against K1, MobileNet's three levels x 75, T = 8: K1 {m1[0]:.3f} and "
          f"{m1[1]:.3f} ms, K8 {m8[0]:.3f} and {m8[1]:.3f} ms")
    for (h, w), f in zip(levels, feats):
        l1, l8 = _turns(single([f], wo), paired([f], wo))
        print(f"K8 against K1 on [2, {h}, {w}, 256]: K1 {min(l1):.3f} ms, K8 {min(l8):.3f} ms")
    neurons = sum(2 * h * w * 256 * 8 for h, w in levels)
    outs = paired(feats, wo)()
    _record(results, "rpn_head_x2", "snn/pallas_rpn.py:710", err, min(t8),
            _median_ms(lambda: [k1.rpn_level_x2_plain(f, w_shared, w_out, 8) for f in feats], 5),
            _bound(_nbytes(*feats, w9t, wo, *outs),
                   2.0 * enc * 9 * 256 + sum(2.0 * 2 * h * w * 256 * 15 for h, w in levels),
                   10.0 * neurons),
            turns_ms={"K1": t1, "K8": t8, "K1 MobileNet": m1, "K8 MobileNet": m8},
            clusters={"K8": k8c, "K1": k1c}, flips={"neurons": flips, "spiked": spiked})


def check_box_head_fused(dev, g, results):
    """K9: the whole box head in one call at R = 2000, K = 12544, H = 1024,
    9 classes, T = 12, held to its plain version spike by spike, and its
    time in turns with the two-kernel route's (K3 then K4) on the same
    inputs."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models import heads
    from snn_automotive_object_detection_tpu_torch.snn import cuda_kernels as k9
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    r, rep, t = 2000, 1024, 12
    bf = torch.bfloat16
    x, w6, w7, wc, wb = kc.box_head_inputs(dev, g)
    flips = kc.box_head_fused_hold(x, w6, w7, wc, wb, t)
    print(f"K9 box_head_fused at R = 2000, T = 12: {kc.box_head_fused_line(flips)}")
    if not flips["ok"]:
        _fail("K9 disagrees with its plain version at R = 2000, T = 12")
    args = k9.launch_args(x, w6, w7, wc, wb) + (t,)
    smem = k9.smem_on_card()
    print(f"K9 box_head_fused: shared memory per block, staging in the drained ring: fc6 and "
          f"fc7 {smem[0]} bytes, readout {smem[1]} (beside the ring: "
          f"{k9.smem_bytes(128, 8, False)}, over the {k9.SMEM_LIMIT} a block may have)")
    if smem != (k9.smem_bytes(128, 8, True), k9.smem_bytes(64, 8, True)):
        _fail(f"K9 launches with {smem} bytes of shared memory, cuda_kernels.smem_bytes says "
              f"{(k9.smem_bytes(128, 8, True), k9.smem_bytes(64, 8, True))}")
    periods = args[0]
    params = {"fc6": {"w": args[1]}, "fc7": {"w": args[2]}, "cls_score": {"w": wc},
              "bbox_pred": {"w": wb}}
    xb = x.to(bf)
    k9_ms, two = _turns(lambda: k9._launch(*args), lambda: heads.fastrcnn_snn_apply(params, xb, t))
    whole = _median_ms(lambda: k9.fastrcnn_snn_cuda(x, args[1], args[2], wc, wb, t), 10)
    pms = _median_ms(lambda: k9.fastrcnn_snn_plain(x, w6, w7, wc, wb, t), 3)
    print(f"K9 against K3 + K4 on the same inputs, in turns: K9 {k9_ms[0]:.3f} and "
          f"{k9_ms[1]:.3f} ms on the periods ({whole:.3f} ms with the period map, a PyTorch "
          f"pointwise pass over f32 x); K3 then K4 through fastrcnn_snn_apply {two[0]:.3f} and "
          f"{two[1]:.3f} ms")
    # The encoder spikes within T steps: floor(T / p) per element. fc6 adds
    # a 1024-wide row per encoder spike, fc7 one per fc6 spike, the readout
    # a 45-wide row per fc7 spike; about 10 f32 operations per neuron and step.
    def bound_at(steps, rep_t):
        enc = (steps // periods.int()).sum().item()
        outs = k9._launch(*args[:-1], steps)
        return _bound(_nbytes(periods, *args[1:4], *outs),
                      2.0 * enc * rep + 2.0 * rep_t["n6"] * rep + 2.0 * rep_t["n7"] * 45,
                      10.0 * steps * r * (2 * rep + 45))

    bound = bound_at(t, flips)
    # The same inputs at T = 32 (two code planes) and past the reference's
    # other kernels' 32 steps, T = 40 and 48 (three planes): one GEMM pass
    # per plane, the states carried from plane to plane.
    long_t = {}
    for t_long in K9_LONG_T:
        held = kc.box_head_fused_hold(x, w6, w7, wc, wb, t_long)
        print(f"K9 box_head_fused at R = 2000, T = {t_long}: {kc.box_head_fused_line(held)}")
        if not held["ok"]:
            _fail(f"K9 disagrees with its plain version at R = 2000, T = {t_long}")
        args_long = args[:-1] + (t_long,)
        ms_long = _median_ms(lambda: k9._launch(*args_long), 10)
        pms_long = _median_ms(lambda: k9.fastrcnn_snn_plain(x, w6, w7, wc, wb, t_long), 3)
        bound_long = bound_at(t_long, held)
        print(f"K9 box_head_fused at T = {t_long}: {ms_long:.3f} ms kernel on the periods, "
              f"{pms_long:.3f} ms plain; bound {bound_long['bound_ms']:.4f} ms by "
              f"{bound_long['bound_by']} ({ms_long / bound_long['bound_ms']:.1f}x)")
        long_t[t_long] = dict(max_abs_err=held["err"], ms=ms_long, plain_ms=pms_long,
                              flips={k: held[k] for k in ("flips6", "n6", "flips7", "n7",
                                                          "rows7")}, **bound_long)
    _record(results, "box_head_fused", "snn/pallas_kernels.py:212", flips["err"], min(k9_ms),
            pms, bound, turns_ms={"K9": k9_ms, "K3 + K4": two},
            flips={k: flips[k] for k in ("flips6", "n6", "flips7", "n7", "rows7")},
            long_t=long_t)


def _grid_weights(shape, g, dev):
    """Weights on the grid k 2^-10, |k| <= 10 (about the flagship's 0.01
    scale): every partial sum of spikes times them is a multiple of 2^-10
    below 2^5, exact in f32, so a conv summed in any order gives the same
    currents and the LIF recurrence alone decides the spikes."""
    import torch

    return torch.randint(-10, 11, shape, generator=g, device=dev).float() * 2.0 ** -10


def check_rpn_s16(dev, g, results):
    """K1's instance for bf16 neuron states on the five flagship levels (T =
    8, 15 readout channels) against its plain version: on random weights
    with flipped spikes counted (at most 0.1% of the neurons that spiked, as
    K1), and on weights whose conv sums are exact in any order
    (:func:`_grid_weights`), where the currents are the plain version's bits
    and no spike may flip; timed in turns with K1's float32-state
    instance on the same inputs."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1

    bf = torch.bfloat16
    levels = [(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)]
    feats = [torch.rand((2, h, w, 256), generator=g, device=dev).mul(2.0).to(bf)
             for h, w in levels]
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.01
    w9t, wo = k1._taps_t(w_shared), w_out.to(bf).contiguous()

    def s16(w9, spike_sum=False):
        return [k1._launch(f, w9, wo, 8, spike_sum, bf16_states=True) for f in feats]

    def plain(w, spike_sum=False):
        return [k1.rpn_level_plain(f, w, w_out, 8, spike_sum, bf16_states=True) for f in feats]

    got, want = s16(w9t, True), plain(w_shared, True)
    err, enc, flips, spiked = _hold_rpn_eval(got, want, wo, "on the five flagship levels",
                                             label="K1 rpn_head_s16")
    w_grid = _grid_weights((3, 3, 256, 256), g, dev)
    g_err, _, g_flips, g_spiked = _hold_rpn_eval(
        s16(k1._taps_t(w_grid), True), plain(w_grid, True), wo,
        "on weights whose conv sums are exact", label="K1 rpn_head_s16")
    if g_flips:
        _fail(f"K1 rpn_head_s16 flips {g_flips} spikes where its currents are the plain "
              f"version's bits")
    lif32 = [k1._launch(f, w9t, wo, 8) for f in feats]
    n16 = sum(int(a[2].sum()) for a in got)
    n32 = sum(int(a[2].sum()) for a in lif32)
    print(f"K1 rpn_head_s16: LIF spikes with bf16 states {n16}, with f32 states {n32} "
          f"({(n16 - n32) / max(n32, 1):+.2e})")
    k16_ms, k32_ms = _turns(lambda: s16(w9t), lambda: [k1._launch(f, w9t, wo, 8) for f in feats])
    pms = _median_ms(lambda: plain(w_shared), 5)
    print(f"K1 rpn_head_s16 against K1 (f32 states) in turns, five levels: bf16 states "
          f"{k16_ms[0]:.3f} and {k16_ms[1]:.3f} ms, f32 states {k32_ms[0]:.3f} and "
          f"{k32_ms[1]:.3f} ms")
    neurons = sum(2 * h * w * 256 * 8 for h, w in levels)
    _record(results, "rpn_head_s16", "snn/pallas_rpn.py:449", err, min(k16_ms), pms,
            _bound(_nbytes(*feats, w9t, wo, *[a[0] for a in got], *[a[1] for a in got],
                           *[a[2] for a in got]),
                   2.0 * enc * 9 * 256 + sum(2.0 * 2 * h * w * 256 * 15 for h, w in levels),
                   10.0 * neurons),
            turns_ms={"bf16 states": k16_ms, "f32 states": k32_ms},
            flips={"neurons": flips, "spiked": spiked, "exact_currents": g_flips,
                   "exact_currents_spiked": g_spiked, "exact_currents_err": g_err})


def check_rpn_s16_train(dev, g, results):
    """K1's training instance and K7 with bf16 neuron states on the five
    flagship levels (T = 8, 15 readout channels, features over [0, 3)).
    The training instance against its plain version as ``check_rpn_s16``
    holds K1's bf16-state instance (flipped spikes counted, at most 0.1% of
    the neurons that spiked), its readout, counts and spike sums equal to
    that instance's bits, its periods the plain version's; on grid weights
    (:func:`_grid_weights`) no flip and its saved currents the plain
    version's bits. K7's bf16-state instance against its plain version on
    the same saved tensors with K7's bounds (``_hold_rpn_bwd``; against the
    replaying plain version where the currents are its bits), on random and
    on grid weights. The training forward timed in turns with the
    evaluation instance, K7 with its sweep apart, each beside its bound."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    bf = torch.bfloat16
    levels = [(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)]
    feats = [torch.rand((2, h, w, 256), generator=g, device=dev).mul(3.0).to(bf)
             for h, w in levels]
    cots = [torch.randn((2, h, w, 15), generator=g, device=dev) for h, w in levels]
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.01
    w_grid = _grid_weights((3, 3, 256, 256), g, dev)
    wo = w_out.to(bf).contiguous()

    def train16(w9, spike_sum=True):
        return [k1._launch(f, w9, wo, 8, spike_sum, True, bf16_states=True) for f in feats]

    err = worst = 0.0
    for label, w in (("random", w_shared), ("grid", w_grid)):
        w9t = k1._taps_t(w)
        trains = train16(w9t)
        evals = [k1._launch(f, w9t, wo, 8, True, bf16_states=True) for f in feats]
        same = all(torch.equal(a[i], b[i]) for a, b in zip(trains, evals) for i in range(4))
        plains = [k1.rpn_level_plain(f, w, w_out, 8, True, save=True, bf16_states=True)
                  for f in feats]
        e, enc, flips, spiked = _hold_rpn_eval([t[:4] for t in trains], [p[:4] for p in plains],
                                               wo, f"on the five flagship levels, {label} "
                                               "weights", label="K1 rpn_head_s16_save")
        per_equal = all(torch.equal(t[4].per, p[4].per) for t, p in zip(trains, plains))
        cur_same = [torch.equal(t[4].cur, p[4].cur) for t, p in zip(trains, plains)]
        cur_ex = max(kc.excess(t[4].cur.float(), p[4].cur.float())
                     for t, p in zip(trains, plains))
        print(f"K1 rpn_head_s16_save ({label} weights): readout, counts and spike sums equal "
              f"the bf16-state evaluation instance's bits {same}; periods equal the plain "
              f"version's {per_equal}; currents the plain version's bits per level {cur_same}, "
              f"{cur_ex:.3g} of the bound 2^-7|want| + {kc.ATOL}")
        if not same or not per_equal or cur_ex > 1 or (label == "grid" and (
                flips or not all(cur_same))):
            _fail(f"K1's bf16-state training instance disagrees with its evaluation instance "
                  f"or its plain version ({label} weights)")
        del plains
        for f, t, c, cs in zip(feats, trains, cots, cur_same):
            a = k1._launch_bwd(_fresh(t[4]), wo, c, 8, True, bf16_states=True)
            a2 = k1._launch_bwd(_fresh(t[4]), wo, c, 8, bf16_states=True)
            own = k1.rpn_level_bwd_from_saved_plain(t[4], w_out, c, 8, bf16_states=True)
            b = k1.rpn_level_bwd_plain(f, w, w_out, c, 8, True, bf16_states=True)
            e7, ex7 = _hold_rpn_bwd(a, a2, own, b, t[3], c, cs)
            if label == "random":
                err, worst = max(err, e7), max(worst, ex7)
        if label == "random":
            s_err, s_enc, s_flips, s_spiked, saved = e, enc, flips, spiked, [t[4] for t in trains]
        else:
            g_flips, g_spiked = flips, spiked
    print(f"K7 rpn_head_bwd_s16: max |diff| {err:.3g}, {worst:.3g} of the bound")

    w9t = k1._taps_t(w_shared)

    def forward(save):
        return [k1._launch(f, w9t, wo, 8, False, save, bf16_states=True) for f in feats]

    t_save, t_eval = _turns(lambda: forward(True), lambda: forward(False))
    pms = _median_ms(lambda: [k1.rpn_level_plain(f, w_shared, w_out, 8, save=True,
                                                 bf16_states=True) for f in feats], 3)
    print(f"K1 rpn_head_s16_save, five levels: {t_save[0]:.3f} and {t_save[1]:.3f} ms, the "
          f"bf16-state evaluation instance {t_eval[0]:.3f} and {t_eval[1]:.3f} ms in turns")
    neurons = sum(2 * h * w * 256 * 8 for h, w in levels)
    outs = forward(True)
    # K1's operations; its bytes and, written once, the saved tensors.
    _record(results, "rpn_head_s16_save", "snn/pallas_rpn.py:449", s_err, min(t_save), pms,
            _bound(_nbytes(*feats, w9t, wo, *[a[0] for a in outs], *[a[1] for a in outs],
                           *[a[2] for a in outs], *[x for a in outs for x in a[3]]),
                   2.0 * s_enc * 9 * 256 + sum(2.0 * 2 * h * w * 256 * 15 for h, w in levels),
                   10.0 * neurons),
            turns_ms={"training instance": t_save, "evaluation instance": t_eval},
            flips={"neurons": s_flips, "spiked": s_spiked, "exact_currents": g_flips,
                   "exact_currents_spiked": g_spiked})

    def k7(phases, states16=True):
        return lambda xs: [k1._launch_bwd(x, wo, c, 8, phases=phases, bf16_states=states16)
                           for x, c in zip(xs, cots)]

    def prepare():
        return [_fresh(sv) for sv in saved]

    ms16 = _median_ms_fresh(prepare, k7(7), 10)
    sweep16 = _median_ms_fresh(prepare, k7(1), 10)
    sweep32 = _median_ms_fresh(prepare, k7(1, False), 10)
    ms16b = _median_ms_fresh(prepare, k7(7), 10)
    pms7 = _median_ms(lambda: [k1.rpn_level_bwd_from_saved_plain(sv, w_out, c, 8,
                                                                  bf16_states=True)
                               for sv, c in zip(saved, cots)], 3)
    print(f"K7 rpn_head_bwd_s16, five levels: {ms16:.3f} and {ms16b:.3f} ms; its sweep "
          f"{sweep16:.3f} ms, the f32-state sweep on the same tensors {sweep32:.3f} ms; plain "
          f"version from the saved tensors {pms7:.3f} ms")
    got = k7(7)(prepare())
    px = [2 * h * w for h, w in levels]
    _record(results, "rpn_head_bwd_s16", "snn/pallas_rpn.py:1012", err, min(ms16, ms16b), pms7,
            _bound(2 * _nbytes(*[sv.cur for sv in saved])
                   + _nbytes(*[sv.per for sv in saved], *[sv.ssum for sv in saved], *cots, wo,
                             *[a[0] for a in got], *[a[1] for a in got]),
                   2.0 * s_enc * 9 * 256,
                   sum(2 * 2.0 * p * 256 * 15 for p in px) + 25.0 * 8 * 256 * sum(px)),
            sweep_ms={"bf16 states": sweep16, "f32 states": sweep32})


def check_rpn_x2_s16(dev, g, results):
    """K8's instance for bf16 neuron states on the five flagship levels (N =
    2, T = 8, 15 readout channels): its readout and spike sums equal to K1's
    bf16-state instance's bit for bit, held to its plain version with
    flipped spikes counted, and timed in turns with K1's bf16-state
    instance."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1

    bf = torch.bfloat16
    levels = [(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)]
    feats = [torch.rand((2, h, w, 256), generator=g, device=dev).mul(2.0).to(bf)
             for h, w in levels]
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.01
    w9t, wo = k1._taps_t(w_shared), w_out.to(bf).contiguous()
    got, ones, want = [], [], []
    for f in feats:
        got.append(k1._launch_x2(f, w9t, wo, 8, True, bf16_states=True))
        ones.append(k1._launch(f, w9t, wo, 8, True, bf16_states=True))
        want.append(k1.rpn_level_x2_plain(f, w_shared, w_out, 8, True, bf16_states=True))
    equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[3]) for a, b in zip(got, ones))
    err, _, flips, spiked = _hold_rpn_eval([(a[0], None, None, a[1]) for a in got],
                                           [(b[0], None, None, b[1]) for b in want], wo,
                                           "on the five flagship levels",
                                           label="K8 rpn_head_x2_s16")
    print(f"K8 rpn_head_x2_s16: readout and spike sums equal to K1 rpn_head_s16's bit for bit "
          f"{equal}")
    if not equal:
        _fail("K8's bf16-state instance differs from K1's bf16-state instance")
    t16, t8 = _turns(lambda: [k1._launch(f, w9t, wo, 8, bf16_states=True) for f in feats],
                     lambda: [k1._launch_x2(f, w9t, wo, 8, bf16_states=True) for f in feats])
    print(f"K8 rpn_head_x2_s16 against K1 rpn_head_s16, five levels, in turns: K8 {t8[0]:.3f} "
          f"and {t8[1]:.3f} ms, K1 {t16[0]:.3f} and {t16[1]:.3f} ms")
    pms = _median_ms(lambda: [k1.rpn_level_x2_plain(f, w_shared, w_out, 8, bf16_states=True)
                              for f in feats], 3)
    enc = sum(int(b[1].sum()) for b in ones)
    neurons = sum(2 * h * w * 256 * 8 for h, w in levels)
    outs = [k1._launch_x2(f, w9t, wo, 8, bf16_states=True) for f in feats]
    _record(results, "rpn_head_x2_s16", "snn/pallas_rpn.py:710", err, min(t8), pms,
            _bound(_nbytes(*feats, w9t, wo, *outs),
                   2.0 * enc * 9 * 256 + sum(2.0 * 2 * h * w * 256 * 15 for h, w in levels),
                   10.0 * neurons),
            turns_ms={"K8 bf16 states": t8, "K1 bf16 states": t16},
            flips={"neurons": flips, "spiked": spiked})


# The kernel phases in the order they draw from one generator.
KERNEL_CHECKS = (check_rpn_head, check_roi_align, check_encoder_fc6, check_box_tail, check_fpn,
                 check_stem, check_rpn_bwd, check_wide_readout, check_rpn_x2,
                 check_box_head_fused, check_rpn_s16, check_rpn_s16_train, check_rpn_x2_s16)


def output_problems(out, config, n):
    """The spiking detector's outputs of an n-image batch, as a list of what
    is wrong with them (empty when nothing is): their fixed shapes, finite
    values, scores in [0, 1], labels among the classes and, where
    collected, rates in [0, 1]. The port's benchmark (``bench_torch``)
    holds its cells' outputs with it too."""
    import torch

    h, w = config.bucket
    p, d, c = config.rpn.post_nms_top_n_test, config.roi.detections_per_img, config.num_classes
    s = sum(min(config.rpn.pre_nms_top_n_test, (h // st) * (w // st) * a)
            for st, a in zip(config.fpn_strides, config.anchor_spec.num_anchors_per_location))
    shapes = {"boxes": (n, d + p, 4), "scores": (n, d + p), "labels": (n, d + p),
              "valid": (n, d + p), "proposals": (n, s, 4), "objectness": (n, s),
              "all_scores": (n, p, c), "all_boxes": (n, p, c, 4)}
    problems = []
    for k, shp in shapes.items():
        if k not in out or tuple(out[k].shape) != shp:
            problems.append(f"{k}: shape {tuple(out[k].shape) if k in out else None} != {shp}")
        elif out[k].is_floating_point() and not torch.isfinite(out[k]).all():
            problems.append(f"{k}: non-finite values")
    if not problems:
        sc = out["scores"]
        if (sc < 0).any() or (sc > 1).any() or (out["labels"] >= c).any():
            problems.append("scores outside [0, 1] or labels outside the classes")
    for group in ("rpn_rates", "det_rates"):
        for k, v in (out.get(group) or {}).items():
            if not torch.isfinite(v).all() or (v < 0).any() or (v > 1).any():
                problems.append(f"{group}/{k}: rates outside [0, 1]")
    return problems


def _check_outputs(out, cfg, n):
    """Fails unless the detector's outputs of an n-image batch are well
    formed and finite (:func:`output_problems`)."""
    problems = output_problems(out, cfg, n)
    if problems:
        _fail("; ".join(problems))


def _profile(run, what="batch"):
    """Device time of one ``run()`` by kernel, the device's busy share of
    the wall time, the count of synchronisations, and the host-side ops
    with the most self time."""
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
    syncs = sum(h[1] for h in host if "Synchronize" in h[2])
    print(f"profile: one {what} {wall_us / 1e3:.3f} ms wall, {busy / 1e3:.3f} ms "
          f"kernel and copy time on the device ({100 * busy / wall_us:.1f}% busy), "
          f"{sum(r[1] for r in rows)} device events, {syncs} stream or device "
          f"synchronisations")
    for us, count, key in rows[:25]:
        print(f"profile: {us / 1e3:10.3f} ms {100 * us / busy:5.1f}% x{count:<4d} {key[:90]}")
    for us, count, key in host[:10]:
        print(f"profile host: {us / 1e3:10.3f} ms self x{count:<5d} {key[:80]}")
    return syncs


def main_path(dev, iters=3):
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
        out, _ = detector_apply(params, batches[i % 2], cfg, collect_rates=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cb.LAUNCHES)
    plain_calls = dict(cb.PLAIN_CUDA_CALLS)

    print(f"main path: {iters} batches of {n} x {h} x {w}: launches {launches}, "
          f"plain versions on the GPU {plain_calls}")
    want = {**{k: 0 for k in cb.KERNELS}, "rpn_head": 5 * iters, "roi_align": iters,
            "encoder_fc6": iters, "box_tail": iters, "fpn_level": 4 * iters, "stem": iters}
    if launches != want:
        _fail(f"the main path's launches are not {want}")
    if any(v != 0 for v in plain_calls.values()):
        _fail("a plain version ran on the GPU in the main path")
    _check_outputs(out, cfg, n)
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


def eval_path(dev, backbone, iters=3):
    """The plain evaluation call, ``detector_apply(training=False,
    collect_rates=False)``, on one backbone at 2 x 768 x 1536, full width
    and depth: in turns with the RPN head's pairing switch on (K8 on every
    level) and off (K1). K8 gives K1's bits per image (``check_rpn_x2``),
    so every output must be the same with the switch on and off. Returns the
    launches of its last counted run with the switch on and its last with
    it off, summed: K8 serves this path only through the switch."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12, backbone=backbone)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    resnet = backbone == "resnet50_fpn"
    if not resnet:
        # He-normal MobileNet maps stay below the encoder's threshold of 0.25
        # (3% of the features pass it); a gain on the FPN's output convs puts
        # them in its range, so that the heads' kernels see spikes.
        for layer in params["backbone"]["fpn"]["layer"]:
            layer["w"].mul_(6.0)
    n, (h, w) = 2, cfg.bucket
    g = torch.Generator(device=dev).manual_seed(1)
    batches = [{"images": torch.rand((n, h, w, 3), generator=g, device=dev),
                "image_sizes": torch.tensor([[h, w]] * n, device=dev),
                "original_sizes": torch.tensor([[1024, 2048]] * n, device=dev)}
               for _ in range(2)]
    levels = len(cfg.fpn_strides)
    default = cuda_rpn.PAIR_IMAGES
    runs, rate = {}, {True: [], False: []}
    try:
        # In turns (on, off, off, on): whichever runs first also warms the
        # allocator and the clocks up.
        for paired in (True, False, False, True):
            cuda_rpn.PAIR_IMAGES = paired
            detector_apply(params, batches[0], cfg)      # warm-up
            torch.cuda.synchronize()
            cb.reset_counts()
            t0 = time.perf_counter()
            for i in range(iters):
                out, _ = detector_apply(params, batches[i % 2], cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches, plain_calls = dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS)
            rate[paired].append(n * iters / dt)
            print(f"{backbone}, rates off, pairing {'on' if paired else 'off'}: {iters} batches "
                  f"of {n} x {h} x {w}: launches {launches}; {n * iters / dt:.3f} images/s "
                  f"({dt / iters * 1000:.1f} ms per batch)")
            want = {**{k: 0 for k in cb.KERNELS},
                    "rpn_head_x2": levels * iters if paired else 0,
                    "rpn_head": 0 if paired else levels * iters,
                    "roi_align": iters, "encoder_fc6": iters, "box_tail": iters,
                    "fpn_level": 4 * iters if resnet else 0, "stem": iters if resnet else 0}
            if launches != want:
                _fail(f"the launches of the rates-off path on {backbone} are not {want}")
            if any(v != 0 for v in plain_calls.values()):
                _fail("a plain version ran on the GPU in the rates-off path")
            if "rpn_rates" in out or "det_rates" in out:
                _fail("the rates-off path returned rates")
            _check_outputs(out, cfg, n)
            runs[paired] = (out, launches)
        cuda_rpn.PAIR_IMAGES = default
        _profile(lambda: detector_apply(params, batches[0], cfg), f"{backbone} rates-off batch")
    finally:
        cuda_rpn.PAIR_IMAGES = default
    print(f"{backbone}, rates off: images/s with pairing on {rate[True][0]:.3f} and "
          f"{rate[True][1]:.3f}, off {rate[False][0]:.3f} and {rate[False][1]:.3f}")
    differ = {k: int((v != runs[False][0][k]).sum()) for k, v in runs[True][0].items()}
    print(f"{backbone}, rates off: elements that differ between pairing on and off {differ}")
    if any(differ.values()):
        _fail(f"{backbone}: the outputs differ between pairing on and off")
    out = runs[False][0]
    # Outside the counted runs: the same batch once more with rates on, for
    # the spike rates the kernels worked at.
    rated, _ = detector_apply(params, batches[(iters - 1) % 2], cfg, collect_rates=True)
    rr = [round(x, 4) for x in rated["rpn_rates"]["shared"].mean(dim=1).tolist()]
    dr = {k: round(v.mean().item(), 4) for k, v in rated["det_rates"].items()}
    print(f"{backbone}, rates off: {int(out['valid'].sum())} valid output rows, "
          f"{int((out['valid'] & (out['labels'] > 0)).sum())} FG detections, max objectness "
          f"{out['objectness'].max().item():.4f} in the last batch; with rates on, RPN LIF "
          f"rates per level {rr}, box-head rates {dr}")
    if not torch.equal(rated["objectness"], out["objectness"]):
        _fail(f"{backbone}: K1's objectness differs between rates on and off")
    if max(rr) == 0 or dr["fc6"] == 0:
        _fail(f"{backbone}: no spike in the RPN head or in fc6")
    return {k: runs[True][1][k] + runs[False][1][k] for k in runs[True][1]}


def float32_eval_path(dev):
    """``detector_apply(training=False)`` with ``compute_dtype=torch.float32``
    on one flagship batch: the reference's scans and the gather RoIAlign,
    no kernel launched and no kernel's plain version run, outputs finite and
    well formed. Returns the launches."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12, compute_dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n, (h, w) = 2, cfg.bucket
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"images": torch.rand((n, h, w, 3), generator=g, device=dev),
             "image_sizes": torch.tensor([[h, w]] * n, device=dev),
             "original_sizes": torch.tensor([[1024, 2048]] * n, device=dev)}
    cb.reset_counts()
    t0 = time.perf_counter()
    out, _ = detector_apply(params, batch, cfg, collect_rates=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain_calls = dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS)
    rr = [round(x, 4) for x in out["rpn_rates"]["shared"].mean(dim=1).tolist()]
    print(f"float32 evaluation: one batch of {n} x {h} x {w} in {dt * 1000:.1f} ms (first call); "
          f"launches {launches}; plain versions on the GPU {plain_calls}; RPN LIF rates per "
          f"level {rr}, fc6 rate {out['det_rates']['fc6'].mean().item():.4f}")
    if any(v != 0 for v in launches.values()) or any(v != 0 for v in plain_calls.values()):
        _fail("float32 evaluation launched a kernel or ran a kernel's plain version")
    _check_outputs(out, cfg, n)
    if out["boxes"].dtype != torch.float32 or out["objectness"].dtype != torch.float32:
        _fail("float32 evaluation returned outputs of another dtype")
    return launches


def fused_head_path(dev):
    """The fused box head's own entry point, ``fastrcnn_snn_cuda``, on the
    flagship box head's weights and 2 x 1000 RoI feature rows: one launch
    of its wrapper for all 12 steps, whose call runs the kernel's four
    passes on the device. Returns the launches."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.snn.cuda_kernels import fastrcnn_snn_cuda
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12)
    head = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)["box_head"]
    x = torch.rand((2000, 12544), generator=torch.Generator(device=dev).manual_seed(3),
                   device=dev) * 2.5
    weights = [head[k]["w"] for k in ("fc6", "fc7", "cls_score", "bbox_pred")]
    fastrcnn_snn_cuda(x, *weights, cfg.t_det)                       # warm-up
    torch.cuda.synchronize()
    kernels = [k for k in _device_kernels(lambda: fastrcnn_snn_cuda(x, *weights, cfg.t_det))
               if "period_code" in k or "spike_gemm" in k]
    print(f"fused box head: one call runs the kernel's passes {kernels}")
    if len(kernels) != 4:
        _fail("the fused box head's call does not run its four passes")
    cb.reset_counts()
    t0 = time.perf_counter()
    cls, reg, r6, r7 = fastrcnn_snn_cuda(x, *weights, cfg.t_det)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain_calls = dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS)
    print(f"fused box head: 2000 RoIs, T = 12: launches {launches}; {dt * 1000:.1f} ms; "
          f"rates fc6 {r6.mean().item():.4f} fc7 {r7.mean().item():.4f}; max |logit| "
          f"{cls.abs().max().item():.4g}")
    if launches != {**{k: 0 for k in launches}, "box_head_fused": 1}:
        _fail("the fused box head is not one launch of its kernel")
    if any(v != 0 for v in plain_calls.values()):
        _fail("a plain version ran on the GPU in the fused box head")
    for a, shp in zip((cls, reg, r6, r7), ((2000, 9), (2000, 36), (2000,), (2000,))):
        if tuple(a.shape) != shp or not torch.isfinite(a).all():
            _fail(f"fused box head: output {tuple(a.shape)} is not finite {shp}")
    if not (0 < r6.mean().item() < 1 and 0 <= r7.min().item() and r7.max().item() <= 1):
        _fail("fused box head: rates outside [0, 1] or no fc6 spike")
    return launches


ROUTES = (  # (rpn_snn, detector_snn, snn_state_dtype): the factory's other heads and states
    (False, True, "float32"), (True, False, "float32"), (False, False, "float32"),
    (True, True, None))


def _check_ann_outputs(out, n, d):
    """The ANN box head's evaluation outputs: D rows of foreground
    detections per image, finite, scores in [0, 1], no pre-NMS per-class
    outputs."""
    import torch

    for k, shp in (("boxes", (n, d, 4)), ("scores", (n, d)), ("labels", (n, d)),
                   ("valid", (n, d))):
        if tuple(out[k].shape) != shp:
            _fail(f"{k}: shape {tuple(out[k].shape)} != {shp}")
    if not (torch.isfinite(out["boxes"]).all() and torch.isfinite(out["objectness"]).all()):
        _fail("the ANN box head's route gave non-finite values")
    if (out["scores"] < 0).any() or (out["scores"] > 1).any() or "all_boxes" in out:
        _fail("the ANN box head's outputs are not well formed")


def _bf16_state_pairing(params, batches, cfg, iters):
    """Rates-off evaluation with bf16 neuron states in turns with the RPN
    head's pairing switch on and off: K8's bf16-state instance x5 per batch
    with it on and K1's bf16-state instance x5 with it off (K2, K3, K5, K6
    x1, x1, x4, x1, no K4: the tail is a scan), no plain version, and every
    output the same bits either way (K8 gives K1's bits per image). Returns
    the launches of both turns, summed."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    default = cuda_rpn.PAIR_IMAGES
    runs = {}
    try:
        for paired in (True, False):
            cuda_rpn.PAIR_IMAGES = paired
            detector_apply(params, batches[0], cfg)      # warm-up
            torch.cuda.synchronize()
            cb.reset_counts()
            t0 = time.perf_counter()
            for i in range(iters):
                out, _ = detector_apply(params, batches[i % 2], cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(cb.LAUNCHES)
            want = {**{k: 0 for k in cb.KERNELS}, "stem": iters, "fpn_level": 4 * iters,
                    "roi_align": iters, "encoder_fc6": iters,
                    ("rpn_head_x2_s16" if paired else "rpn_head_s16"): 5 * iters}
            print(f"route bf16 states, rates off, pairing {'on' if paired else 'off'}: {iters} "
                  f"batches: launches {launches}; {2 * iters / dt:.3f} images/s")
            if launches != want:
                _fail(f"the bf16-state route's rates-off launches are not {want}")
            if any(v != 0 for v in cb.PLAIN_CUDA_CALLS.values()):
                _fail("a plain version ran on the GPU on the bf16-state route")
            runs[paired] = (out, launches)
    finally:
        cuda_rpn.PAIR_IMAGES = default
    differ = {k: int((v != runs[False][0][k]).sum()) for k, v in runs[True][0].items()}
    print(f"route bf16 states, rates off: elements that differ between pairing on and off "
          f"{differ}")
    if any(differ.values()):
        _fail("the bf16-state route's outputs differ between pairing on and off")
    return {k: runs[True][1][k] + runs[False][1][k] for k in runs[True][1]}


def routes_path(dev, iters=2):
    """``detector_apply`` evaluation with rates on the factory's other heads
    and states at the flagship width (2 x 768 x 1536, 9 classes, T_rpn = 8,
    T_det = 12): an ANN RPN head with the spiking box head, the spiking RPN
    head with the ANN box head, both ANN, and both spiking with bf16 neuron
    states. Exact launch counts per batch: the ANN RPN head launches no K1,
    the ANN box head no K3 or K4 (K2 still pools for it), bf16 states K1's
    bf16-state instance x5, K3 x1 and no K4; finite, well-formed outputs;
    host-clock images/s of each. bf16 states also run rates off in turns
    with the pairing switch on and off (:func:`_bf16_state_pairing`).
    Returns the launches of all of them."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    total = {k: 0 for k in cb.KERNELS}
    for rpn_snn, det_snn, states in ROUTES:
        cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12, rpn_snn=rpn_snn,
                             detector_snn=det_snn,
                             snn_state_dtype=getattr(torch, states) if states else None)
        name = f"rpn_snn={rpn_snn}, detector_snn={det_snn}, states {states or 'bfloat16'}"
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        n, (h, w) = 2, cfg.bucket
        g = torch.Generator(device=dev).manual_seed(1)
        batches = [{"images": torch.rand((n, h, w, 3), generator=g, device=dev),
                    "image_sizes": torch.tensor([[h, w]] * n, device=dev),
                    "original_sizes": torch.tensor([[1024, 2048]] * n, device=dev)}
                   for _ in range(2)]
        detector_apply(params, batches[0], cfg, collect_rates=True)   # warm-up
        torch.cuda.synchronize()
        cb.reset_counts()
        t0 = time.perf_counter()
        for i in range(iters):
            out, _ = detector_apply(params, batches[i % 2], cfg, collect_rates=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, plain_calls = dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS)
        want = {k: 0 for k in cb.KERNELS}
        want.update(stem=iters, fpn_level=4 * iters, roi_align=iters)
        if rpn_snn:
            want["rpn_head" if states else "rpn_head_s16"] = 5 * iters
        if det_snn:
            want["encoder_fc6"] = iters
            want["box_tail"] = iters if states else 0
        print(f"route {name}: {iters} batches of {n} x {h} x {w}: launches {launches}; "
              f"{n * iters / dt:.3f} images/s ({dt / iters * 1000:.1f} ms per batch)")
        if launches != want:
            _fail(f"the launches of the route {name} are not {want}")
        if any(v != 0 for v in plain_calls.values()):
            _fail(f"a plain version ran on the GPU on the route {name}")
        if det_snn:
            _check_outputs(out, cfg, n)
        else:
            _check_ann_outputs(out, n, cfg.roi.detections_per_img)
        if (out.get("rpn_rates") is None) == rpn_snn or (out.get("det_rates") is None) == det_snn:
            _fail(f"the route {name} returned rates of the wrong heads")
        fg = int((out["valid"] & (out["labels"] > 0)).sum())
        print(f"route {name}: {fg} FG detections in the last batch, max objectness "
              f"{out['objectness'].max().item():.4f}")
        for k, v in launches.items():
            total[k] += v
        if rpn_snn and det_snn and not states:
            for k, v in _bf16_state_pairing(params, batches, cfg, iters).items():
                total[k] += v
    return total


def cli_path(dev, n_images=4, image_hw=(768, 1536)):
    """The port's CLIs on the card at the flagship configuration (9
    classes, T_rpn = 8, T_det = 12, batch 2 at the 768 x 1536 bucket): a
    seeded COCO-format set written to a temporary directory (the images of
    :func:`synthetic_coco` as ``.npy`` files, the dataset config as JSON,
    so that no OpenCV or PyYAML is needed); one training epoch, a second one
    from ``--resume`` of its checkpoint (the weights moved, K7 x5 a step),
    then ``--test-only --load-model`` of the weights it wrote (12 stats, the
    launches of its evaluation batches exact: rates-off K6 x1, K5 x4, K1
    x5, K2, K3, K4 x1 per batch), an ``-ext-prop-det`` dump,
    ``--extract-spike-rates`` and the T sweep over t_det 8, 12 and 40 (the
    box head's kernels up to 32 steps, its scan above); then the analysis
    CLIs: the noise sweep of the epoch's weights at gaussian variance 0 and
    0.05 and at 0 and 50 rain drops (the evaluation's launches per point),
    new-object discovery on the dump (no panels: the card's machine has no
    Matplotlib), the energy recompute from the rates; last one epoch with
    ``--no-amp`` (bf16 neuron states: K1's and K7's bf16-state instances x5
    a step, K1's x5 a validation batch). Prints host-clock images/s of the
    evaluation and the seconds of each run. Returns the launches of all of
    them."""
    import os
    import tempfile

    import numpy as np
    import torch

    from snn_automotive_object_detection_tpu_torch.cli import energy_efficiency_plot as energy
    from snn_automotive_object_detection_tpu_torch.cli import new_object_discovery as nod
    from snn_automotive_object_detection_tpu_torch.cli import noise_calculations as noise
    from snn_automotive_object_detection_tpu_torch.cli import test_and_energy_eff as sweep
    from snn_automotive_object_detection_tpu_torch.cli import train as cli
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    total = {k: 0 for k in cb.KERNELS}

    def run(module, *extra):
        cb.reset_counts()
        t0 = time.perf_counter()
        got = module.main(module.get_args_parser().parse_args(common + list(extra)))
        torch.cuda.synchronize()
        launches = dict(cb.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        if any(v != 0 for v in cb.PLAIN_CUDA_CALLS.values()):
            _fail(f"a plain version ran on the GPU in the CLI run {extra}")
        return got, launches, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        out = _write_cli_set(tmp, n_images, image_hw)
        common = ["-d", os.path.join(tmp, "ds.json"), "--rpn-snn", "--detector-snn",
                  "-t-rpn", "8", "-t-det", "12", "-b", "2", "-j", "4", "--print-freq", "1",
                  "--device", str(dev)]
        _, launches, secs = run(cli, "--epochs", "1")
        for name in ("model_cityscapes_1.pth", "checkpoint.pth", "hyperparams.txt"):
            if not os.path.exists(os.path.join(out, name)):
                _fail(f"the training CLI wrote no {name}")
        print(f"CLI training, one epoch of {n_images // 2} steps and validation: {secs:.1f} s, "
              f"launches {launches}")
        first = torch.load(os.path.join(out, "model_cityscapes_1.pth"), map_location=dev,
                           weights_only=True)["params"]
        _, launches, secs = run(cli, "--epochs", "2", "--resume",
                                os.path.join(out, "checkpoint.pth"))
        state = torch.load(os.path.join(out, "checkpoint.pth"), map_location=dev,
                           weights_only=True)
        moved = not torch.equal(first["rpn_head"]["shared_conv"]["w"],
                                state["params"]["rpn_head"]["shared_conv"]["w"])
        print(f"CLI --resume to epoch 2: {secs:.1f} s; checkpoint epoch {state['epoch']}, the "
              f"RPN head's weights moved from epoch 1's {moved}; launches {launches}")
        if state["epoch"] != 2 or not moved or launches["rpn_head_bwd"] != 5 * (n_images // 2):
            _fail("the training CLI did not resume for a second epoch of training steps")
        stats, launches, secs = run(cli, "--test-only", "--load-model",
                                    os.path.join(out, "model_cityscapes_1.pth"))
        batches = -(-n_images // 2)
        per_batch = {"rpn_head": 5, "roi_align": 1, "encoder_fc6": 1, "box_tail": 1,
                     "fpn_level": 4, "stem": 1}
        want = {k: batches * per_batch.get(k, 0) for k in cb.KERNELS}
        print(f"CLI --test-only --load-model: {n_images / secs:.3f} images/s with loading and "
              f"the evaluator ({secs:.1f} s, host clock); launches {launches}, per batch "
              f"{ {k: v // batches for k, v in launches.items() if v} }; stats "
              f"{[round(float(x), 4) for x in stats]}")
        if launches != want:
            _fail(f"the CLI evaluation's launches are not {want}")
        if len(stats) != 12 or not np.isfinite(stats).all():
            _fail("the CLI evaluation did not give 12 finite stats")
        _, launches, secs = run(cli, "-ext-prop-det", "test", "-n-img", str(n_images))
        dump = list(np.load(os.path.join(out, "test_results_per_img_cityscapes.npz"),
                            allow_pickle=True)["results"])
        keys = {"image_id", "boxes", "labels", "scores", "all_scores", "all_boxes",
                "proposals", "objectness"}
        print(f"CLI -ext-prop-det: {len(dump)} images in {secs:.1f} s; keys {sorted(dump[0])}")
        if len(dump) != n_images or set(dump[0]) != keys:
            _fail("the NOD dump is not one entry per image with the JAX CLI's keys")
        _, launches, secs = run(cli, "--extract-spike-rates", "val")
        rates = np.load(os.path.join(out, "spike_rates_val_cityscapes.npz"))
        print(f"CLI --extract-spike-rates: {secs:.1f} s; shared per level "
              f"{[round(float(x), 4) for x in rates['shared'].mean(axis=1)]}, fc6 "
              f"{float(rates['fc6'].mean()):.4f}, fc7 {float(rates['fc7'].mean()):.4f}")
        if rates["shared"].shape != (5, n_images) or not np.isfinite(rates["fc6"]).all():
            _fail("the spike rates are not 5 levels x the images")
        for t_det in (8, 12, 40):
            rows, launches, secs = run(sweep, "-o", "metrics", "-r1", "8", "-r2", "8",
                                       "-d1", str(t_det), "-d2", str(t_det))
            box = launches["encoder_fc6"] + launches["box_tail"]
            print(f"CLI T sweep t_det = {t_det}: {rows} in {secs:.1f} s; K3 + K4 launches {box}")
            if len(rows) != 1 or rows[0][:2] != [8, t_det] or (box == 0) != (t_det > 32):
                _fail(f"the T sweep at t_det = {t_det} did not take the route of its steps")

        # The analysis CLIs on the same set: the noise sweeps of the epoch's
        # weights, new-object discovery on the dump, the energy recompute
        # from the rates.
        weights = os.path.join(out, "model_cityscapes_1.pth")
        for kind, extra, points in (
                ("gaussian", ["--gaussian-max", "0.05", "--gaussian-step", "0.05"], [0.0, 0.05]),
                ("rain", ["--rain-noise", "--rain-max", "50", "--rain-step", "50"], [0, 50])):
            rows, launches, secs = run(noise, "--load-model", weights, *extra)
            want = {k: len(points) * batches * per_batch.get(k, 0) for k in cb.KERNELS}
            print(f"CLI noise sweep, {kind}: {rows} in {secs:.1f} s; launches {launches}")
            if [r[:2] for r in rows] != [[kind, p] for p in points] or launches != want \
                    or not np.isfinite([r[2:] for r in rows]).all():
                _fail(f"the {kind} noise sweep did not give one finite row per point with "
                      f"the evaluation's launches {want}")
        t0 = time.perf_counter()
        found = nod.main(nod.get_args_parser().parse_args(
            ["-d", os.path.join(tmp, "ds.json"), "-f",
             os.path.join(out, "test_results_per_img_cityscapes.npz")]))
        print(f"CLI new-object discovery: {len(found)} images, "
              f"{sum(len(p['new_boxes']) for p in found)} candidate boxes in "
              f"{time.perf_counter() - t0:.2f} s")
        if len(found) != n_images or not os.path.exists(
                os.path.join(out, "new_objects_cityscapes", "params.txt")):
            _fail("new-object discovery did not process the dump")
        report = energy.main(energy.get_args_parser().parse_args(
            ["-f", os.path.join(out, "spike_rates_val_cityscapes.npz"), "-t-rpn", "8",
             "-t-det", "12", "--bucket", "768", "1536"]))
        if not 0 < report["reduction"] < float("inf"):
            _fail("the energy recompute gave no finite reduction")
        # One epoch with bf16 neuron states (--no-amp): the RPN head on K1's
        # and K7's bf16-state instances; the validation loss runs the forward.
        steps = n_images // 2
        _, launches, secs = run(cli, "--epochs", "1", "--no-amp", "--out-dir",
                                os.path.join(tmp, "out16"))
        want = {**{k: 0 for k in cb.KERNELS}, "stem": steps + batches,
                "rpn_head_s16_save": 5 * (steps + batches), "rpn_head_bwd_s16": 5 * steps}
        print(f"CLI --no-amp, one epoch of {steps} steps and validation: {secs:.1f} s, launches "
              f"{launches}")
        if launches != want:
            _fail(f"the --no-amp epoch's launches are not {want}")
    return total


def _write_cli_set(tmp, n_images, image_hw):
    """A seeded COCO-format set in ``tmp`` that the CLIs read without OpenCV
    or PyYAML: :func:`synthetic_coco`'s images as ``.npy``
    files, its annotations and the dataset config (``ds.json``) as JSON.
    Returns the output directory the config names."""
    import json
    import os

    coco, pixels = synthetic_coco(n_images, image_hw, 8, seed=13)
    write_images(tmp, coco, pixels)
    with open(os.path.join(tmp, "ann.json"), "w") as f:
        json.dump(coco, f)
    out = os.path.join(tmp, "out")
    with open(os.path.join(tmp, "ds.json"), "w") as f:
        json.dump({"dataset": "cityscapes", "images_dir": tmp,
                   "ann_file_train": os.path.join(tmp, "ann.json"),
                   "ann_file_val": os.path.join(tmp, "ann.json"), "out_dir": out,
                   "num_classes": 9,
                   "classes": {str(c): f"class{c}" for c in range(9)}}, f)
    return out


def _smi():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def synthetic_coco(n_images, hw, n_classes, seed):
    """A COCO dict of ``n_images`` seeded uint8 RGB images of ``hw`` (file
    names ``<id>.npy``) with 2-6 seeded boxes each over classes
    1..n_classes, and the images' pixels by id. The port's benchmark
    (``bench_torch``) makes its dataset pass's images with it too."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    images, anns, pixels = [], [], {}
    for i in range(1, n_images + 1):
        pixels[i] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        images.append({"id": i, "file_name": f"{i}.npy", "height": h, "width": w})
        for _ in range(int(rng.integers(2, 7))):
            bw, bh = float(rng.uniform(16, w / 4)), float(rng.uniform(16, h / 4))
            x, y = float(rng.uniform(0, w - bw)), float(rng.uniform(0, h - bh))
            anns.append({"id": len(anns) + 1, "image_id": i, "bbox": [x, y, bw, bh],
                         "category_id": int(rng.integers(1, n_classes + 1)),
                         "area": bw * bh, "iscrowd": 0})
    cats = [{"id": c, "name": f"class{c}"} for c in range(1, n_classes + 1)]
    return {"images": images, "annotations": anns, "categories": cats}, pixels


def write_images(directory, coco, pixels):
    """Each image of ``coco`` as the ``.npy`` file it names in ``directory``."""
    import os

    import numpy as np

    for img in coco["images"]:
        np.save(os.path.join(directory, img["file_name"]), pixels[img["id"]])


def _detections_equal(a, b):
    import torch

    return all(torch.equal(a[k], b[k]) for k in a)


def dataset_eval_path(dev, n_images=8, image_hw=(1024, 2048), batch_size=2, workers=4):
    """A COCO-format dataset evaluated on the card through the port's host
    side: 8 seeded uint8 images at Cityscapes' size (1024 x 2048) with 2-6
    seeded boxes each over 8 classes, indexed by the port's ``CocoIndex``
    from an in-memory COCO dict and served by a ``CocoDataset`` whose
    ``load_image`` returns the arrays; the port's ``DetectionLoader`` (batch
    2, bucket 768 x 1536, a 0.75x resize, 4 workers), ``to_device_batch``,
    the flagship ``detector_apply`` evaluation (bf16, seed-0 weights, rates
    off) and the port's ``CocoEvaluator``. Checks: per batch the rates-off
    launches (K6 x1, K5 x4, K1 x5, K2, K3, K4 x1) and no plain version on
    the GPU; the first batch's detections equal, bit for bit, to those of
    the same batch built without the loader; the GT boxes fed back as
    detections (score 1) give AP@[.5:.95] = 1.0; params, AdamW state and
    scheduler saved with ``save_checkpoint`` and loaded with
    ``map_location=dev`` (``cuda:0``) give the same detections; the 12 stats
    finite.
    Prints images/s with loading (host clock), one profiled loader batch's
    host synchronisations and the stats. Returns the launches."""
    import os
    import tempfile

    import numpy as np
    import torch

    from snn_automotive_object_detection_tpu_torch.data.coco import (
        CocoDataset, target_from_annotations)
    from snn_automotive_object_detection_tpu_torch.data.loader import (
        DetectionLoader, resize_bilinear, resize_image_and_target, to_device_batch)
    from snn_automotive_object_detection_tpu_torch.evaluation import CocoEvaluator
    from snn_automotive_object_detection_tpu_torch.evaluation._native import native_available
    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.models.transform import resize_shape
    from snn_automotive_object_detection_tpu_torch.train.optim import (
        build_optimizer, build_schedule)
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)
    from snn_automotive_object_detection_tpu_torch.utils.weights import tree_leaves

    cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12)
    coco, pixels = synthetic_coco(n_images, image_hw, cfg.num_classes - 1, seed=11)

    class InMemory(CocoDataset):
        def load_image(self, image_id):
            return pixels[image_id]

    ds = InMemory(images_dir="", ann_file=coco)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    loader = DetectionLoader(ds, batch_size, cfg.bucket, min_size=cfg.min_size,
                             max_size=cfg.max_size, with_targets=False, num_workers=workers)
    keys = ("boxes", "scores", "labels", "valid")

    def evaluate(p, db):
        return detector_apply(p, db, cfg, collect_rates=False)[0]

    host_batches = list(loader)          # warm-up: the loader and one detector call
    evaluate(params, to_device_batch(host_batches[0], dev))
    torch.cuda.synchronize()

    evaluator = CocoEvaluator(ds)
    cb.reset_counts()
    t0 = time.perf_counter()
    first = None
    n_batches = 0
    for batch in loader:
        out = evaluate(params, to_device_batch(batch, dev))
        first = first or (batch, {k: out[k] for k in keys})
        evaluator.update({int(batch["image_ids"][i]): {k: out[k][i] for k in keys}
                          for i in range(batch_size) if batch["pad_mask"][i]})
        n_batches += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain_calls = dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS)
    per_batch = {"rpn_head": 5, "roi_align": 1, "encoder_fc6": 1, "box_tail": 1,
                 "fpn_level": 4, "stem": 1}
    want = {k: per_batch.get(k, 0) * n_batches for k in launches}
    print(f"dataset_eval: {n_images} images of {image_hw[0]} x {image_hw[1]} in {n_batches} "
          f"batches of {batch_size} (bucket {cfg.bucket}, {workers} workers): launches "
          f"{launches}; plain versions on the GPU {plain_calls}")
    if launches != want:
        _fail(f"dataset_eval: the launches are not {want}")
    if any(v != 0 for v in plain_calls.values()):
        _fail("dataset_eval: a plain version ran on the GPU")

    # The first batch built without the loader: the same images, resized and
    # padded here, as tensors made on the card.
    batch, got = first
    ids = [int(i) for i in batch["image_ids"]]
    hb, wb = cfg.bucket
    imgs, sizes = [], []
    for i in ids:
        img, _, (nh, nw) = resize_image_and_target(ds.load_image(i), None, cfg.min_size,
                                                   cfg.max_size)
        padded = np.zeros((hb, wb, 3), np.float32)
        padded[:nh, :nw] = img
        imgs.append(padded)
        sizes.append((nh, nw))
    direct = {"images": torch.tensor(np.stack(imgs), device=dev),
              "image_sizes": torch.tensor(sizes, dtype=torch.int32, device=dev),
              "original_sizes": torch.tensor([pixels[i].shape[:2] for i in ids],
                                             dtype=torch.int32, device=dev)}
    same_direct = _detections_equal(got, {k: v for k, v in evaluate(params, direct).items()
                                          if k in keys})

    # The ground truth fed back as detections.
    gt_eval = CocoEvaluator(ds)
    for i in ds.ids:
        t = target_from_annotations(ds.index.img_to_anns[i], *pixels[i].shape[:2], i)
        gt_eval.update({i: {"boxes": t["boxes"], "scores": np.ones(len(t["boxes"])),
                            "labels": t["labels"]}})
    gt_eval.accumulate()
    gt_stats = gt_eval.summarize(verbose=False)

    # Params, AdamW state and the scheduler through a checkpoint. The rate
    # is 0 (so the step leaves the weights as they are) and the gradients
    # seeded, so that the optimizer holds state.
    head = {"box_head": params["box_head"]}
    opt, sched = build_optimizer(head, "AdamW", build_schedule(0.0, 1, milestones=(1,)))
    g = torch.Generator(device=dev).manual_seed(2)
    before = [leaf.clone() for leaf in tree_leaves(head)]
    for leaf in tree_leaves(head):
        leaf.grad = torch.randn(leaf.shape, generator=g, device=dev) * 1e-3
    opt.step()
    sched.step()
    unmoved = all(torch.equal(a, b) for a, b in zip(before, tree_leaves(head)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.pth")
        save_checkpoint(path, {"params": params, "optimizer": opt, "scheduler": sched,
                               "epoch": 0}, args={"t_det": cfg.t_det})
        ckpt = load_checkpoint(path, map_location=dev)
    params2 = ckpt["params"]
    opt2, sched2 = build_optimizer({"box_head": params2["box_head"]}, "AdamW",
                                   build_schedule(0.0, 1, milestones=(1,)))
    opt2.load_state_dict(ckpt["optimizer"])
    sched2.load_state_dict(ckpt["scheduler"])
    state_same = all(
        torch.equal(opt.state[a]["exp_avg_sq"], opt2.state[b]["exp_avg_sq"])
        for a, b in zip(tree_leaves(head), tree_leaves({"box_head": params2["box_head"]})))
    on_card = all(leaf.device == dev for leaf in tree_leaves(params2))
    same_ckpt = _detections_equal(got, {k: v for k, v in evaluate(
        params2, to_device_batch(batch, dev)).items() if k in keys})

    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    stats = evaluator.summarize(verbose=False)
    syncs = _profile(lambda: evaluate(params, to_device_batch(host_batches[0], dev)),
                     "loader batch (to_device_batch + detector_apply)")

    # Where the loop's time goes, on the host's clock. The loop above is
    # cold: its 8 resizes start at once on the workers, so it times the
    # loader's fill. Here, the numpy resize of one image alone (the main
    # thread, nothing else running); one loaded batch's copies and detector
    # call; and a loop of 4x the images (the same pixels cycled) timed from
    # the first batch's arrival, past the fill.
    img = pixels[1].astype(np.float32) / 255.0
    nh, nw = resize_shape(image_hw, cfg.min_size, cfg.max_size)
    resize_s, detect_s = [], []
    for _ in range(3):
        t = time.perf_counter()
        resize_bilinear(img, nh, nw)
        resize_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        evaluate(params, to_device_batch(host_batches[0], dev))
        torch.cuda.synchronize()
        detect_s.append(time.perf_counter() - t)
    n_stream = 4 * n_images
    stream = {"images": [{**coco["images"][0], "id": i} for i in range(1, n_stream + 1)],
              "annotations": [], "categories": coco["categories"]}

    class Cycled(CocoDataset):
        def load_image(self, image_id):
            return pixels[(image_id - 1) % n_images + 1]

    batches = iter(DetectionLoader(Cycled(images_dir="", ann_file=stream), batch_size,
                                   cfg.bucket, min_size=cfg.min_size, max_size=cfg.max_size,
                                   with_targets=False, num_workers=workers))
    evaluate(params, to_device_batch(next(batches), dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_steady = 0
    for batch in batches:
        evaluate(params, to_device_batch(batch, dev))
        n_steady += batch_size
    torch.cuda.synchronize()
    steady_ips = n_steady / (time.perf_counter() - t0)

    ips = n_images / dt
    print(f"dataset_eval: {_smi()}: cold loop {ips:.3f} images/s with loading (host clock, "
          f"{dt:.3f} s for {n_images} images, the loader's fill included: decode-free uint8 "
          f"arrays, resize, pinned copies, detector, evaluator updates); one loader batch "
          f"{syncs} host synchronisations; native COCO matcher built {native_available()}")
    print(f"dataset_eval: {_smi()}: past the fill {steady_ips:.3f} images/s with loading "
          f"(host clock, {n_steady} images of {n_stream} from the first batch's arrival, "
          f"{workers} workers); alone, the numpy resize {image_hw[0]} x {image_hw[1]} -> "
          f"{nh} x {nw} " + " ".join(f"{x * 1000:.1f}" for x in resize_s) + " ms an image; "
          f"to_device_batch + detector_apply " + " ".join(f"{x * 1000:.1f}" for x in detect_s)
          + f" ms a batch of {batch_size}")
    print(f"dataset_eval: detections of the first batch equal to the batch built without "
          f"the loader {same_direct}; GT as detections AP@[.5:.95] {gt_stats[0]:.4f}; "
          f"checkpoint round trip: weights unmoved by the rate-0 step {unmoved}, AdamW state "
          f"equal {state_same}, params on cuda:0 {on_card}, epoch {ckpt['epoch']}, the same "
          f"detections {same_ckpt}")
    print("dataset_eval: stats " + json.dumps([float(x) for x in stats]))
    if not same_direct:
        _fail("dataset_eval: the loader's batch gives other detections than the same batch "
              "built without it")
    if gt_stats[0] != 1.0:
        _fail(f"dataset_eval: the GT fed back as detections gives AP {gt_stats[0]}, not 1.0")
    if not (unmoved and state_same and on_card and same_ckpt and ckpt["epoch"] == 0):
        _fail("dataset_eval: the checkpoint round trip changed the weights, the optimizer "
              "state or the detections")
    if len(stats) != 12 or not np.isfinite(stats).all():
        _fail(f"dataset_eval: stats not 12 finite numbers: {stats}")
    return launches


def _tree_sums(leaves):
    import torch

    return torch.stack([leaf.detach().double().sum() for leaf in leaves])


def _seeded_train_batch(dev, cfg, g):
    """Two images of ``cfg``'s bucket drawn from ``g``, with 3 and 5 valid
    target boxes inside the image, labels in 1..8, padded to 8 rows per
    image."""
    import torch

    n, (h, w), n_gt = 2, cfg.bucket, 8
    ctr = torch.rand((n, n_gt, 2), generator=g, device=dev) * torch.tensor(
        [w - 400.0, h - 300.0], device=dev) + torch.tensor([200.0, 150.0], device=dev)
    half = torch.rand((n, n_gt, 2), generator=g, device=dev) * torch.tensor(
        [170.0, 120.0], device=dev) + 20.0
    valid = torch.arange(n_gt, device=dev)[None] < torch.tensor([[3], [5]], device=dev)
    return {"images": torch.rand((n, h, w, 3), generator=g, device=dev),
            "image_sizes": torch.tensor([[h, w]] * n, device=dev),
            "original_sizes": torch.tensor([[1024, 2048]] * n, device=dev),
            "targets": {"boxes": torch.cat([ctr - half, ctr + half], dim=-1),
                        "labels": torch.randint(1, 9, (n, n_gt), generator=g, device=dev),
                        "valid": valid}}


def train_path(dev, steps=2, bf16_states=False):
    """The flagship training step, frozen backbone, through make_train_step;
    with ``bf16_states`` the same step with bf16 neuron states
    (``snn_state_dtype=None``, the reference's --no-amp), whose RPN head is
    K1's and K7's bf16-state instances."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.train import optim
    from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils.weights import (
        flatten_tree, tree_leaves)

    cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12,
                         snn_state_dtype=None if bf16_states else torch.float32)
    what = "training, bf16 states" if bf16_states else "training"
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    trainable, frozen = optim.split_trainable(params)
    optimizer, scheduler = optim.build_optimizer(trainable, "AdamW", 0.0025)
    step = make_train_step(cfg, optimizer, scheduler)
    n, (h, w) = 2, cfg.bucket
    g = torch.Generator(device=dev).manual_seed(2)
    batch = _seeded_train_batch(dev, cfg, g)
    t_leaves, f_leaves = tree_leaves(trainable), tree_leaves(frozen)
    t_before, f_before = _tree_sums(t_leaves), _tree_sums(f_leaves)

    first = step(trainable, frozen, batch, g)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cb.reset_counts()
    t0 = time.perf_counter()
    history = [step(trainable, frozen, batch, g) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cb.LAUNCHES)
    plain_calls = dict(cb.PLAIN_CUDA_CALLS)

    print(f"{what}: {steps} steps of {n} x {h} x {w}: launches {launches}, plain "
          f"versions on the GPU {plain_calls}")
    fwd, bwd = ("rpn_head_s16_save", "rpn_head_bwd_s16") if bf16_states else ("rpn_head",
                                                                              "rpn_head_bwd")
    want = {**{k: 0 for k in cb.KERNELS}, "stem": steps, fwd: 5 * steps, bwd: 5 * steps}
    if launches != want:
        _fail(f"the {what} path's launches are not {want}")
    if any(v != 0 for v in plain_calls.values()):
        _fail(f"a plain version ran on the GPU in the {what} path")
    for i, losses in enumerate([first] + history):
        row = {k: round(losses[k].item(), 5) for k in LOSS_NAMES + ("loss_total",)}
        print(f"{what}: step {i} losses {row}")
        if sorted(losses) != sorted(LOSS_NAMES + ("loss_total",)) or not all(
                torch.isfinite(v).all() for v in losses.values()):
            _fail("a training loss is missing or not finite")
    for group in ("rpn_head", "box_head"):
        for name, leaf in flatten_tree(trainable[group]).items():
            gr = leaf.grad
            if gr is None or not torch.isfinite(gr).all() or not (gr != 0).any():
                _fail(f"the gradient of {group}/{name} is missing, not finite or all zero")
            print(f"{what}: max |grad {group}/{name}| {gr.abs().max().item():.4g}")
    if bool((_tree_sums(t_leaves) == t_before).any()):
        _fail("a trainable leaf did not move")
    if not torch.equal(_tree_sums(f_leaves), f_before) or any(
            leaf.grad is not None for leaf in f_leaves):
        _fail("a frozen leaf moved or got a gradient")
    print(f"{what}: {steps / dt:.3f} steps/s, {n * steps / dt:.3f} images/s "
          f"({dt / steps * 1000:.1f} ms per step, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB); {len(t_leaves)} "
          f"trainable leaves moved, {len(f_leaves)} frozen leaves did not")
    _profile(lambda: step(trainable, frozen, batch, g), f"{what} step")
    return launches


# Phase 12 (``dist``). Two ranks share the one card through gloo, which
# stages CUDA tensors through the host (NCCL refuses two ranks on one
# card); NCCL runs in a group of one rank. A batch of one image takes other
# cuDNN kernels in the frozen bf16 body than a batch of two: about 77% of
# the RPN's input features differ by ulps and about 0.45 M encoder spikes
# flip per image (measured on the H100), which moves the box loss by a
# fifth. So each rank's features must equal one process's on its image
# alone bit for bit, and the ranks' losses are held within DIST_LOSS_RTOL
# (relative, each loss) to one process's step on both images whose frozen
# body's output is those same features; the step on both images with its
# own features is printed beside it, with the differing features and the
# flipped spikes. The ranks agree with each other bit for bit.
DIST_LOSS_RTOL = 1e-2
DIST_STEPS = 2


def _dp_setup(dev):
    """The flagship step of the ``dist`` phase from fixed seeds, alike in
    every process: (trainable, frozen, step, the batch of two images, a
    fresh sampler generator)."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.parallel.mesh import replicate
    from snn_automotive_object_detection_tpu_torch.train import optim
    from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step

    cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12)
    params = replicate(init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    trainable, frozen = optim.split_trainable(params)
    optimizer, scheduler = optim.build_optimizer(trainable, "AdamW", 0.0025)
    step = make_train_step(cfg, optimizer, scheduler)
    batch = _seeded_train_batch(dev, cfg, torch.Generator(device=dev).manual_seed(2))
    return trainable, frozen, step, batch, lambda: torch.Generator(device=dev).manual_seed(3)


def _rows(batch, rows):
    return {k: ({kk: vv[rows] for kk, vv in v.items()} if isinstance(v, dict) else v[rows])
            for k, v in batch.items()}


def _with_rpn_features(run):
    """(``run()``, the RPN's input features in it, detached copies)."""
    from snn_automotive_object_detection_tpu_torch.models import rpn as rpn_mod

    real, got = rpn_mod.rpn_forward, []

    def spy(head_apply, features, *args, **kw):
        got.append([f.detach().clone() for f in features])
        return real(head_apply, features, *args, **kw)

    rpn_mod.rpn_forward = spy
    try:
        out = run()
    finally:
        rpn_mod.rpn_forward = real
    return out, got[0]


def _profile_dp(run, what):
    """Device time of ``run()`` and its all-reduce: the host-side
    collective ops (``gloo:all_reduce`` / ``nccl:all_reduce``) and NCCL's
    device kernels, by count and time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us, nccl, host = 0.0, [0, 0.0], [0, 0.0]
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            device_us += us
            if "nccl" in e.key.lower():
                nccl = [nccl[0] + e.count, nccl[1] + us / 1e3]
        elif e.key.endswith(":all_reduce"):
            host = [host[0] + e.count, host[1] + e.cpu_time_total / 1e3]
    out = dict(wall_ms=wall_ms, device_ms=device_us / 1e3, allreduce_ops=host[0],
               allreduce_host_ms=host[1], nccl_kernels=nccl[0], nccl_kernel_ms=nccl[1])
    print(f"{what}: profiled step {wall_ms:.3f} ms wall, {out['device_ms']:.3f} ms of device "
          f"time; {host[0]} all-reduce ops, {host[1]:.3f} ms host time in them; {nccl[0]} "
          f"NCCL device kernels, {nccl[1]:.3f} ms")
    return out


def _dp_rank_step(dev, rank, tmp):
    """One rank of the two-rank step: the compared step, then DIST_STEPS
    timed ones and a profiled one; writes what the parent checks."""
    import torch

    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils.weights import flatten_tree

    trainable, frozen, step, batch, gen = _dp_setup(dev)
    mine = _rows(batch, slice(rank, rank + 1))
    losses, feats = _with_rpn_features(lambda: step(trainable, frozen, mine, gen()))
    leaves = {k: v.detach().cpu() for k, v in flatten_tree(trainable).items()}
    g = gen()
    step(trainable, frozen, mine, g)      # warm-up
    torch.cuda.synchronize()
    cb.reset_counts()
    t0 = time.perf_counter()
    for _ in range(DIST_STEPS):
        step(trainable, frozen, mine, g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain = dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS)
    prof = _profile_dp(lambda: step(trainable, frozen, mine, g), f"dist rank {rank} (gloo)")
    print(f"dist rank {rank}: {DIST_STEPS / dt:.3f} steps/s with the other rank on the same "
          f"card ({dt / DIST_STEPS * 1e3:.1f} ms a step, host clock)")
    torch.save({"losses": {k: float(v) for k, v in losses.items()}, "leaves": leaves,
                "feats": [f.cpu() for f in feats], "launches": launches, "plain": plain,
                "steps_per_s": DIST_STEPS / dt, "profile": prof},
               os.path.join(tmp, f"step_rank{rank}.pt"))


def _dp_rank_test_only(dev, rank, tmp):
    """One rank of ``cli/train.py --test-only``: its stats and launches."""
    import torch

    from snn_automotive_object_detection_tpu_torch.cli import train as cli
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    with open(os.path.join(tmp, "argv.json")) as f:
        argv = json.load(f)
    cb.reset_counts()
    stats = cli.main(cli.get_args_parser().parse_args(argv))
    torch.cuda.synchronize()
    torch.save({"stats": stats, "launches": dict(cb.LAUNCHES),
                "plain": dict(cb.PLAIN_CUDA_CALLS)}, os.path.join(tmp, f"eval_rank{rank}.pt"))


def _dist_rank(mode, tmp):
    """A rank of the ``dist`` phase (``python3 -m chip_smoke --dist-rank
    <mode> <dir>``, the rank in the environment): gloo on the card."""
    import torch

    from snn_automotive_object_detection_tpu_torch.parallel.collectives import parallel_world
    from snn_automotive_object_detection_tpu_torch.parallel.mesh import (
        init_distributed, rank_device)

    reference_numerics()
    if not init_distributed("cuda", backend="gloo"):
        _fail("dist: no process group from the environment")
    rank, _ = parallel_world()
    dev = rank_device("cuda")
    print(f"dist rank {rank}: backend {torch.distributed.get_backend()}, device {dev}")
    {"step": _dp_rank_step, "test_only": _dp_rank_test_only}[mode](dev, rank, tmp)
    torch.distributed.destroy_process_group()
    print(f"[rank {rank}] ALL OK")
    return 0


def _spawn_ranks(mode, tmp):
    """Two ranks of ``mode`` on this card (both local rank 0), gloo."""
    from snn_automotive_object_detection_tpu_torch.parallel.dryrun import run_ranks

    t0 = time.perf_counter()
    outs = run_ranks("chip_smoke", 2, ["--dist-rank", mode, tmp], timeout=600,
                     env_extra={"LOCAL_RANK": "0"})
    for rank, out in enumerate(outs):
        for line in out.strip().splitlines():
            if line.startswith("dist rank") or "profile" in line:
                print(f"  {line}")
        if f"[rank {rank}] ALL OK" not in out:
            _fail(f"dist: rank {rank} did not finish:\n{out[-3000:]}")
    print(f"dist: two ranks of {mode} in {time.perf_counter() - t0:.1f} s")


def _with_body_output(feats, run):
    """``run()`` with the frozen ResNet body's output (the FPN levels of
    the bf16 training route) replaced by ``feats``; the stem still runs."""
    from snn_automotive_object_detection_tpu_torch.models import detector

    real = detector.resnet50_fpn_apply_from_p1
    detector.resnet50_fpn_apply_from_p1 = lambda *args, **kw: feats
    try:
        return run()
    finally:
        detector.resnet50_fpn_apply_from_p1 = real


def _encoder_flips(a, b, t_rpn):
    """Encoder spikes that differ between two feature maps over ``t_rpn``
    steps (the closed-form periods)."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import functional as snnf

    pa, pb = snnf.encoder_periods(a.float()), snnf.encoder_periods(b.float())
    return sum(int((snnf.encoder_spikes_at(pa, t) != snnf.encoder_spikes_at(pb, t)).sum())
               for t in range(t_rpn)) if not torch.equal(pa, pb) else 0


def dist_path(dev):
    """Phase 12: (i) the flagship step on two gloo ranks of one image each
    on this card against one process on both images; (ii) the same step in
    a one-rank NCCL group against the step without a group; (iii)
    ``cli/train.py --test-only`` on two gloo ranks of ``-b 1`` against one
    process. Returns the launches of all processes."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from snn_automotive_object_detection_tpu_torch.cli import train as cli
    from snn_automotive_object_detection_tpu_torch.parallel.dryrun import free_port
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils.weights import flatten_tree

    total = {k: 0 for k in cb.KERNELS}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # (i) one process on both images, then two gloo ranks of one each.
    trainable, frozen, step, batch, gen = _dp_setup(dev)
    cb.reset_counts()
    own, feats = _with_rpn_features(lambda: step(trainable, frozen, batch, gen()))
    add(cb.LAUNCHES)
    ref_leaves = {k: v.detach().clone() for k, v in flatten_tree(trainable).items()}
    own = {k: float(v) for k, v in own.items()}
    with tempfile.TemporaryDirectory() as tmp:
        _spawn_ranks("step", tmp)
        ranks = [torch.load(os.path.join(tmp, f"step_rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    print(f"dist (i): backend gloo, two ranks on {torch.cuda.get_device_name(0)} "
          f"({_smi()}), one image each")
    same_losses = ranks[0]["losses"] == ranks[1]["losses"]
    same_leaves = all(torch.equal(ranks[0]["leaves"][k], ranks[1]["leaves"][k])
                      for k in ranks[0]["leaves"])
    print(f"dist (i): ranks bit-equal: losses {same_losses}, updated leaves {same_leaves} "
          f"({len(ranks[0]['leaves'])} leaves)")
    if not (same_losses and same_leaves):
        _fail("dist: the two ranks' losses or updated leaves differ")
    cb.reset_counts()
    for r, rk in enumerate(ranks):
        trainable, frozen, step, batch, gen = _dp_setup(dev)
        _, alone = _with_rpn_features(lambda: step(trainable, frozen,
                                                   _rows(batch, slice(r, r + 1)), gen()))
        same = all(torch.equal(a, b.to(dev)) for a, b in zip(alone, rk["feats"]))
        diff = [int((a != b[r:r + 1].cpu()).sum()) for a, b in zip(rk["feats"], feats)]
        flips = [_encoder_flips(a.to(dev), b[r:r + 1], 8) for a, b in zip(rk["feats"], feats)]
        print(f"dist (i): rank {r}'s RPN features equal one process's on image {r} alone: "
              f"{same}; against row {r} of one process's batch of two: elements differing "
              f"per level {diff}, flipped encoder spikes per level {flips}")
        if not same:
            _fail(f"dist: rank {r}'s features are not one process's on its image alone")
    shared = [torch.cat([a, b]).to(dev) for a, b in zip(ranks[0]["feats"], ranks[1]["feats"])]
    trainable, frozen, step, batch, gen = _dp_setup(dev)
    want = _with_body_output(shared, lambda: step(trainable, frozen, batch, gen()))
    add(cb.LAUNCHES)
    worst = 0.0
    for k in LOSS_NAMES + ("loss_total",):
        got, w = ranks[0]["losses"][k], float(want[k])
        rel = abs(got - w) / abs(w)
        worst = max(worst, rel)
        print(f"dist (i): {k} two ranks {got:.7f}, one process on both images with the "
              f"ranks' features {w:.7f}, relative difference {rel:.3g} (tolerance "
              f"{DIST_LOSS_RTOL}); with its own features {own[k]:.7f} "
              f"({abs(got - own[k]) / abs(own[k]):.3g})")
    if not worst <= DIST_LOSS_RTOL:
        _fail(f"dist: the ranks' losses are {worst:.3g} from one process's (relative)")
    per_step = {**{k: 0 for k in cb.KERNELS}, "stem": 1, "rpn_head": 5, "rpn_head_bwd": 5}
    for r, rk in enumerate(ranks):
        got = {k: v // DIST_STEPS for k, v in rk["launches"].items()}
        print(f"dist (i): rank {r} launches per step {got}; {rk['steps_per_s']:.3f} steps/s, "
              f"{rk['profile']['device_ms']:.3f} ms of device time a step, all-reduce "
              f"{rk['profile']['allreduce_host_ms']:.3f} ms host time in "
              f"{rk['profile']['allreduce_ops']} ops (two ranks share the card: not a "
              f"one-card figure)")
        if rk["launches"] != {k: DIST_STEPS * v for k, v in per_step.items()} or any(
                rk["plain"].values()):
            _fail(f"dist: rank {r}'s launches are not {per_step} a step, or a plain version "
                  f"ran on the card")
        add(rk["launches"])

    # (ii) a one-rank NCCL group: the same step's bits, NCCL in the profile.
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        print(f"dist (ii): backend {dist.get_backend()}, world size {dist.get_world_size()}")
        trainable, frozen, step, batch, gen = _dp_setup(dev)
        cb.reset_counts()
        got = {k: float(v) for k, v in step(trainable, frozen, batch, gen()).items()}
        same = all(torch.equal(v, ref_leaves[k]) for k, v in flatten_tree(trainable).items())
        print(f"dist (ii): updated leaves equal to the step's without a group: {same}; losses "
              f"equal: {got == own}")
        if not (same and got == own):
            _fail("dist: the one-rank NCCL step changed the step's bits")
        g = gen()
        step(trainable, frozen, batch, g)
        prof = _profile_dp(lambda: [step(trainable, frozen, batch, g)
                                    for _ in range(DIST_STEPS)], "dist (ii) NCCL")
        add(cb.LAUNCHES)
        # Each step sums two loss counts, the gradients and the losses.
        if prof["allreduce_ops"] != 4 * DIST_STEPS:
            _fail(f"dist: {prof['allreduce_ops']} NCCL all-reduce ops in {DIST_STEPS} steps, "
                  f"not {4 * DIST_STEPS}")
    finally:
        dist.destroy_process_group()

    # (iii) the evaluation CLI on two gloo ranks of -b 1 against one process.
    with tempfile.TemporaryDirectory() as tmp:
        _write_cli_set(tmp, 3, (768, 1536))
        argv = ["-d", os.path.join(tmp, "ds.json"), "--rpn-snn", "--detector-snn", "-t-rpn",
                "8", "-t-det", "12", "-b", "1", "-j", "2", "--print-freq", "1", "--test-only"]
        with open(os.path.join(tmp, "argv.json"), "w") as f:
            json.dump(argv, f)
        cb.reset_counts()
        one = np.asarray(cli.main(cli.get_args_parser().parse_args(argv)))
        add(cb.LAUNCHES)
        _spawn_ranks("test_only", tmp)
        ranks = [torch.load(os.path.join(tmp, f"eval_rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    per_batch = {"rpn_head": 5, "roi_align": 1, "encoder_fc6": 1, "box_tail": 1,
                 "fpn_level": 4, "stem": 1}
    want = {k: 2 * per_batch.get(k, 0) for k in cb.KERNELS}   # 2 of 3 images a rank
    for r, rk in enumerate(ranks):
        same = np.array_equal(np.asarray(rk["stats"]), one)
        print(f"dist (iii): backend gloo, rank {r} of 2, -b 1: stats equal to one process's "
              f"{same}; launches {rk['launches']}")
        if not same or rk["launches"] != want or any(rk["plain"].values()):
            _fail(f"dist: rank {r}'s --test-only stats differ from one process's or its "
                  f"launches are not {want}")
        add(rk["launches"])
    print(f"dist (iii): stats {[round(float(x), 4) for x in one]}")
    return total


def bench_weights_path(dev, steps=700, eval_images=8):
    """Phase 13: the port's ``tools/make_bench_weights.py`` at the flagship
    configuration for ``steps`` AdamW steps on fresh shape-set batches,
    then its held-out evaluation: launches per step (K6 x1, K1's training
    instance x5, K7 x5) and per evaluation batch (rates off), 12 finite
    stats, the ``.pth`` read back by ``--eval-only --load`` giving the same
    stats; prints the held-out mAP, the foreground detections and whether
    the postprocess took its full NMS branch."""
    import tempfile

    import numpy as np
    import torch

    from snn_automotive_object_detection_tpu_torch.ops import nms as nms_ops
    from snn_automotive_object_detection_tpu_torch.tools import make_bench_weights as mbw
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    batches = -(-eval_images // 2)
    real_step, real_pruned = mbw.make_eval_step, nms_ops.nms_mask_pruned
    fg, pruned = [], []

    def counting_step(config, collect_rates=False):
        run = real_step(config, collect_rates)

        def step(params, batch):
            det = run(params, batch)
            fg.append(int((det["valid"] & (det["labels"] > 0)).sum()))
            return det
        return step

    def counting_pruned(*args, **kw):
        pruned.append(1)
        return real_pruned(*args, **kw)

    total = {k: 0 for k in cb.KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bench_weights.pth")
        argv = ["--out", out, "--steps", str(steps), "--opt", "adamw", "--lr", "1e-3",
                "--eval-images", str(eval_images), "--save-every", str(steps // 2),
                "--device", str(dev)]
        mbw.make_eval_step, nms_ops.nms_mask_pruned = counting_step, counting_pruned
        try:
            cb.reset_counts()
            t0 = time.perf_counter()
            stats, cls_ap, _ = mbw.main(mbw.get_args_parser().parse_args(argv))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            mbw.make_eval_step, nms_ops.nms_mask_pruned = real_step, real_pruned
        launches = dict(cb.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        partial_left = os.path.exists(out + ".partial")
        cb.reset_counts()
        again, _, _ = mbw.main(mbw.get_args_parser().parse_args(
            argv + ["--eval-only", "--load", out]))
        for k, v in cb.LAUNCHES.items():
            total[k] += v
        eval_launches = dict(cb.LAUNCHES)
    per_batch = {"rpn_head": 5, "roi_align": 1, "encoder_fc6": 1, "box_tail": 1,
                 "fpn_level": 4, "stem": 1}
    want_eval = {k: batches * per_batch.get(k, 0) for k in cb.KERNELS}
    want = {k: v + {"stem": steps, "rpn_head": 5 * steps, "rpn_head_bwd": 5 * steps}.get(k, 0)
            for k, v in want_eval.items()}
    print(f"bench_weights: {steps} steps of 2 x 768 x 1536 and {eval_images} held-out images "
          f"in {secs:.1f} s ({_smi()}); launches {launches}")
    print(f"bench_weights: held-out mAP@[.5:.95] {stats[0]:.4f}, AP50 {stats[1]:.4f}, per "
          f"class {cls_ap}; {sum(fg)} foreground detections in {len(fg)} batches; the full "
          f"NMS branch ran in {len(fg) - len(pruned)} of {len(fg)} batches")
    if launches != want or any(cb.PLAIN_CUDA_CALLS.values()):
        _fail(f"bench_weights: launches are not {want}, or a plain version ran on the card")
    if eval_launches != want_eval:
        _fail(f"bench_weights: the --eval-only launches are not {want_eval}")
    if len(stats) != 12 or not np.isfinite(stats).all() or partial_left:
        _fail("bench_weights: no 12 finite stats, or the .partial file was left")
    if not np.array_equal(np.asarray(again), np.asarray(stats)):
        _fail("bench_weights: the .pth read back gave other held-out stats")
    return total


# Phase 14 (``joint``): the configurations of the joint phase, each with
# the launches of one of its steps: the stem kernel while the stem is
# frozen, nothing else (the RPN head is the scan, the FPN unfused).
JOINT_RUNS = (("N = 3", dict(trainable_backbone_layers=3), {"stem": 1}),
              ("N = 5", dict(train_backbone=True), {}))


def joint_path(dev, steps=2):
    """Phase 14: the flagship training step with trainable backbone stages
    (torchvision's default N = 3, then ``train_backbone``, N = 5) through
    make_train_step (AdamW) on the seeded batch of ``train_path``: one
    warm-up step and ``steps`` timed ones each. Exact launches, finite
    losses, every trainable leaf moved (each trained ResNet stage, the FPN,
    for N = 5 the stem), every frozen leaf bit-equal without a gradient;
    steps/s, peak memory and one profiled step."""
    import dataclasses

    import torch

    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.train import optim
    from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils.weights import flatten_tree

    base = DetectorConfig(num_classes=9, t_rpn=8, t_det=12)
    total = {k: 0 for k in cb.KERNELS}
    for label, overrides, per_step in JOINT_RUNS:
        cfg = dataclasses.replace(base, **overrides)
        what = f"joint training, {label}"
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        trainable, frozen = optim.split_trainable(
            params, train_backbone=cfg.train_backbone,
            trainable_backbone_layers=cfg.trainable_backbone_layers)
        optimizer, scheduler = optim.build_optimizer(trainable, "AdamW", 1e-4)
        step = make_train_step(cfg, optimizer, scheduler)
        g = torch.Generator(device=dev).manual_seed(2)
        batch = _seeded_train_batch(dev, cfg, g)
        t_leaves, f_leaves = flatten_tree(trainable), flatten_tree(frozen)
        t_before = {k: v.detach().clone() for k, v in t_leaves.items()}
        f_before = {k: v.detach().clone() for k, v in f_leaves.items()}

        torch.cuda.reset_peak_memory_stats(dev)
        cb.reset_counts()
        first = step(trainable, frozen, batch, g)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = [step(trainable, frozen, batch, g) for _ in range(steps)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(cb.LAUNCHES)
        plain_calls = dict(cb.PLAIN_CUDA_CALLS)
        print(f"{what}: {steps + 1} steps of 2 x 768 x 1536: launches {launches}, plain "
              f"versions on the GPU {plain_calls}")
        want = {k: (steps + 1) * per_step.get(k, 0) for k in cb.KERNELS}
        if launches != want:
            _fail(f"the {what} path's launches are not {want}")
        if any(v != 0 for v in plain_calls.values()):
            _fail(f"a plain version ran on the GPU in the {what} path")
        for i, losses in enumerate([first] + history):
            row = {k: round(losses[k].item(), 5) for k in LOSS_NAMES + ("loss_total",)}
            print(f"{what}: step {i} losses {row}")
            if sorted(losses) != sorted(LOSS_NAMES + ("loss_total",)) or not all(
                    torch.isfinite(v).all() for v in losses.values()):
                _fail(f"{what}: a training loss is missing or not finite")
        unmoved = [k for k, v in t_leaves.items() if torch.equal(v.detach(), t_before[k])]
        if unmoved:
            _fail(f"{what}: {len(unmoved)} trainable leaves did not move, e.g. {unmoved[:3]}")
        moved = [k for k, v in f_leaves.items()
                 if not torch.equal(v, f_before[k]) or v.grad is not None]
        if moved:
            _fail(f"{what}: frozen leaves moved or got a gradient: {moved[:3]}")
        stages = sorted({k.split("/")[0] for k in flatten_tree(trainable["backbone"])})
        print(f"{what}: {steps / dt:.3f} steps/s, {2 * steps / dt:.3f} images/s "
              f"({dt / steps * 1000:.1f} ms per step, peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {_smi()}); "
              f"{len(t_leaves)} trainable leaves moved (backbone {stages}, the FPN, the "
              f"heads), {len(f_leaves)} frozen leaves did not")
        _profile(lambda: step(trainable, frozen, batch, g), f"{what} step")
        for k, v in launches.items():
            total[k] += v
        del params, trainable, frozen, optimizer, step, t_before, f_before
        torch.cuda.empty_cache()
    for k, v in _joint_cli(dev).items():
        total[k] += v
    return total


def _joint_cli(dev, n_images=4):
    """One epoch of ``cli/train.py --trainable-backbone-layers 3`` on the
    seeded set of ``cli_path``: K6 x1 a step and a validation batch, nothing
    else; layer2-4, the FPN and the RPN head moved from the initial
    weights, the stem and layer1 bit-equal."""
    import tempfile

    import torch

    from snn_automotive_object_detection_tpu_torch.cli import train as cli
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import load_checkpoint
    from snn_automotive_object_detection_tpu_torch.utils.weights import flatten_tree

    with tempfile.TemporaryDirectory() as tmp:
        out = _write_cli_set(tmp, n_images, (768, 1536))
        args = cli.get_args_parser().parse_args(
            ["-d", os.path.join(tmp, "ds.json"), "--rpn-snn", "--detector-snn", "-t-rpn", "8",
             "-t-det", "12", "-b", "2", "-j", "2", "--epochs", "1", "--opt", "SGD", "--lr",
             "0.01", "--trainable-backbone-layers", "3", "--device", str(dev)])
        init = {k: v.clone() for k, v in flatten_tree(cli.build_everything(args)[3]).items()}
        cb.reset_counts()
        t0 = time.perf_counter()
        cli.main(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(cb.LAUNCHES)
        saved = flatten_tree(load_checkpoint(os.path.join(out, "model_cityscapes_1.pth"),
                                             map_location=dev)["params"])
    batches = n_images // 2
    want = {k: 2 * batches if k == "stem" else 0 for k in cb.KERNELS}
    print(f"joint CLI, one epoch of {batches} steps and validation with "
          f"--trainable-backbone-layers 3: {secs:.1f} s, launches {launches}")
    if launches != want or any(cb.PLAIN_CUDA_CALLS.values()):
        _fail(f"the joint CLI epoch's launches are not {want}, or a plain version ran")
    for k, v in saved.items():
        top = k.split("/")[1] if k.startswith("backbone/") else k.split("/")[0]
        if top in ("layer2", "layer3", "layer4", "fpn", "rpn_head") and torch.equal(v, init[k]):
            _fail(f"the joint CLI epoch left {k} where it was")
        if top in ("stem", "layer1") and not torch.equal(v, init[k]):
            _fail(f"the joint CLI epoch moved the frozen {k}")
    return launches


def _tee_lines(fn):
    """(fn()'s result, the lines it printed), printed as they come."""
    import contextlib
    import io

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, text):
            buf.write(text)
            return sys.__stdout__.write(text)

        def flush(self):
            sys.__stdout__.flush()

    with contextlib.redirect_stdout(Tee()):
        result = fn()
    return result, buf.getvalue().splitlines()


# Phase 15 (``chain``): the recipe's three phases (snn_automotive_object_
# detection_tpu_torch/scripts/chain_recipe.sh) with their argument lists,
# the steps cut here; the ablation's variants with the launches of one of
# their evaluation batches (rates off).
CHAIN_STEPS = 30
CHAIN_EVAL_IMAGES = 8
# Gains on the reference-layout weights of ``tools/torch_mirror.py`` so that
# every spiking layer fires (its FPN outputs stay under the encoder's
# threshold otherwise). tests/test_torch_recipe_tools.py imports them too.
MIRROR_GAINS = {"backbone.fpn.layer_blocks": 100.0, "rpn.head.shared_conv": 8.0,
                "roi_heads.box_head_and_predictor.fc6": 8.0,
                "roi_heads.box_head_and_predictor.fc7": 8.0,
                "roi_heads.box_head_and_predictor.cls_score": 30.0}


def apply_mirror_gains(sd):
    """``sd`` (a mirror state dict) with ``MIRROR_GAINS`` applied."""
    return {k: v * next((f for key, f in MIRROR_GAINS.items() if k.startswith(key)), 1)
            for k, v in sd.items()}
_EVAL_KERNELS = {"stem": 1, "fpn_level": 4, "rpn_head": 5, "roi_align": 1, "encoder_fc6": 1,
                 "box_tail": 1}
ABLATION_LAUNCHES = {
    "fp32": {},
    "state32": _EVAL_KERNELS,
    "bf16": {"stem": 1, "fpn_level": 4, "rpn_head_s16": 5, "roi_align": 1, "encoder_fc6": 1},
    "bb32_heads_bf16": {"rpn_head_s16": 5, "roi_align": 1, "encoder_fc6": 1},
    "bb16_heads_f32": {"stem": 1, "fpn_level": 4},
}


def _check_ablation_lines(lines, names, n_images):
    """Every line the ablation printed: one JSON line per variant with the
    JAX tool's keys, then the deltas against fp32."""
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    if [r["variant"] for r in rows] != list(names):
        _fail(f"chain: the ablation printed the variants {[r['variant'] for r in rows]}")
    for r in rows:
        if sorted(r) != ["AP50", "AP75", "images", "mAP", "per_class", "variant", "wall_s"] \
                or r["images"] != n_images or len(r["per_class"]) != 5 \
                or not all(-1 <= r[k] <= 1 for k in ("mAP", "AP50", "AP75")):
            _fail(f"chain: a malformed ablation line {r}")
    deltas = lines[lines.index("deltas vs fp32 mAP:") + 1:]
    if [d.split()[0] for d in deltas] != list(names) or any(
            abs(float(d.split()[1]) - (r["mAP"] - rows[0]["mAP"])) > 1e-3
            for d, r in zip(deltas, rows)):
        _fail(f"chain: the ablation's deltas {deltas} do not follow its lines")
    return rows


def _check_parity_report(lines):
    """The parity report: 12 stats with the bf16 - fp32 difference, 7 rate
    means of each mode, the mAP delta line. Returns (stats, rates) by mode."""
    from snn_automotive_object_detection_tpu_torch.tools import parity_vs_reference as pvr

    at = lines.index("================ PARITY REPORT ================")
    if lines[at + 1].split() != ["stat", "fp32", "bf16", "diff"]:
        _fail(f"chain: the parity header is {lines[at + 1]!r}")
    stats = {"fp32": [], "bf16": []}
    for name, line in zip(pvr.STAT_NAMES, lines[at + 2:at + 14]):
        words = line.split()
        if words[0] != name or len(words) != 4:
            _fail(f"chain: the parity row {line!r}")
        a, b, d = (float(w) for w in words[1:])
        if abs((b - a) - d) > 2e-4:
            _fail(f"chain: the parity row {line!r} has a wrong difference")
        stats["fp32"].append(a)
        stats["bf16"].append(b)
    if lines[at + 14] != "" or lines[at + 15].split() != ["spike", "rate", "fp32", "bf16"]:
        _fail("chain: no spike-rate table in the parity report")
    rates = {"fp32": [], "bf16": []}
    for name, line in zip(pvr.RATE_NAMES, lines[at + 16:at + 23]):
        words = line.split()
        if words[0] != name or len(words) != 3 or not all(0 <= float(w) <= 1 for w in words[1:]):
            _fail(f"chain: the rate row {line!r}")
        rates["fp32"].append(float(words[1]))
        rates["bf16"].append(float(words[2]))
    delta = [x for x in lines[at + 23:] if x.startswith("bf16-vs-fp32 mAP delta: ")]
    if len(delta) != 1 or abs(float(delta[0].split()[3]) - (stats["bf16"][0]
                                                           - stats["fp32"][0])) > 2e-4:
        _fail(f"chain: the parity delta line {delta}")
    return stats, rates


def chain_path(dev):
    """Phase 15: the bench recipe through the port's tools at the flagship
    configuration: its three phases through ``make_bench_weights.main``
    with the recipe script's arguments, cut to CHAIN_STEPS steps and
    CHAIN_EVAL_IMAGES held-out images each (phase 1 joint with
    ``--train-backbone``: no launch a step; phases 2 and 3 frozen: K6 x1,
    K1's training instance x5, K7 x5), each loading the one before; then
    ``ablate_bf16`` over 8 held-out images with its five variants (the
    launches of each exact), then ``parity_vs_reference`` on the seeded
    set of ``cli_path`` with a ``.pth`` in the reference's layout
    (``tools/torch_mirror.py``'s detector, plain torch), its four CLI runs'
    launches exact. Every line the two tools print is checked. Prints each
    phase's held-out mAP and foreground detections."""
    import tempfile

    import numpy as np
    import torch

    from snn_automotive_object_detection_tpu_torch.tools import ablate_bf16 as ablate
    from snn_automotive_object_detection_tpu_torch.tools import make_bench_weights as mbw
    from snn_automotive_object_detection_tpu_torch.tools import parity_vs_reference as pvr
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import load_checkpoint
    from snn_automotive_object_detection_tpu_torch.utils.weights import flatten_tree
    from tools.torch_mirror import MirrorDetector

    total = {k: 0 for k in cb.KERNELS}

    def count(launches):
        for k, v in launches.items():
            total[k] += v

    batches = -(-CHAIN_EVAL_IMAGES // 2)
    real_step = mbw.make_eval_step
    fg = []

    def counting_step(config, collect_rates=False):
        run = real_step(config, collect_rates)

        def step(params, batch):
            det = run(params, batch)
            fg.append(int((det["valid"] & (det["labels"] > 0)).sum()))
            return det
        return step

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bench_weights")
        phases = (   # scripts/chain_recipe.sh's phases, the steps cut
            ("p1", ["--out", f"{out}_p1.pth", "--lr", "5e-3", "--train-backbone",
                    "--save-every", "1000"], {}),
            ("p2", ["--out", f"{out}_p2.pth", "--lr", "2e-3", "--load", f"{out}_p1.pth",
                    "--save-every", "1000"],
             {"stem": 1, "rpn_head": 5, "rpn_head_bwd": 5}),
            ("p3", ["--out", f"{out}.pth", "--lr", "1e-3", "--load", f"{out}_p2.pth",
                    "--save-every", "1000"],
             {"stem": 1, "rpn_head": 5, "rpn_head_bwd": 5}))
        before = None
        mbw.make_eval_step = counting_step
        try:
            for name, argv, per_step in phases:
                argv = argv + ["--steps", str(CHAIN_STEPS), "--eval-images",
                               str(CHAIN_EVAL_IMAGES), "--device", str(dev)]
                fg.clear()
                cb.reset_counts()
                t0 = time.perf_counter()
                stats, cls_ap, params = mbw.main(mbw.get_args_parser().parse_args(argv))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = dict(cb.LAUNCHES)
                count(launches)
                want = {k: CHAIN_STEPS * per_step.get(k, 0) + batches * _EVAL_KERNELS.get(k, 0)
                        for k in cb.KERNELS}
                print(f"chain {name}: {CHAIN_STEPS} steps and {CHAIN_EVAL_IMAGES} held-out "
                      f"images in {secs:.1f} s ({_smi()}); launches {launches}; held-out "
                      f"mAP {stats[0]:.4f}, AP50 {stats[1]:.4f}; {sum(fg)} foreground "
                      f"detections in {len(fg)} batches")
                if launches != want or any(cb.PLAIN_CUDA_CALLS.values()):
                    _fail(f"chain {name}: launches are not {want}, or a plain version ran")
                if len(stats) != 12 or not np.isfinite(stats).all():
                    _fail(f"chain {name}: no 12 finite stats")
                saved = flatten_tree(load_checkpoint(argv[1], map_location=dev)["params"])
                if any(not torch.equal(saved[k], v) for k, v in flatten_tree(params).items()):
                    _fail(f"chain {name}: the saved weights are not the trained ones")
                if before is not None and all(torch.equal(before[k], v)
                                              for k, v in flatten_tree(params).items()):
                    _fail(f"chain {name}: the weights did not move from the phase before")
                before = {k: v.detach().clone() for k, v in flatten_tree(params).items()}
                del params
        finally:
            mbw.make_eval_step = real_step

        # The ablation at the trained operating point, its launches per variant.
        by_variant = {}
        real_run = ablate.run_variant

        def counting_run(name, *args):
            cb.reset_counts()
            result = real_run(name, *args)
            by_variant[name] = dict(cb.LAUNCHES)
            return result

        names = tuple(ablate.VARIANTS)
        ablate.run_variant = counting_run
        try:
            _, lines = _tee_lines(lambda: ablate.main(ablate.get_args_parser().parse_args(
                ["--load", f"{out}.pth", "--images", str(CHAIN_EVAL_IMAGES), "--variants",
                 ",".join(names), "--out", os.path.join(tmp, "ablation.jsonl"),
                 "--device", str(dev)])))
        finally:
            ablate.run_variant = real_run
        _check_ablation_lines(lines, names, CHAIN_EVAL_IMAGES)
        for name in names:
            count(by_variant[name])
            want = {k: batches * ABLATION_LAUNCHES[name].get(k, 0) for k in cb.KERNELS}
            if by_variant[name] != want:
                _fail(f"chain: the ablation's {name} launched {by_variant[name]}, not {want}")
        if any(cb.PLAIN_CUDA_CALLS.values()):
            _fail("chain: a plain version ran on the card in the ablation")
        try:
            ablate.make_variant_config(mbw.bench_config(), "bf16_xla")
            _fail("chain: the ablation took a kernels-off variant")
        except ValueError as e:
            print(f"chain: ablate_bf16 refuses bf16_xla: {e}")

        # The parity harness on the CLI set with a reference-layout .pth.
        n_images = 4
        set_dir = os.path.join(tmp, "set")
        os.makedirs(set_dir)
        _write_cli_set(set_dir, n_images, (768, 1536))
        torch.manual_seed(0)
        pth = os.path.join(tmp, "reference.pth")
        sd = apply_mirror_gains(MirrorDetector(num_classes=9, t_rpn=8, t_det=12).state_dict())
        torch.save({"model": sd}, pth)
        real_main = pvr.train_cli.main
        by_run = []

        def counting_main(args):
            cb.reset_counts()
            result = real_main(args)
            by_run.append(dict(cb.LAUNCHES))
            return result

        pvr.train_cli.main = counting_main
        try:
            t0 = time.perf_counter()
            (stats, rates), lines = _tee_lines(lambda: pvr.main(pvr.get_args_parser().parse_args(
                [pth, "-d", os.path.join(set_dir, "ds.json"), "-b", "2", "-j", "2",
                 "--out-dir", os.path.join(tmp, "parity"), "--device", str(dev)])))
            secs = time.perf_counter() - t0
        finally:
            pvr.train_cli.main = real_main
        got_stats, got_rates = _check_parity_report(lines)
        for mode in ("fp32", "bf16"):
            if np.abs(np.asarray(got_stats[mode]) - stats[mode]).max() > 5e-5 \
                    or np.abs(np.asarray(got_rates[mode]) - rates[mode]).max() > 5e-6:
                _fail(f"chain: the parity report's {mode} column is not what the runs gave")
        pb = -(-n_images // 2)
        per_run = {k: pb * v for k, v in _EVAL_KERNELS.items()}   # with rates or without
        want_runs = [{}, {}, per_run, per_run]
        got_runs = [{k: v for k, v in r.items() if v} for r in by_run]
        gap = max(abs(a - b) for a, b in zip(rates["fp32"], rates["bf16"]))
        print(f"chain: parity harness, four CLI runs over {n_images} images in {secs:.1f} s; "
              f"launches {got_runs}; the 7 rate means of bf16 within {gap:.2g} of fp32's "
              f"(fp32 {[round(r, 5) for r in rates['fp32']]})")
        if not min(rates["fp32"]) > 0:
            _fail("chain: a layer of the reference-layout weights did not spike")
        if got_runs != want_runs:
            _fail(f"chain: the parity harness's runs launched {got_runs}, not {want_runs}")
        for r in by_run:
            count(r)
    return total


def bench_path(dev, iters=3):
    """Phase 16: every cell of the port's benchmark (``bench_torch``), each
    checked as ``python -m bench_torch`` checks it (launches of one batch or
    step against the cell's table, no plain version on the card, well-formed
    finite outputs, the float32 route's spike rates and head readouts or
    losses and gradients, the update, the same bits on a second run) and
    timed over one short window of ``iters`` batches or steps, untraced;
    prints each cell's JSON line. Returns the launches of the phase."""
    import torch

    from bench_torch.cells import cell_names, load_cell, run_cell
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    cb.reset_counts()
    for name in cell_names():
        line = run_cell(load_cell(name), dev, seed=0, repeats=1, iters=iters, warmup=1,
                        trace=False)
        print(f"bench: {json.dumps(line)}")
        if not line["correct"]:
            failed = [k for k, c in line["checks"].items() if not c["ok"]]
            _fail(f"bench: the cell {name} is not correct (checks {failed}, "
                  f"failures {line['failures']})")
        torch.cuda.empty_cache()
    return dict(cb.LAUNCHES)


# The functions that evaluation replays as CUDA graphs (``utils/graphs.py``),
# in the order they were graphed: (module of the port, name).
GRAPHED = (("models.roi_heads", "_postproc_outputs"), ("ops.nms", "_pruned_keep"),
           ("ops.nms", "nms_mask"), ("models.roi_heads", "_postproc_groups"),
           ("models.rpn", "filter_proposals"))


@contextlib.contextmanager
def eager_functions(graphed=GRAPHED):
    """The originals (``__wrapped__``) of the graphed functions ``graphed``
    in their modules' place while the block runs, restored after: with all
    five, evaluation launches its box postprocess op by op, as before it was
    graphed. Every caller looks them up in their modules when it calls."""
    mods = [importlib.import_module(f"snn_automotive_object_detection_tpu_torch.{m}")
            for m, _ in graphed]
    saved = [(mod, name, getattr(mod, name)) for mod, (_, name) in zip(mods, graphed)]
    for mod, name, fn in saved:
        setattr(mod, name, fn.__wrapped__)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _host_calls(run):
    """(kernel launches, CUDA graph launches, synchronisations) the host
    made in one ``run()``, from ``torch.profiler``, the closing
    synchronise left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bench_torch.profile import LAUNCH_EVENTS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    host = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    return (sum(n in LAUNCH_EVENTS for n in host),
            sum(n.startswith("cudaGraphLaunch") for n in host),
            sum("Synchronize" in n for n in host) - 1)


def _segment_ms(run, n):
    """Medians over ``run(i)``, i < n, called back to back as the benchmark
    calls them, of the host's ms in each of detector_apply's segments (the
    backbone, the RPN, the RoI heads with the branch test's host sync, the
    outputs) and the device's ms from the end of the previous segment's
    work to the end of this one's: a CUDA event and the host clock at each
    boundary, one synchronise after the last call. A batch's first event
    is reached when the device has finished the batch before. Where the
    device's ms of a segment are about the host's, the host paces the
    device there."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models import detector as detector_mod
    from snn_automotive_object_detection_tpu_torch.models import roi_heads as roi_mod
    from snn_automotive_object_detection_tpu_torch.models import rpn as rpn_mod

    marks = []

    def mark():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((time.perf_counter(), event))

    def marked(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            mark()
            return out
        return call

    saved = [(detector_mod, "backbone_features"), (rpn_mod, "rpn_forward"),
             (roi_mod, "roi_heads_forward")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    for mod, name, fn in saved:
        setattr(mod, name, marked(fn))
    try:
        torch.cuda.synchronize()
        batches = []
        for i in range(n):
            mark()
            run(i)
            mark()
            batches.append(marks[-5:])
        torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    host = [[(b[0] - a[0]) * 1e3 for a, b in zip(m, m[1:])] for m in batches]
    dev = [[a[1].elapsed_time(b[1]) for a, b in zip(m, m[1:])] for m in batches]
    return ([statistics.median(h[k] for h in host) for k in range(4)],
            [statistics.median(d[k] for d in dev) for k in range(4)])


def graphs_path(dev, n_batches=4):
    """Phase 17: evaluation's box postprocess as CUDA graph replays. On the
    flagship with rates on and off, on MobileNet and on the float32 route
    (rates on), ``n_batches`` seeded batches in turn, twice: each turn once
    with the graphed functions' originals patched in (:func:`eager_functions`)
    and once as the port runs. Every output of every batch must be the
    same bits either way, and so must the kernel launches counted a turn.
    Prints the wall ms a batch of both (host clock, the second turns), the
    host's and the device's ms a batch in each of detector_apply's segments
    (:func:`_segment_ms`) both ways and, from one profiled batch each way,
    the host's kernel launches, CUDA graph launches and synchronisations;
    the graphed batch must make at
    least 300 fewer kernel launches. Returns the launches of the graphed
    turns."""
    import torch

    from bench_torch.cells import outputs_equal
    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    routes = (("flagship, rates on", {}, True), ("flagship, rates off", {}, False),
              ("MobileNet, rates off", {"backbone": "mobilenet_v3_large_fpn"}, False),
              ("float32, rates on", {"compute_dtype": torch.float32}, True))
    total = {k: 0 for k in cb.KERNELS}
    for name, fields, rates in routes:
        cfg = DetectorConfig(num_classes=9, t_rpn=8, t_det=12, **fields)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        if cfg.backbone != "resnet50_fpn":      # the gain of eval_path's MobileNet
            for layer in params["backbone"]["fpn"]["layer"]:
                layer["w"].mul_(6.0)
        n, (h, w) = 2, cfg.bucket
        g = torch.Generator(device=dev).manual_seed(1)
        batches = [{"images": torch.rand((n, h, w, 3), generator=g, device=dev),
                    "image_sizes": torch.tensor([[h, w]] * n, device=dev),
                    "original_sizes": torch.tensor([[1024, 2048]] * n, device=dev)}
                   for _ in range(n_batches)]

        def run(i):
            return detector_apply(params, batches[i], cfg, collect_rates=rates)[0]

        def turn():
            torch.cuda.synchronize()
            cb.reset_counts()
            t0 = time.perf_counter()
            outs = [run(i) for i in range(n_batches)]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / n_batches
            return outs, dict(cb.LAUNCHES), dict(cb.PLAIN_CUDA_CALLS), ms

        for rep in range(2):
            with eager_functions():
                eager = turn()
            graphed = turn()
            for i, (a, b) in enumerate(zip(eager[0], graphed[0])):
                if not (outputs_equal(a, b) and outputs_equal(b, a)):
                    differ = {k: int((v != b[k]).sum()) if v.shape == b[k].shape
                              else "shape" for k, v in a.items() if torch.is_tensor(v)}
                    _fail(f"graphs: {name}, batch {i} of turn {rep}: the graphed outputs "
                          f"differ from the eager ones (elements {differ})")
            if eager[1:3] != graphed[1:3]:
                _fail(f"graphs: {name}: launches {graphed[1]} and plain calls {graphed[2]} "
                      f"graphed, {eager[1]} and {eager[2]} eager")
            print(f"graphs: {name}, turn {rep}: {n_batches} batches bit-equal to eager; "
                  f"wall ms a batch {eager[3]:.3f} eager, {graphed[3]:.3f} graphed; "
                  f"kernel launches {graphed[1]}")
            for k, v in graphed[1].items():
                total[k] += v
        for how, ctx in (("eager", eager_functions), ("graphed", contextlib.nullcontext)):
            with ctx():
                host, device = _segment_ms(lambda i: run(i % n_batches), 2 * n_batches)
            print(f"graphs: {name}, {how}, ms a batch (host launching / device) of the backbone "
                  f"{host[0]:.3f} / {device[0]:.3f}, the RPN {host[1]:.3f} / {device[1]:.3f}, "
                  f"the RoI heads with the sync {host[2]:.3f} / {device[2]:.3f}, the outputs "
                  f"{host[3]:.3f} / {device[3]:.3f}")
        with eager_functions():
            le, ge, se = _host_calls(lambda: run(0))
        lg, gg, sg = _host_calls(lambda: run(0))
        print(f"graphs: {name}, one batch: host kernel launches {le} eager, {lg} graphed; "
              f"CUDA graph launches {ge} eager, {gg} graphed; synchronisations {se} eager, "
              f"{sg} graphed")
        if lg > le - 300:
            _fail(f"graphs: {name}: the graphed batch made {lg} kernel launches, the "
                  f"eager one {le}")
    return total


def reference_numerics():
    """f32 products and convolutions run in full f32, not TF32: the plain
    versions are the references the kernels are held against, and the f32
    readouts in them must not lose precision to TF32. For the same reason
    cuBLAS may not reduce bf16 products in bf16: the references round each
    product once, from f32, as the kernels do."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dist-rank"]:
        return _dist_rank(*sys.argv[2:4])
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    reference_numerics()
    dev = torch.device("cuda:0")
    print(_smi())
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
    by_path = {"inference": main_path(dev), "training": train_path(dev),
               "training_bf16_states": train_path(dev, bf16_states=True),
               "evaluation": eval_path(dev, "resnet50_fpn"),
               "mobilenet": eval_path(dev, "mobilenet_v3_large_fpn"),
               "fused_box_head": fused_head_path(dev),
               "float32_evaluation": float32_eval_path(dev),
               "dataset_eval": dataset_eval_path(dev),
               "routes": routes_path(dev),
               "cli": cli_path(dev),
               "dist": dist_path(dev),
               "bench_weights": bench_weights_path(dev),
               "joint": joint_path(dev),
               "chain": chain_path(dev),
               "bench": bench_path(dev),
               "graphs": graphs_path(dev)}
    for r in results:
        r["launches_by_path"] = {k: v[r["name"]] for k, v in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] == 0:
            _fail(f"{r['name']} was launched on no path")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
