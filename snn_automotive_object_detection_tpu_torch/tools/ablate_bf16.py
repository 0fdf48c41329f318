"""Where the bf16-vs-fp32 mAP gap comes from: one set of weights evaluated on
one held-out set under precision variants.

Port of ``tools/ablate_bf16.py`` of the JAX package: the same variants,
the same held-out evaluation (``tools/make_bench_weights.evaluate_heldout``)
and the same JSON lines, on the port's routes (bf16 runs the hand-written
kernels on a CUDA device, their plain versions on the CPU):

  fp32              float32 compute and states: the scans, the gather
                    RoIAlign, no kernel
  state32           bf16 compute, float32 neuron states (the default, the
                    reference's AMP numerics): the flagship kernels
  bf16              bf16 compute and states: K1's bf16-state instance, K2,
                    K3 and the box tail's scan with bf16 states
  bb32_heads_bf16   a float32 backbone (unfused chain), its features cast to
                    bf16 for bf16 heads with bf16 states
  bb16_heads_f32    a bf16 backbone (fused stem and FPN), its features cast
                    to float32 for float32 heads (the scans)

The JAX tool's ``bf16_xla`` and ``state32_xla`` switch its kernels off.
The port has no route with the kernels off on a card (each kernel is held
to its plain version by ``chip_smoke.py`` instead), so it refuses those
two names.

    python -m snn_automotive_object_detection_tpu_torch.tools.ablate_bf16 \\
        --load bench_weights.pth --images 64 --variants fp32,state32,bf16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from snn_automotive_object_detection_tpu_torch.models import detector as det_mod
from snn_automotive_object_detection_tpu_torch.models.factory import (
    DetectorConfig,
    init_params,
)
from snn_automotive_object_detection_tpu_torch.tools.make_bench_weights import (
    evaluate_heldout,
)
from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_weights_lenient,
)

VARIANTS = ("fp32", "bf16", "state32", "bb32_heads_bf16", "bb16_heads_f32")
KERNELS_OFF = ("bf16_xla", "state32_xla")


def make_variant_config(base: DetectorConfig, name: str):
    """(config, the backbone's dtype where it differs from the heads', else
    None). The neuron states' dtype is set in every variant."""
    f32, bf16 = torch.float32, torch.bfloat16
    if name in KERNELS_OFF:
        raise ValueError(
            f"variant {name!r} switches the kernels off, which the port does not do: each "
            "kernel is held to its plain version by chip_smoke.py instead; the port runs "
            f"{', '.join(VARIANTS)}")
    table = {
        "fp32": (f32, None, None),
        "bf16": (bf16, None, None),
        "state32": (bf16, f32, None),
        "bb32_heads_bf16": (bf16, None, f32),
        "bb16_heads_f32": (f32, None, bf16),
    }
    if name not in table:
        raise ValueError(f"unknown variant {name!r}")
    compute, states, backbone = table[name]
    return dataclasses.replace(base, compute_dtype=compute, snn_state_dtype=states), backbone


def run_variant(name: str, base: DetectorConfig, params, n_images: int, batch: int):
    """(the 12 held-out stats, per-class AP, seconds) of one variant."""
    config, bb_dtype = make_variant_config(base, name)
    real = det_mod.backbone_features
    if bb_dtype is not None:
        # The backbone alone in the other dtype, on that dtype's route; its
        # features go to the heads in the configuration's compute dtype.
        def backbone_features(p, images, cfg, training):
            feats = real(p, images, dataclasses.replace(cfg, compute_dtype=bb_dtype), training)
            return [f.to(cfg.compute_dtype) for f in feats]

        det_mod.backbone_features = backbone_features
    try:
        t0 = time.perf_counter()
        stats, cls_ap = evaluate_heldout(config, params, n_images, batch)
        dt = time.perf_counter() - t0
    finally:
        det_mod.backbone_features = real
    return stats, cls_ap, dt


def get_args_parser():
    ap = argparse.ArgumentParser(description="bf16-vs-fp32 numerics ablation")
    ap.add_argument("--load", required=True, help="weights (.pth of make_bench_weights)")
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on: the CUDA device unless 'cpu' is asked for")
    return ap


def main(args, base: Optional[DetectorConfig] = None):
    """Evaluates every variant; returns {variant: the JSON line}. ``base``
    replaces the flagship configuration (a test's small bucket)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    names = [n.strip() for n in args.variants.split(",")]
    for name in names:   # refuse before anything runs
        make_variant_config(DetectorConfig(), name)
    base = base or DetectorConfig(num_classes=9, t_rpn=8, t_det=12)
    params = init_params(base, torch.Generator(device=device).manual_seed(0), device=device)
    params = load_weights_lenient(params, load_checkpoint(args.load,
                                                          map_location=device)["params"])
    results, lines = {}, {}
    for name in names:
        stats, cls_ap, dt = run_variant(name, base, params, args.images, args.batch)
        results[name] = stats
        line = {"variant": name, "images": args.images,
                "mAP": round(float(stats[0]), 4),
                "AP50": round(float(stats[1]), 4),
                "AP75": round(float(stats[2]), 4),
                "per_class": {k: round(v, 4) for k, v in cls_ap.items()},
                "wall_s": round(dt, 1)}
        lines[name] = line
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    if "fp32" in results:
        ref = results["fp32"][0]
        print("\ndeltas vs fp32 mAP:")
        for name, s in results.items():
            print(f"  {name:18s} {s[0] - ref:+.4f}")
    return lines


if __name__ == "__main__":
    main(get_args_parser().parse_args())
