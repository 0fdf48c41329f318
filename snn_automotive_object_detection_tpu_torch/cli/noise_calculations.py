"""Noise-robustness sweeps with the PyTorch/CUDA port: mAP under gaussian
noise or synthetic rain.

The port's counterpart of the JAX package's ``cli/noise_calculations.py``
(the reference's noise_calculations.py): evaluates a checkpoint under
gaussian variance in {0, 0.01, ..., 0.24} (its :415-417) or rain drops in
{0, 50, ..., 300} (``--rain-noise``, its :371-372), appending

  [noise_type, intensity, mAP@[.5:.95], mAP@.5, mAR@100]

rows to OUT_DIR/noise_acc_*.json / rain_noise_acc_*.json after each point,
so that a partial sweep survives. Every flag of ``cli/train.py`` applies
(dataset, weights, heads, numerics, ``--device``); one evaluation step
serves every intensity, since the shapes do not change.

    python -m snn_automotive_object_detection_tpu_torch.cli.noise_calculations \\
        -d cityscapes --rpn-snn --detector-snn -t-rpn 8 -t-det 12 \\
        --load-model ckpt.pth --save-name SNN
"""

from __future__ import annotations

import argparse
import json
import os

from snn_automotive_object_detection_tpu_torch.cli.train import (
    build_everything,
    compute_mean_avg_precision,
    get_args_parser as train_args,
    load_weights,
    run_device,
)
from snn_automotive_object_detection_tpu_torch.train.steps import make_eval_step


def get_args_parser():
    p2 = argparse.ArgumentParser(parents=[train_args(add_help=False)],
                                 description="noise sweep (PyTorch/CUDA)")
    p2.add_argument("--rain-noise", dest="rain_noise", action="store_true",
                    help="sweep rain drops instead of gaussian variance")
    p2.add_argument("--gaussian-max", dest="gaussian_max", type=float, default=0.24)
    p2.add_argument("--gaussian-step", dest="gaussian_step", type=float, default=0.01)
    p2.add_argument("--rain-max", dest="rain_max", type=int, default=300)
    p2.add_argument("--rain-step", dest="rain_step", type=int, default=50)
    return p2


def sweep_points(args):
    """(noise name, output name, intensities) of the sweep ``args`` asks for."""
    if args.rain_noise:
        return "rain", "rain_noise_acc", list(range(0, args.rain_max + 1, args.rain_step))
    n = int(round(args.gaussian_max / args.gaussian_step)) + 1
    return "gaussian", "noise_acc", [round(i * args.gaussian_step, 4) for i in range(n)]


def main(args):
    """Runs the sweep; returns the rows written."""
    device = run_device(args)
    noise_name, out_name, points = sweep_points(args)
    if args.save_name:
        out_name += f"_{args.save_name}"

    results = []
    out_path = None
    step = None
    for intensity in points:
        point = argparse.Namespace(**{**vars(args), "add_noise": "" if intensity == 0
                                      else noise_name, "noise_intensity": float(intensity)})
        _, out_dir, config, params, make_loader = build_everything(point)
        out_path = out_path or os.path.join(out_dir, out_name + ".json")
        params = load_weights(point, config, params)
        ds, loader = make_loader("validation", training=False)
        step = step or make_eval_step(config)   # the same shapes at every intensity
        stats = compute_mean_avg_precision(step, params, loader, ds, device,
                                           rm_bg=args.rm_bg, print_freq=args.print_freq)
        results.append([noise_name, intensity, float(stats[0]), float(stats[1]),
                        float(stats[8])])
        with open(out_path, "w") as f:
            json.dump(results, f)
        print(f"[noise] {noise_name}={intensity} -> mAP {stats[0]:.4f}")
    print(f"wrote {len(results)} rows to {out_path}")
    return results


if __name__ == "__main__":
    main(get_args_parser().parse_args())
