"""Sweep (T_rpn, T_det) for accuracy or energy efficiency with the
PyTorch/CUDA port.

The port's counterpart of the JAX package's ``cli/test_and_energy_eff.py``
(the reference's metrics_for_different_timesteps.py): for T_rpn in
[r1, r2] x T_det in [d1, d2] it builds the model (T is a loop length, so
each pair is a model of its own), evaluates the validation set and appends
a row to a JSON file after every pair, so that a partial sweep survives:

  -o metrics:     [t_rpn, t_det, mAP@[.5:.95], mAP@.5, mAR@100]
  -o efficiency:  [t_rpn, t_det, energy reduction against the ANN]

Every flag of ``cli/train.py`` applies (dataset, weights, heads, numerics,
``--device``). With bf16 the box head's kernels take up to 32 steps; a
``t_det`` above that runs the box head's scan, as the reference's gate
sends it to its XLA scan.

    python -m snn_automotive_object_detection_tpu_torch.cli.test_and_energy_eff \\
        -d cityscapes --rpn-snn --detector-snn --load-model ckpt.pth -o metrics
"""

from __future__ import annotations

import argparse
import json
import os

from snn_automotive_object_detection_tpu_torch.cli.train import (
    build_everything,
    compute_mean_avg_precision,
    extract_spike_rates_run,
    get_args_parser as train_args,
    load_weights,
    run_device,
)
from snn_automotive_object_detection_tpu_torch.train.steps import make_eval_step


def get_args_parser():
    p2 = argparse.ArgumentParser(parents=[train_args(add_help=False)],
                                 description="T-step sweep (PyTorch/CUDA)")
    p2.add_argument("-o", "--option", choices=["metrics", "efficiency"], required=True)
    p2.add_argument("-r1", "--t-rpn-min", dest="t_rpn_min", type=int, default=4)
    p2.add_argument("-r2", "--t-rpn-max", dest="t_rpn_max", type=int, default=12)
    p2.add_argument("-d1", "--t-det-min", dest="t_det_min", type=int, default=8)
    p2.add_argument("-d2", "--t-det-max", dest="t_det_max", type=int, default=16)
    p2.add_argument("--max-batches", dest="max_batches", type=int, default=0,
                    help="limit eval batches per pair (0 = the whole set)")
    return p2


def main(args):
    """Runs the sweep; returns the rows written."""
    device = run_device(args)
    results = []
    out_name = f"sweep_{args.option}" + (f"_{args.save_name}" if args.save_name else "")
    out_path = None
    for t_rpn in range(args.t_rpn_min, args.t_rpn_max + 1):
        for t_det in range(args.t_det_min, args.t_det_max + 1):
            combo = argparse.Namespace(**{**vars(args), "num_steps_rpn": t_rpn,
                                          "num_steps_detector": t_det})
            _, out_dir, config, params, make_loader = build_everything(combo)
            out_path = out_path or os.path.join(out_dir, out_name + ".json")
            params = load_weights(combo, config, params)
            ds, loader = make_loader("validation", training=False)
            if args.option == "metrics":
                stats = compute_mean_avg_precision(make_eval_step(config), params, loader, ds,
                                                   device, rm_bg=args.rm_bg,
                                                   print_freq=args.print_freq)
                row = [t_rpn, t_det, float(stats[0]), float(stats[1]), float(stats[8])]
            else:
                res = extract_spike_rates_run(make_eval_step(config, collect_rates=True),
                                              params, loader, config, device,
                                              max_batches=args.max_batches or None)
                row = [t_rpn, t_det, float(res["report"]["reduction"])]
            results.append(row)
            with open(out_path, "w") as f:
                json.dump(results, f)
            print(f"[sweep] t_rpn={t_rpn} t_det={t_det} -> {row[2:]}")
    print(f"wrote {len(results)} rows to {out_path}")
    return results


if __name__ == "__main__":
    main(get_args_parser().parse_args())
