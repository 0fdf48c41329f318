"""One-command parity check of a reference checkpoint.

Port of ``tools/parity_vs_reference.py`` of the JAX package:

    python -m snn_automotive_object_detection_tpu_torch.tools.parity_vs_reference \\
        model_Cityscapes_SNN_Trpn8_Tdet12.pth -d cityscapes [--data-root ...]

evaluates the ``.pth`` (the reference's torchvision layout, converted as the
training CLI's ``--load-model`` converts it) on the dataset's validation
split twice through the port's ``cli/train.py``: with ``--fp32`` (float32,
the scans, no kernel) and on the bf16 path (the hand-written kernels on a
CUDA device). It prints the 12 COCO stats side by side with their
difference, the 7 spike-rate means (5 RPN levels, FC6, FC7) of each from
``--extract-spike-rates test``, and the bf16-vs-fp32 mAP delta: the check
of BASELINE.md ("mAP within 0.5 pts of the released checkpoint, spike
rates to 1e-3") as one command. It runs on the CUDA device unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from snn_automotive_object_detection_tpu_torch.cli import train as train_cli
from snn_automotive_object_detection_tpu_torch.utils.config import load_dataset_config

STAT_NAMES = [
    "AP@[.5:.95]", "AP@.5", "AP@.75", "AP-small", "AP-medium", "AP-large",
    "AR@1", "AR@10", "AR@100", "AR-small", "AR-medium", "AR-large",
]
RATE_NAMES = ["LVL_0", "LVL_1", "LVL_2", "LVL_3", "pool", "FC6", "FC7"]


def get_args_parser():
    p = argparse.ArgumentParser("reference-checkpoint parity harness")
    p.add_argument("checkpoint", help=".pth reference checkpoint")
    p.add_argument("-d", "--dataset", default="cityscapes")
    p.add_argument("--data-root", default="")
    p.add_argument("--model-config", default="")
    p.add_argument("-t-rpn", dest="t_rpn", type=int, default=8,
                   help="the released operating point")
    p.add_argument("-t-det", dest="t_det", type=int, default=12)
    p.add_argument("-b", "--batch-size", type=int, default=2)
    p.add_argument("-j", "--workers", type=int, default=4)
    p.add_argument("--only-known-cls", action="store_true")
    p.add_argument("--only-one-bbox", action="store_true")
    p.add_argument("--backbone", default="resnet50_fpn")
    p.add_argument("--skip-rates", action="store_true",
                   help="skip the spike-rate pass (mAP only)")
    p.add_argument("--skip-bf16", action="store_true", help="fp32 only")
    p.add_argument("--out-dir", default="")
    p.add_argument("--device", default="cuda",
                   help="the device to run on: the CUDA device unless 'cpu' is asked for")
    return p


def _eval_args(args, fp32: bool, rates: bool):
    argv = [
        "-d", args.dataset, "--rpn-snn", "--detector-snn",
        "--load-model", args.checkpoint,
        "-t-rpn", str(args.t_rpn), "-t-det", str(args.t_det),
        "-b", str(args.batch_size), "-j", str(args.workers),
        "--backbone", args.backbone, "--device", args.device,
    ]
    argv += ["--extract-spike-rates", "test"] if rates else ["--test-only"]
    if fp32:
        argv.append("--fp32")
    if args.only_known_cls:
        argv.append("--only-known-cls")
    if args.only_one_bbox:
        argv.append("--only-one-bbox")
    if args.data_root:
        argv += ["--data-root", args.data_root]
    if args.model_config:
        argv += ["--model-config", args.model_config]
    if args.out_dir:
        argv += ["--out-dir", args.out_dir]
    return train_cli.get_args_parser().parse_args(argv)


def rates_from_npz(path):
    """The 7 means: each RPN level's shared-layer rate, then FC6 and FC7."""
    data = np.load(path)
    shared = data["shared"]  # [L, images]
    return [float(shared[i].mean()) for i in range(shared.shape[0])] + [
        float(data["fc6"].mean()), float(data["fc7"].mean()),
    ]


def main(args):
    """Returns ({mode: the 12 stats}, {mode: the 7 rate means})."""
    cfg = load_dataset_config(args.dataset, args.data_root or None)
    out_dir = args.out_dir or cfg.get("out_dir", f"outputs/{cfg['dataset']}")
    rates_npz = os.path.join(out_dir, f"spike_rates_test_{cfg['dataset']}.npz")

    modes = [("fp32", True)] + ([] if args.skip_bf16 else [("bf16", False)])
    stats, rates = {}, {}
    for name, fp32 in modes:
        print(f"\n=== {name} evaluation ===", flush=True)
        stats[name] = np.asarray(train_cli.main(_eval_args(args, fp32, False)))
        if not args.skip_rates:
            print(f"=== {name} spike rates ===", flush=True)
            train_cli.main(_eval_args(args, fp32, True))
            rates[name] = rates_from_npz(rates_npz)

    print("\n================ PARITY REPORT ================")
    hdr = f"{'stat':<14}" + "".join(f"{n:>12}" for n, _ in modes)
    if len(modes) == 2:
        hdr += f"{'diff':>12}"
    print(hdr)
    for i, sname in enumerate(STAT_NAMES):
        row = f"{sname:<14}" + "".join(f"{stats[n][i]:>12.4f}" for n, _ in modes)
        if len(modes) == 2:
            row += f"{stats['bf16'][i] - stats['fp32'][i]:>12.4f}"
        print(row)
    if rates:
        print()
        n_lvls = len(rates[modes[0][0]]) - 2
        names = RATE_NAMES if n_lvls == 5 else (
            [f"LVL_{i}" for i in range(n_lvls - 1)] + ["pool", "FC6", "FC7"])
        print(f"{'spike rate':<14}" + "".join(f"{n:>12}" for n, _ in modes))
        for i, rname in enumerate(names):
            print(f"{rname:<14}"
                  + "".join(f"{rates[n][i]:>12.5f}" for n, _ in modes))
    if len(modes) == 2:
        d = float(stats["bf16"][0] - stats["fp32"][0])
        print(f"\nbf16-vs-fp32 mAP delta: {d:+.4f} "
              f"(budget: |released - ours| <= 0.005, BASELINE.md)")
    return stats, rates


if __name__ == "__main__":
    main(get_args_parser().parse_args())
