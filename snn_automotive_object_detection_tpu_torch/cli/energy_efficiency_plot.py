"""Energy-efficiency plots and offline energy recomputation with the
PyTorch/CUDA port.

The port's counterpart of the JAX package's ``cli/energy_efficiency_plot.py``
(the reference's energy_efficiency_plot.py):

  * -p / --plot: render the T_rpn x T_det tradeoff matrix from the JSONs
    that ``cli/test_and_energy_eff.py`` writes (:26-104), a normalised
    combination of energy reduction and mAP@.5 (Matplotlib)
  * default mode: recompute the per-layer energy report from a spike-rate
    ``.npz`` (``cli/train.py --extract-spike-rates``, :106-153), with the
    ResNet-FPN level shapes of ``--bucket``; numpy only

    python -m snn_automotive_object_detection_tpu_torch.cli.energy_efficiency_plot \\
        -f outputs/cityscapes/spike_rates_val_cityscapes.npz -t-rpn 8 -t-det 12
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser(description="energy efficiency plots (PyTorch/CUDA)")
    p.add_argument("-p", "--plot", action="store_true",
                   help="render the tradeoff matrix from sweep JSONs")
    p.add_argument("--efficiency-json", dest="efficiency_json", default="")
    p.add_argument("--metrics-json", dest="metrics_json", default="")
    p.add_argument("-f", "--file", default="",
                   help="spike-rate .npz (from --extract-spike-rates)")
    p.add_argument("-t-rpn", dest="num_steps_rpn", type=int, default=8)
    p.add_argument("-t-det", dest="num_steps_detector", type=int, default=12)
    p.add_argument("--bucket", nargs=2, type=int, default=[768, 1536])
    p.add_argument("--num-rois", dest="num_rois", type=int, default=1000)
    p.add_argument("-o", "--out", default="tradeoff_matrix.pdf")
    p.add_argument("--w-eff", dest="w_eff", type=float, default=1.0)
    p.add_argument("--w-perf", dest="w_perf", type=float, default=1.0)
    return p


def tradeoff_matrix(results_eff, results_perf, w_eff=1.0, w_perf=1.0):
    """Build the (T_rpn x T_det) tradeoff matrix (reference :40-55).

    results_eff rows: [t_rpn, t_det, reduction]; results_perf rows:
    [t_rpn, t_det, mAP, mAP@.5, mAR]. Returns (matrix, rpn_values,
    det_values) with the reference's orientation (T_rpn descending on rows).
    """
    eff = np.array([r[2] for r in results_eff]) * 100
    map05 = np.array([r[3] for r in results_perf]) * 100
    n_cons = (eff - eff.min()) / max(eff.max() - eff.min(), 1e-12)
    n_perf = (map05 - map05.min()) / max(map05.max() - map05.min(), 1e-12)
    tradeoff = w_eff * np.abs(1 - n_cons) + w_perf * n_perf

    rpn_vals = sorted({r[0] for r in results_eff})
    det_vals = sorted({r[1] for r in results_eff})
    mat = np.zeros((len(rpn_vals), len(det_vals)))
    for row, t in zip(results_eff, tradeoff):
        i = len(rpn_vals) - 1 - rpn_vals.index(row[0])  # T_rpn descending
        j = det_vals.index(row[1])
        mat[i, j] = t
    return mat, rpn_vals, det_vals


def plot_tradeoff(mat, rpn_vals, det_vals, out):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    plt.imshow(mat, cmap="RdYlGn")
    plt.xticks(range(len(det_vals)), det_vals)
    plt.yticks(range(len(rpn_vals)), list(reversed(rpn_vals)))
    plt.xlabel("$T_{det}$")
    plt.ylabel("$T_{rpn}$")
    plt.colorbar(label="tradeoff score")
    plt.savefig(out, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out}")


def energy_from_rates(path, t_rpn, t_det, bucket, num_rois):
    """The energy report (``utils/energy.energy_report``, printed) of the
    spike rates in the ``.npz`` at ``path``."""
    from snn_automotive_object_detection_tpu_torch.ops.anchors import fpn_feature_shapes
    from snn_automotive_object_detection_tpu_torch.utils import energy as em

    data = np.load(path)
    spikes = em.aggregate_rates({"shared": data["shared"]},
                                {"fc6": data["fc6"], "fc7": data["fc7"]}, t_rpn, t_det)
    flops = (em.rpn_shared_flops(fpn_feature_shapes(tuple(bucket), 5))
             + em.detector_fc_flops(num_rois))
    return em.energy_report(spikes, flops)


def main(args):
    """The tradeoff plot with ``-p`` (returns the matrix and its axes), else
    the energy report of ``-f`` (returns the report)."""
    if args.plot:
        with open(args.efficiency_json) as f:
            results_eff = json.load(f)
        with open(args.metrics_json) as f:
            results_perf = json.load(f)
        got = tradeoff_matrix(results_eff, results_perf, args.w_eff, args.w_perf)
        plot_tradeoff(*got, args.out)
        return got
    return energy_from_rates(args.file, args.num_steps_rpn, args.num_steps_detector,
                             args.bucket, args.num_rois)


if __name__ == "__main__":
    main(get_args_parser().parse_args())
