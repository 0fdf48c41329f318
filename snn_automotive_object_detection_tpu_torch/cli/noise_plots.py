"""Plot the relative precision drop against the noise level for several
models.

The port's counterpart of the JAX package's ``cli/noise_plots.py`` (the
reference's noise_plots.py): reads the JSONs that
``cli/noise_calculations.py`` writes for up to four model variants (SNN,
SNN*, NoSNN, NoSNN*; * = noise-finetuned) and plots mAP@.5 relative to the
clean value against gaussian sigma^2 (left) and the raindrop count (right).
Matplotlib is imported inside :func:`main`.

    python -m snn_automotive_object_detection_tpu_torch.cli.noise_plots \\
        --gaussian SNN=noise_acc_SNN.json --rain SNN=rain_noise_acc_SNN.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser(description="noise robustness plots (PyTorch/CUDA)")
    p.add_argument("--gaussian", nargs="+", default=[],
                   help="label=path pairs of gaussian sweep JSONs")
    p.add_argument("--rain", nargs="+", default=[],
                   help="label=path pairs of rain sweep JSONs")
    p.add_argument("-o", "--out", default="noise_plots.png")
    p.add_argument("--metric-index", dest="metric_index", type=int, default=3,
                   help="row index of the metric (3 = mAP@.5)")
    return p


def _load(pairs):
    out = {}
    for pair in pairs:
        label, path = pair.split("=", 1)
        with open(path) as f:
            out[label] = json.load(f)
    return out


def relative_drop(rows, metric_index: int = 3):
    """(noise levels, the metric in % of its value at the first level)."""
    y = np.array([row[metric_index] for row in rows])
    return [row[1] for row in rows], y / max(y[0], 1e-12) * 100


def main(args):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = _load(args.gaussian)
    r = _load(args.rain)
    n_panels = int(bool(g)) + int(bool(r))
    if not n_panels:
        raise SystemExit("pass --gaussian and/or --rain label=path pairs")
    fig, axes = plt.subplots(1, n_panels, figsize=(7 * n_panels, 5), squeeze=False)
    panel = 0
    for data, xlabel in ((g, r"gaussian noise $\sigma^2$"), (r, "rain drops")):
        if not data:
            continue
        ax = axes[0][panel]
        for label, rows in data.items():
            ax.plot(*relative_drop(rows, args.metric_index), marker="o", label=label)
        ax.set_xlabel(xlabel)
        ax.set_ylabel("relative mAP@.5 (%)")
        ax.grid(alpha=0.3)
        ax.legend()
        panel += 1
    fig.tight_layout()
    fig.savefig(args.out)
    plt.close(fig)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main(get_args_parser().parse_args())
