"""Plotting helpers: boxes on images, prediction-vs-GT panels.

Covers the reference's visual-inspection paths: ``create_img_with_bboxes``
(the reference's custom_utils.py:180-233) and the --plot-images /
--save-images panels (train.py:329-423). Copy of
``snn_automotive_object_detection_tpu/utils/plotting.py`` for the PyTorch
port, with Matplotlib (Agg only, headless) imported inside the functions,
so that nothing on the card's path needs it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _pyplot():
    """matplotlib's pyplot and patches on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    return plt, patches


def draw_boxes(ax, boxes: np.ndarray, labels=None, scores=None,
               color: str = "lime", class_names: Optional[Dict[int, str]] = None):
    _, patches = _pyplot()
    for i, b in enumerate(np.asarray(boxes).reshape(-1, 4)):
        ax.add_patch(
            patches.Rectangle((b[0], b[1]), b[2] - b[0], b[3] - b[1],
                              linewidth=1.5, edgecolor=color, facecolor="none")
        )
        if labels is not None:
            name = str(int(labels[i]))
            if class_names:
                name = class_names.get(int(labels[i]), name)
            txt = name if scores is None else f"{name} {scores[i]:.2f}"
            ax.text(b[0], max(b[1] - 3, 0), txt, color=color, fontsize=7,
                    bbox=dict(facecolor="black", alpha=0.4, pad=0))


def image_with_boxes(image: np.ndarray, boxes, labels=None, scores=None,
                     class_names=None, color="lime"):
    """Returns a matplotlib Figure with boxes drawn on the image."""
    plt, _ = _pyplot()
    fig, ax = plt.subplots(figsize=(image.shape[1] / 100, image.shape[0] / 100),
                           dpi=100)
    ax.imshow(np.clip(image, 0, 1) if image.dtype != np.uint8 else image)
    draw_boxes(ax, boxes, labels, scores, color, class_names)
    ax.axis("off")
    fig.tight_layout(pad=0)
    return fig


def save_prediction_panel(
    path: str,
    image: np.ndarray,
    pred: Dict[str, np.ndarray],
    gt: Optional[Dict[str, np.ndarray]] = None,
    class_names: Optional[Dict[int, str]] = None,
    option: str = "imgs_and_preds",
):
    """Prediction (and optionally GT) panel like train.py:329-423.

    option: 'imgs_and_preds' -> side-by-side GT | prediction;
            'one_img_preds'  -> single image with predictions only.
    """
    plt, _ = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if option == "one_img_preds" or gt is None:
        fig = image_with_boxes(image, pred["boxes"], pred.get("labels"),
                               pred.get("scores"), class_names, color="red")
    else:
        fig, axes = plt.subplots(1, 2, figsize=(16, 6))
        for ax, (title, d, color) in zip(
            axes,
            [("ground truth", gt, "lime"), ("prediction", pred, "red")],
        ):
            ax.imshow(np.clip(image, 0, 1) if image.dtype != np.uint8 else image)
            draw_boxes(ax, d["boxes"], d.get("labels"), d.get("scores"),
                       color, class_names)
            ax.set_title(title)
            ax.axis("off")
        fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
