"""SNN-vs-ANN energy model (45 nm CMOS constants).

Copy of ``snn_automotive_object_detection_tpu/utils/energy.py`` for the
PyTorch port (numpy only).

Reference formulas (the reference's train.py:500-515,
metrics_for_different_timesteps.py:253-269):

  E_ANN(layer)  = FLOPs * 4.6 pJ
  E_SNN(layer)  = mean_spikes_per_neuron_over_T * FLOPs * 0.9 pJ
  reduction     = sum(E_SNN) / sum(E_ANN)

over layers {RPN shared conv at FPN levels 0..3 + pool, FC6, FC7}. Spike
rates come from the detector's first-class spike-rate outputs (the
comment-toggled "EXTRACT SPIKE RATES" hack in the reference is a runtime
flag here). The detector FC FLOPs are per-RoI and scale by the 1000 eval
RoIs (train.py:494).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

E_ANN_PJ = 4.6e-12   # per MAC (train.py:506)
E_SNN_PJ = 0.9e-12   # per synaptic op (train.py:507)

RPN_LAYER_NAMES = ["LVL_0", "LVL_1", "LVL_2", "LVL_3", "pool"]
DET_LAYER_NAMES = ["FC6", "FC7"]


def rpn_shared_flops(feature_shapes: Sequence[Tuple[int, int]],
                     in_channels: int = 256) -> List[float]:
    """3x3 shared-conv FLOPs per level (rpn.py:177-180 bookkeeping)."""
    return [9.0 * h * w * in_channels * in_channels for h, w in feature_shapes]


def detector_fc_flops(num_rois: int = 1000, in_features: int = 256 * 49,
                      rep: int = 1024) -> List[float]:
    return [float(in_features) * rep * num_rois, float(rep) * rep * num_rois]


def energy_report(
    spikes_per_layer: Sequence[float],
    flops_per_layer: Sequence[float],
    layer_names: Sequence[str] = tuple(RPN_LAYER_NAMES + DET_LAYER_NAMES),
    verbose: bool = True,
) -> Dict[str, float]:
    """spikes_per_layer: mean spikes per neuron over the FULL T window
    (rate * T, train.py:484/493). Returns totals + reduction ratio."""
    assert len(spikes_per_layer) == len(flops_per_layer) == len(layer_names), (
        # A silent zip-truncation here mispairs layers (e.g. 3-level
        # mobilenet rates against 5-level ResNet FLOPs).
        (len(spikes_per_layer), len(flops_per_layer), len(layer_names))
    )
    ann_total = 0.0
    snn_total = 0.0
    per_layer = []
    for name, s, f in zip(layer_names, spikes_per_layer, flops_per_layer):
        e_ann = f * E_ANN_PJ
        e_snn = s * f * E_SNN_PJ
        ann_total += e_ann
        snn_total += e_snn
        per_layer.append((name, e_ann, e_snn))
        if verbose:
            print(f"{name}:\tANN energy: {e_ann:.5f} J | SNN energy: "
                  f"{e_snn:.5f} J | consumption: {e_snn / e_ann * 100:.2f}%")
    reduction = snn_total / ann_total if ann_total else float("nan")
    if verbose:
        print(f"Total energy consumption vs ANN: {reduction * 100:.2f}%")
    return {
        "ann_total_j": ann_total,
        "snn_total_j": snn_total,
        "reduction": reduction,
        "per_layer": per_layer,
    }


def aggregate_rates(
    rpn_rates: Dict[str, np.ndarray],
    det_rates: Dict[str, np.ndarray],
    t_rpn: int,
    t_det: int,
) -> List[float]:
    """Collapse collected per-image / per-RoI rates into the 7 layer means
    the energy model consumes (train.py:479-498): mean over images of the
    per-step rate, times T."""
    out = []
    shared = np.asarray(rpn_rates["shared"])  # [L, total_images]
    for lvl in range(shared.shape[0]):
        out.append(float(shared[lvl].mean()) * t_rpn)
    out.append(float(np.asarray(det_rates["fc6"]).mean()) * t_det)
    out.append(float(np.asarray(det_rates["fc7"]).mean()) * t_det)
    return out
