#!/usr/bin/env bash
# Batch noise-robustness sweeps with the PyTorch/CUDA port (the reference's
# noise_metrics.sh): the gaussian and the rain sweep of each checkpoint under
# $CKPT_DIR (default: checkpoints/), on the CUDA device (DEVICE=cpu for the
# CPU).
set -euo pipefail
CKPT_DIR="${CKPT_DIR:-checkpoints}"
DEVICE="${DEVICE:-cuda}"
cd "$(dirname "$0")/../.."

for model in model_Cityscapes_SNN_Trpn8_Tdet12 model_Cityscapes_NoSNN; do
  snn_flags=""
  if [[ "$model" == *SNN_Trpn* ]]; then
    snn_flags="--rpn-snn --detector-snn -t-rpn 8 -t-det 12"
  fi
  echo "### gaussian sweep: $model"
  python -m snn_automotive_object_detection_tpu_torch.cli.noise_calculations -d cityscapes \
      $snn_flags --load-model "$CKPT_DIR/$model.pth" --save-name "$model" --device "$DEVICE"
  echo "### rain sweep: $model"
  python -m snn_automotive_object_detection_tpu_torch.cli.noise_calculations -d cityscapes \
      $snn_flags --load-model "$CKPT_DIR/$model.pth" --save-name "$model" --rain-noise \
      --device "$DEVICE"
done
