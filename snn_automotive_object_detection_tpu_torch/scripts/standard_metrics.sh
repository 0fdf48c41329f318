#!/usr/bin/env bash
# Batch COCO evaluation of the released checkpoints with the PyTorch/CUDA
# port (the reference's standard_metrics.sh). The .pth files are expected
# under $CKPT_DIR (default: checkpoints/); the runs take the CUDA device
# (set DEVICE=cpu for the CPU).
set -euo pipefail
CKPT_DIR="${CKPT_DIR:-checkpoints}"
DEVICE="${DEVICE:-cuda}"
cd "$(dirname "$0")/../.."

run() {
  echo "### $*"
  python -m snn_automotive_object_detection_tpu_torch.cli.train "$@" --test-only \
      --device "$DEVICE"
}

# SNN models (Trpn8/Tdet12)
run -d cityscapes --rpn-snn --detector-snn -t-rpn 8 -t-det 12 \
    --load-model "$CKPT_DIR/model_Cityscapes_SNN_Trpn8_Tdet12.pth"
run -d bdd --rpn-snn --detector-snn -t-rpn 8 -t-det 12 \
    --load-model "$CKPT_DIR/model_BDD_SNN.pth"
run -d idd --rpn-snn --detector-snn -t-rpn 8 -t-det 12 \
    --load-model "$CKPT_DIR/model_IDD_SNN.pth"

# Non-SNN baselines
run -d cityscapes --load-model "$CKPT_DIR/model_Cityscapes_NoSNN.pth"
run -d bdd --load-model "$CKPT_DIR/model_BDD_NoSNN.pth"
run -d idd --load-model "$CKPT_DIR/model_IDD_NoSNN.pth"

# Known-classes (open-set) variants
run -d bdd --rpn-snn --detector-snn -t-rpn 8 -t-det 12 --only-known-cls \
    --load-model "$CKPT_DIR/model_BDD_SNN_5cls.pth"
