#!/usr/bin/env bash
# The three-phase bench-weight recipe on the synthetic shape set, then the
# numerics ablation, with the PyTorch/CUDA port (the JAX package's
# tools/chain_recipe.sh, with the port's make_bench_weights and ablate_bf16).
#
# Phase 1 trains the backbone and the heads together (the RPN head then runs
# as the scan under autograd, since the backbone needs the feature gradient);
# phases 2 and 3 train the heads on the frozen backbone (K1's training
# instance and K7). Skipping phase 1 and training frozen from a random
# backbone collapses to all background (mAP 0.0): the joint phase is
# load-bearing.
#
# Usage:  bash snn_automotive_object_detection_tpu_torch/scripts/chain_recipe.sh [OUT]
# writes OUT_p1.pth, OUT_p2.pth and OUT.pth (default OUT: outputs/bench_weights)
# and appends the ablation's lines to ABLATION_chain.jsonl. A fourth joint
# low-rate phase on top (OUT_joint4.pth):
#   bash snn_automotive_object_detection_tpu_torch/scripts/chain_recipe.sh OUT --second-recipe
# The runs take the CUDA device.
set -euo pipefail
cd "$(dirname "$0")/../.."
OUT="${1:-outputs/bench_weights}"
mkdir -p "$(dirname "$OUT")"
MBW=(python -m snn_automotive_object_detection_tpu_torch.tools.make_bench_weights)

# Phase 1: joint (backbone + heads), 6k @ 5e-3. Saves .partial every 1000.
"${MBW[@]}" --out "${OUT}_p1.pth" --steps 6000 \
    --lr 5e-3 --train-backbone --eval-images 64 --save-every 1000
# Phase 2: frozen backbone, 6k @ 2e-3.
"${MBW[@]}" --out "${OUT}_p2.pth" --steps 6000 \
    --lr 2e-3 --load "${OUT}_p1.pth" --eval-images 64 --save-every 1000
# Phase 3: frozen backbone, 8k @ 1e-3.
"${MBW[@]}" --out "${OUT}.pth" --steps 8000 \
    --lr 1e-3 --load "${OUT}_p2.pth" --eval-images 128 --save-every 1000

if [[ "${2:-}" == "--second-recipe" ]]; then
    # One joint fine-tune phase on top of the converged frozen recipe.
    "${MBW[@]}" --out "${OUT}_joint4.pth" --steps 3000 \
        --lr 5e-4 --train-backbone --load "${OUT}.pth" --eval-images 128 \
        --save-every 500
fi

# Numerics ablation at the trained operating point. The JAX recipe also
# runs state32_xla, its kernels switched off; the port has no such route.
python -m snn_automotive_object_detection_tpu_torch.tools.ablate_bf16 \
    --load "${OUT}.pth" --images 256 --variants fp32,state32,bf16 --out ABLATION_chain.jsonl
