"""The benchmark's plain reference of the hybrid ANN/SNN Faster R-CNN.

``model.py`` is a float32 forward pass in plain PyTorch operations, written
from the released checkpoints' semantics (torchvision 0.13 Faster R-CNN with
the reference's spiking RPN and box heads, norse 0.0.7 neuron dynamics): no
kernel, no CUDA graph, no cache, and nothing imported from the program under
test. It reads the torchvision-layout state dict that ``bench_cuda/weights.py``
makes, and works out for itself everything the program derives from it.
"""
