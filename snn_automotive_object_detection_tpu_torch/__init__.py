"""PyTorch/CUDA port of the spiking Faster R-CNN (inference slice).

Imports torch only; the JAX package beside it is the reference.
"""
