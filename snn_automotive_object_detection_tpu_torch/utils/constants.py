"""Small constant tensors on a device, built once.

A copy from host memory to a CUDA device that is not ``non_blocking``
synchronises the stream, so a constant built from Python values at every
call stops the host from queueing work ahead of the device. These are
built once per (values, dtype, device) and shared: callers must not write
to them. They are made outside inference mode, so that a later caller
that records gradients can use them too.
"""

from __future__ import annotations

import functools
from typing import Hashable

import torch


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device`` with its index; None means the
    current CUDA device, and raises where there is none: the port runs on
    the card unless the caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: device=None means the CUDA device, and none is "
                f"available; pass device='cpu' to stay on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=256)
def device_constant(values: Hashable, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, cached.
    ``values`` is a number or a (nested) tuple of numbers."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)
