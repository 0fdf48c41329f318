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


@functools.lru_cache(maxsize=256)
def device_constant(values: Hashable, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, cached.
    ``values`` is a number or a (nested) tuple of numbers."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)
