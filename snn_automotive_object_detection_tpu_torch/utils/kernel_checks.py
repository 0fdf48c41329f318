"""Bounds that hold a kernel's output against its plain version, shared by
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``.

Both sides of K1's readout and K4's readout currents sum the same 0/1
spikes times bf16 weights in f32 and round the sum once to bf16; summed in
another order, the two may round one bf16 ulp apart, which is at most 2^-7
of the value (``BF16_REL``). ``ATOL`` covers sums that cancel to near
zero, and K4's f32 LI states integrating such a current over T steps.
"""

from __future__ import annotations

import torch

BF16_REL = 2.0 ** -7
ATOL = 1e-4


def excess(got: torch.Tensor, want: torch.Tensor, atol: float = ATOL,
           rtol: float = BF16_REL) -> float:
    """max over elements of |got - want| / (rtol |want| + atol); the
    elementwise bound holds when this is at most 1."""
    if want.numel() == 0:
        return 0.0
    return float(((got - want).abs() / (rtol * want.abs() + atol)).max())


def bf16_valued(x: torch.Tensor) -> bool:
    """True when every element of the f32 tensor ``x`` is a bf16 value."""
    return torch.equal(x, x.to(torch.bfloat16).float())
