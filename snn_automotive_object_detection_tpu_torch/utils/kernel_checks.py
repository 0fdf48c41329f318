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
MAX_DIFFERING = 0.01   # share of elements that may differ at all, see differing()


def excess(got: torch.Tensor, want: torch.Tensor, atol=ATOL,
           rtol: float = BF16_REL) -> float:
    """max over elements of |got - want| / (rtol |want| + atol); the
    elementwise bound holds when this is at most 1. ``atol`` is a number or
    a tensor that broadcasts against ``want``."""
    if want.numel() == 0:
        return 0.0
    return float(((got - want).abs() / (rtol * want.abs() + atol)).max())


def bf16_valued(x: torch.Tensor) -> bool:
    """True when every element of the f32 tensor ``x`` is a bf16 value."""
    return torch.equal(x, x.to(torch.bfloat16).float())


def chain_excess(got: torch.Tensor, want: torch.Tensor, roundings: int,
                 addends=()) -> float:
    """:func:`excess` for an output that a bf16-rounded product sum reaches
    through bf16 adds (K5's merged map and P, K6's activation).

    Summed in another order, the product sum may round one bf16 ulp apart,
    at most 2^-7 of its own magnitude; that magnitude is bounded by |want|
    plus the |addends| (the other operands of the adds, which may cancel
    it, so the error is not relative to |want| alone). Each later rounding
    can move the two sides one more ulp of its own result apart, which
    ``roundings`` counts (the sum's own included). The bound per element is
    2^-7 (roundings |want| + sum |addends|) + ATOL; addends broadcast
    against ``want``."""
    extra = sum((a.float().abs() for a in addends), torch.zeros((), device=want.device))
    return excess(got.float(), want.float(), atol=ATOL + BF16_REL * extra,
                  rtol=roundings * BF16_REL)


def differing(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many elements differ at all. Sums in another order flip a bf16
    rounding in well under 1% of the elements; a rounding made at another
    place in the chain flips it in far more."""
    return int((got != want).sum())

