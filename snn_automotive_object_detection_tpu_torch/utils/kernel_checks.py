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
GRAD_REL = 5e-4        # see grad_excess()


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



def grad_excess(got: torch.Tensor, want: torch.Tensor, rel: float = GRAD_REL) -> float:
    """max |got - want| / (rel * max |want|) for K7's weight gradients; the
    bound holds when this is at most 1, and anything not finite is
    infinitely far outside it.

    Kernel and plain version replay the same spikes and run the reverse
    sweep operation for operation, and the kernel's dw9 is within 3e-6 of
    the largest element of an f64 sum over its own bf16 ``dc`` planes. What
    differs are those planes: at flagship shapes up to 3 of 590,000 elements
    per step round to the neighbouring bf16 value (most likely from the
    replayed conv currents: sums taken in another order round a current to
    the neighbouring bf16 value now and then, which moves a stored membrane,
    too little to flip a spike, and with it the surrogate's slope). One such
    element moves every dw9 element it
    is a term of by its bf16 ulp, 2^-8 of the term, and dw9's largest
    element, a sum that mostly cancels, is only 25 to 100 of the largest
    terms: 3e-5 to 1.4e-4 of the largest element, measured. So the bound is
    a share of the gradient's largest element, 5e-4. A wrong step of the
    reverse sweep or a wrong tap moves the gradient by a third of its size
    or more (``chip_mutants.py``)."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return float("inf")
    top = float(want.abs().max())
    if top == 0.0:
        return 0.0 if float(got.abs().max()) == 0.0 else float("inf")
    return float((got - want).abs().max()) / (rel * top)


# sqrt(area) at which torchvision's level mapper (canonical 224 at level 4)
# moves from one FPN level to the next.
LEVEL_BORDERS = (112.0, 224.0, 448.0)


def _f32_step(x: float, up: bool) -> float:
    """The neighbouring float32 value of ``x`` (x > 0) above or below."""
    import numpy as np

    return float(np.nextafter(np.float32(x), np.float32(np.inf if up else 0.0)))


def level_border_boxes(mapper, device, x0: float = 64.0, y0: float = 32.0) -> torch.Tensor:
    """Boxes on the level mapper's borders, [K, 4] float32 on ``device``.

    For each of :data:`LEVEL_BORDERS` s: the square boxes at the origin of
    side s and of the float32 value below s; and the two boxes
    [x0, y0, x0 + w, y0 + 64] of neighbouring float32 widths w between which
    ``mapper`` (boxes [K, 4] -> levels [K]) moves to the next level, found by
    bisection over the float32 widths on ``device``. A mapper that computes
    the level in other float operations puts some of these boxes on the
    other side of a border."""
    rows = []
    for s in LEVEL_BORDERS:
        for side in (s, _f32_step(s, up=False)):
            rows.append([0.0, 0.0, side, side])

        def box(w):
            return torch.tensor([[x0, y0, x0 + w, y0 + 64.0]], dtype=torch.float32,
                                device=device)

        lo, hi = s * s / 64.0 * 0.99, s * s / 64.0 * 1.01
        lv_lo = int(mapper(box(lo))[0])
        if int(mapper(box(hi))[0]) == lv_lo:
            raise ValueError(f"no level border between widths {lo} and {hi}")
        while _f32_step(lo, up=True) < hi:
            mid = float(torch.tensor((lo + hi) / 2.0, dtype=torch.float32))
            if mid in (lo, hi):
                mid = _f32_step(lo, up=True)
            if int(mapper(box(mid))[0]) == lv_lo:
                lo = mid
            else:
                hi = mid
        rows += box(lo).tolist() + box(hi).tolist()
    return torch.tensor(rows, dtype=torch.float32, device=device)
