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


# K9, the fused box head (see box_head_fused_report).
SPIKE_FLIPS = 1e-3     # flipped spike-train bits, a share of the spikes, plus one
ROW_REL = 1e-3         # a row with equal fc7 trains: |got - want| <= ROW_REL (1 + |want|)
HEAD_REL = 0.25        # every row against the whole plain head
ROWS_DIFFERING = 0.01  # rows whose fc7 trains differ at all, a share of the rows, plus one


def _bits(codes: torch.Tensor) -> torch.Tensor:
    """Spikes per neuron of codes [P, R, N] (the low 16 bits of each plane,
    see ``cuda_kernels.trains_of``): [R, N] int64."""
    v = codes.long() & 0xFFFF
    return sum(((v >> t) & 1) for t in range(16)).sum(dim=0)


def box_head_fused_report(got, x, w6, w7, wc, wb, num_steps: int) -> dict:
    """K9's output ``got`` = (cls, reg, fc6 counts, fc7 counts, fc6 codes,
    fc7 codes), from ``cuda_kernels._launch(..., codes=True)`` (codes as
    code planes [P, R, H], see ``cuda_kernels.trains_of``), against its
    plain version on the same inputs, spike by spike.

    The kernel sums each current in another order than the plain version,
    so a membrane within a rounding of the threshold can spike a step
    earlier or later; such flips are counted per (row, neuron, step) and
    may be at most SPIKE_FLIPS of the plain version's spikes (plus one).
    fc6: K9's trains against ``fc6_trains_plain``. Then every row is held
    exactly: ``box_tail_f32_plain`` runs on K9's own fc6 spikes, its fc7
    trains are compared with K9's the same way, and where a row's fc7
    trains agree its logits and deltas must be within ROW_REL (1 + |want|)
    (the same spikes, f32 sums in another order); at most ROWS_DIFFERING
    of the rows (plus one) may differ in an fc7 spike. The whole head: every
    row within HEAD_REL (1 + |want|) of ``fastrcnn_snn_plain`` (which is
    ``box_tail_f32_plain`` on ``fc6_trains_plain``'s spikes). The counts
    must be the popcounts of the kernel's own codes. Returns the numbers
    and ``ok``."""
    from snn_automotive_object_detection_tpu_torch.snn import cuda_kernels as k9

    cls, reg, c6, c7, code6, code7 = got
    r = x.shape[0]
    s6 = k9.fc6_trains_plain(x, w6, num_steps)
    want_cls, want_reg, _ = k9.box_tail_f32_plain(s6, w7, wc, wb)
    own_cls, own_reg, own7 = k9.box_tail_f32_plain(k9.trains_of(code6, num_steps), w7, wc, wb)
    n6, n7 = int(s6.sum()), int(own7.sum())
    flips6 = int(_bits(code6.int() ^ k9.codes_of(s6)).sum())
    row_flips7 = _bits(code7.int() ^ k9.codes_of(own7)).sum(dim=1)
    flips7, rows7 = int(row_flips7.sum()), int((row_flips7 > 0).sum())
    counts_ok = bool(torch.equal(c6, _bits(code6).sum(dim=1))
                     and torch.equal(c7, _bits(code7).sum(dim=1)))
    clean = row_flips7 == 0

    def worst(a, b, rows, rel):
        if not bool(rows.any()):
            return 0.0
        return float(((a[rows] - b[rows]).abs() / (rel * (1.0 + b[rows].abs()))).max())

    ex_row = max(worst(cls, own_cls, clean, ROW_REL), worst(reg, own_reg, clean, ROW_REL))
    every = torch.ones_like(clean)
    ex_head = max(worst(cls, want_cls, every, HEAD_REL), worst(reg, want_reg, every, HEAD_REL))
    err = max(float((cls - want_cls).abs().max()), float((reg - want_reg).abs().max()))
    finite = bool(torch.isfinite(cls).all() and torch.isfinite(reg).all())
    ok = (finite and counts_ok and n6 > 0 and n7 > 0
          and flips6 <= SPIKE_FLIPS * n6 + 1 and flips7 <= SPIKE_FLIPS * n7 + 1
          and rows7 <= ROWS_DIFFERING * r + 1 and ex_row <= 1 and ex_head <= 1)
    return dict(ok=ok, rows=r, n6=n6, n7=n7, flips6=flips6, flips7=flips7, rows7=rows7,
                counts_ok=counts_ok, ex_row=ex_row, ex_head=ex_head, err=err,
                top=float(want_cls.abs().max()))


def box_head_fused_hold(x, w6, w7, wc, wb, num_steps: int) -> dict:
    """K9 on (x, w6, w7, wc, wb) on the card, held to its plain version:
    :func:`box_head_fused_report` on ``_launch(..., codes=True)``; the same
    bits on a second launch (``same``); and the entry point
    ``fastrcnn_snn_cuda`` on the same inputs giving that launch's logits
    and deltas, and its counts over T x 1024 as the rates (``entry_ok``).
    Returns the report with these, ``shapes_ok`` and ``ok`` over all."""
    from snn_automotive_object_detection_tpu_torch.snn import cuda_kernels as k9

    r = x.shape[0]
    args = k9.launch_args(x, w6, w7, wc, wb) + (num_steps,)
    got = k9._launch(*args, codes=True)
    again = k9._launch(*args, codes=True)
    entry = k9.fastrcnn_snn_cuda(x, w6, w7, wc, wb, num_steps)
    p = k9.planes(num_steps)
    shapes = ((r, wc.shape[1]), (r, wb.shape[1]), (r,), (r,), (p, r, k9.REP), (p, r, k9.REP))
    shapes_ok = all(tuple(a.shape) == s for a, s in zip(got, shapes))
    if not shapes_ok:
        return dict(ok=False, shapes_ok=False, shapes=[tuple(a.shape) for a in got])
    denom = float(num_steps * k9.REP)
    rates = [(c.double() / denom).float() for c in got[2:4]]
    entry_ok = all(torch.equal(a, b) for a, b in zip(entry, list(got[:2]) + rates))
    rep = box_head_fused_report(got, x, w6, w7, wc, wb, num_steps)
    rep.update(shapes_ok=True, entry_ok=entry_ok,
               same=all(torch.equal(a, b) for a, b in zip(got, again)),
               rate6=rep["n6"] / (denom * r), rate7=rep["n7"] / (denom * r))
    rep["ok"] = rep["ok"] and entry_ok and rep["same"]
    return rep


# The input on which K9's first check (fc6 and fc7 spike counts per row, not
# the trains) failed, at one fc6 spike a step late: chip_smoke.py's K9 phase
# drew it with box_head_inputs from the generator its kernel phases share,
# seeded K9_FAILURE_SEED, at the Philox offset K9_FAILURE_OFFSET that the
# phases before it had left (K2's two same-stride maps then drawn from the
# shared generator too). The plain version's fc6 spikes on it identify it.
K9_FAILURE_SEED = 1234
K9_FAILURE_OFFSET = 1504
K9_FAILURE_FC6_SPIKES = 3623053


def box_head_inputs(dev, g):
    """K9's inputs at the flagship shapes: x [2000, 12544] in the encoder's
    range, w6 [12544, 1024], w7 [1024, 1024] and the readouts for 9 classes
    [1024, 9] and [1024, 36], drawn from ``g`` on ``dev``."""

    def uniform(shape, scale):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) / scale

    x = torch.rand((2000, 12544), generator=g, device=dev) * 2.5
    return (x, uniform((12544, 1024), 112.0), uniform((1024, 1024), 32.0),
            uniform((1024, 9), 32.0), uniform((1024, 36), 32.0))


def k9_failure_input(dev):
    """The inputs (x, w6, w7, wc, wb) on which K9's first check failed; a
    check on them should find :data:`K9_FAILURE_FC6_SPIKES` plain fc6
    spikes (``n6`` of the report)."""
    g = torch.Generator(device=dev).manual_seed(K9_FAILURE_SEED)
    g.set_offset(K9_FAILURE_OFFSET)
    return box_head_inputs(dev, g)


def box_head_fused_line(rep: dict) -> str:
    """One line that states the numbers of :func:`box_head_fused_report`,
    and of :func:`box_head_fused_hold` where ``rep`` is its."""
    if not rep.get("shapes_ok", True):
        return f"outputs of shapes {rep['shapes']}"
    line = (f"fc6 spike-train bits flipped {rep['flips6']} of {rep['n6']} spikes "
            f"({rep['flips6'] / max(rep['n6'], 1):.2e}); on the kernel's own fc6 spikes, fc7 "
            f"bits flipped {rep['flips7']} of {rep['n7']} in {rep['rows7']} of {rep['rows']} "
            f"rows, the other rows' logits {rep['ex_row']:.3g} of the bound {ROW_REL} "
            f"(1 + |want|); against the whole plain head max|diff| {rep['err']:.3g} at "
            f"max|logit| {rep['top']:.4g}, {rep['ex_head']:.3g} of the bound {HEAD_REL} "
            f"(1 + |want|); counts the codes' popcounts {rep['counts_ok']}")
    if "entry_ok" not in rep:
        return line
    return (f"rates fc6 {rep['rate6']:.4f} fc7 {rep['rate7']:.4f}; {line}; the entry point's "
            f"outputs the launch's {rep['entry_ok']}; the same bits on a second launch "
            f"{rep['same']}")


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
