"""The whole spiking box head in one launch, through the hand-written CUDA
kernel (K9).

Replaces ``snn/pallas_kernels.py`` (``fastrcnn_snn_pallas``): encoder
spikes from the closed-form periods, fc6, LIF6, fc7, LIF7 and the cls and
bbox LI readouts for all T steps, with the per-RoI fc6 and fc7 spike rates.
The kernel is ``csrc/box_head_fused.cu``; :func:`fastrcnn_snn_plain` is its
plain PyTorch version with the same numerics: bf16 matmul operands, f32
sums that go into the neurons unrounded, f32 states. They are not the
numerics of the two-kernel route (``snn/cuda_fc6.py`` then
``snn/cuda_tail.py``), which rounds every product once to bf16 and takes
the threshold-count encoder periods; the detector keeps that route, as the
reference does, and this module is an entry point of its own.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(representation size 1024, at most 64 readout columns, T <= 16) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

NAME = "box_head_fused"
REP = 1024
MAX_OUT = 64
MAX_T = 16
ROW_TILE = 32


def fastrcnn_snn_plain(x: torch.Tensor, w6: torch.Tensor, w7: torch.Tensor,
                       wc: torch.Tensor, wb: torch.Tensor, num_steps: int):
    """x [R, K] flattened RoI features (any float dtype); w6 [K, H]; w7
    [H, H]; wc [H, C]; wb [H, B]. Returns (class logits [R, C] f32, box
    deltas [R, B] f32, fc6 rate [R] f32, fc7 rate [R] f32); the rates are
    mean spikes per neuron and step."""
    cb.note_plain(NAME, x)
    bf = torch.bfloat16
    r, rep = x.shape[0], w6.shape[1]
    dev = x.device
    periods = snnf.encoder_periods(x)
    w6, w7, wc, wb = (w.to(bf).float() for w in (w6, w7, wc, wb))
    l6 = snnf.zeros_lif_state((r, rep), device=dev)
    l7 = snnf.zeros_lif_state((r, rep), device=dev)
    li_c = snnf.zeros_li_state((r, wc.shape[1]), device=dev)
    li_b = snnf.zeros_li_state((r, wb.shape[1]), device=dev)
    c6 = torch.zeros(r, dtype=torch.int64, device=dev)
    c7 = torch.zeros(r, dtype=torch.int64, device=dev)
    for t in range(num_steps):
        z = snnf.encoder_spikes_at(periods, t)
        s6, l6 = snnf.lif_feed_forward_step(torch.matmul(z, w6), l6)
        s7, l7 = snnf.lif_feed_forward_step(torch.matmul(s6, w7), l7)
        _, li_c = snnf.li_feed_forward_step(torch.matmul(s7, wc), li_c)
        _, li_b = snnf.li_feed_forward_step(torch.matmul(s7, wb), li_b)
        c6 += s6.sum(dim=1, dtype=torch.int64)
        c7 += s7.sum(dim=1, dtype=torch.int64)
    denom = float(num_steps * rep)
    return li_c.v, li_b.v, (c6.double() / denom).float(), (c7.double() / denom).float()


def _launch(periods: torch.Tensor, w6: torch.Tensor, w7: torch.Tensor,
            wro: torch.Tensor, n_cls: int, num_steps: int):
    """K9 on the encoder periods [R, K] uint8. Returns (cls, reg, fc6 spike
    counts [R] int64, fc7 spike counts [R] int64)."""
    r, d = periods.shape
    rep, n_out = wro.shape
    cb.require(periods, "periods", torch.uint8)
    if rep != REP or n_out > MAX_OUT or d % 32 or not 1 <= num_steps <= MAX_T:
        raise ValueError(
            f"box_head_fused kernel takes rep={REP}, at most {MAX_OUT} readout "
            f"columns, K % 32 == 0 and T <= {MAX_T}; got rep={rep}, {n_out} "
            f"columns, K={d}, T={num_steps}")
    cb.require(w6, "w6", torch.bfloat16, (d, rep))
    cb.require(w7, "w7", torch.bfloat16, (rep, rep))
    cb.require(wro, "w_readout", torch.bfloat16, (rep, n_out))
    dev = periods.device
    r_pad = -(-r // ROW_TILE) * ROW_TILE
    s6 = torch.empty((num_steps, r_pad, rep), dtype=torch.bfloat16, device=dev)
    out = torch.empty((r, n_out), dtype=torch.float32, device=dev)
    # Spike counts [R, 2], then the grid barrier's counter.
    ints = torch.zeros(2 * r + 1, dtype=torch.int32, device=dev)
    fn = cb.function(NAME, "box_head_fused_bf16",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    code = fn(periods.data_ptr(), w6.data_ptr(), w7.data_ptr(), wro.data_ptr(),
              s6.data_ptr(), out.data_ptr(), ints.data_ptr(),
              ints.data_ptr() + 8 * r, r, d, num_steps, n_out, cb.stream_ptr(dev))
    cb.check(code, NAME)
    cb.LAUNCHES[NAME] += 1
    counts = ints[:2 * r].reshape(r, 2).long()
    return out[:, :n_cls], out[:, n_cls:], counts[:, 0], counts[:, 1]


def fastrcnn_snn_cuda(x: torch.Tensor, w6: torch.Tensor, w7: torch.Tensor,
                      wc: torch.Tensor, wb: torch.Tensor, num_steps: int):
    """The fused spiking box head: the kernel (CUDA) or its plain version
    (CPU). Arguments and returns of :func:`fastrcnn_snn_plain`."""
    if not cb.dispatch_device(x, NAME):
        return fastrcnn_snn_plain(x, w6, w7, wc, wb, num_steps)
    if not x.is_floating_point():
        raise TypeError(f"x: expected a float tensor, got {x.dtype}")
    bf = torch.bfloat16
    wro = torch.cat([wc, wb], dim=1).to(bf).contiguous()
    cls, reg, c6, c7 = _launch(
        snnf.encoder_periods(x).contiguous(), w6.to(bf).contiguous(),
        w7.to(bf).contiguous(), wro, wc.shape[1], num_steps)
    denom = float(num_steps * w6.shape[1])
    return cls, reg, (c6.double() / denom).float(), (c7.double() / denom).float()
