"""Spiking box-head tail through the hand-written CUDA kernel (K4).

Replaces ``snn/pallas_tail.py`` (``box_tail_pallas``): LIF6 -> fc7 -> LIF7
-> cls/bbox LI readouts over T steps on precomputed fc6 currents. The
kernel is ``csrc/box_tail.cu``: three passes of one launch, a LIF6 scan
that writes each neuron's spike train as a code (bit t), then the
spike-code GEMM of ``csrc/spike_gemm.cuh`` on w7 with LIF7 in its epilogue
and on the cls|bbox readout with the LI scan in its epilogue.
:func:`box_tail_plain` is its plain PyTorch version with the same numerics:
f32 states, each matmul result rounded once to the compute dtype;
:func:`lif6_codes_plain`, :func:`fc7_lif_codes_plain` and
:func:`readout_plain` are the plain versions of the three passes, whose
composition gives :func:`box_tail_plain`'s bits. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel (bf16 currents and
weights, rep a multiple of 128) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

NAME = "box_tail"
MAX_T = 16


def box_tail_plain(cur6: torch.Tensor, w7: torch.Tensor, wc: torch.Tensor,
                   wb: torch.Tensor):
    """cur6 [T, R, rep] in the compute dtype; w7 [rep, rep]; wc [rep, n_cls];
    wb [rep, n_reg]. Returns (cls [R, n_cls] f32, bbox [R, n_reg] f32, fc6
    spike counts [R] int64, fc7 spike counts [R] int64)."""
    cb.note_plain(NAME, cur6)
    cd = cur6.dtype
    _, r, rep = cur6.shape
    dev = cur6.device
    w7, wc, wb = w7.to(cd), wc.to(cd), wb.to(cd)
    l6 = snnf.zeros_lif_state((r, rep), device=dev)
    l7 = snnf.zeros_lif_state((r, rep), device=dev)
    li_c = snnf.zeros_li_state((r, wc.shape[1]), device=dev)
    li_b = snnf.zeros_li_state((r, wb.shape[1]), device=dev)
    c6 = torch.zeros(r, dtype=torch.int64, device=dev)
    c7 = torch.zeros(r, dtype=torch.int64, device=dev)
    for cur in cur6:
        s6, l6 = snnf.lif_feed_forward_step(cur.float(), l6)
        s7, l7 = snnf.lif_feed_forward_step(
            torch.matmul(s6.to(cd), w7).float(), l7)
        _, li_c = snnf.li_feed_forward_step(
            torch.matmul(s7.to(cd), wc).float(), li_c)
        _, li_b = snnf.li_feed_forward_step(
            torch.matmul(s7.to(cd), wb).float(), li_b)
        c6 += s6.sum(dim=1, dtype=torch.int64)
        c7 += s7.sum(dim=1, dtype=torch.int64)
    return li_c.v, li_b.v, c6, c7


def _spikes(codes: torch.Tensor, t: int, dtype) -> torch.Tensor:
    return ((codes >> t) & 1).to(dtype)


def _codes_and_counts(spikes):
    """Per-step spikes [R, N] of a layer -> (codes [R, N] int32, bit t the
    spike at step t; spikes per row [R] int64)."""
    codes = torch.zeros(spikes[0].shape, dtype=torch.int32, device=spikes[0].device)
    counts = torch.zeros(spikes[0].shape[0], dtype=torch.int64, device=spikes[0].device)
    for t, s in enumerate(spikes):
        codes |= (s > 0).to(torch.int32) << t
        counts += s.sum(dim=1, dtype=torch.int64)
    return codes, counts


def lif6_codes_plain(cur6: torch.Tensor):
    """Pass (a): LIF6 over the steps of cur6 [T, R, rep]. Returns (codes
    [R, rep] int32, fc6 spike counts [R] int64)."""
    l6 = snnf.zeros_lif_state(cur6.shape[1:], device=cur6.device)
    spikes = []
    for cur in cur6:
        s6, l6 = snnf.lif_feed_forward_step(cur.float(), l6)
        spikes.append(s6)
    return _codes_and_counts(spikes)


def fc7_lif_codes_plain(codes6: torch.Tensor, w7: torch.Tensor, num_steps: int,
                        dtype):
    """Pass (b): LIF7 on dtype(s6_t @ w7) over the steps, s6_t the bits of
    codes6 [R, rep]. Returns (codes [R, rep] int32, fc7 spike counts [R]
    int64)."""
    w7 = w7.to(dtype)
    l7 = snnf.zeros_lif_state((codes6.shape[0], w7.shape[1]), device=codes6.device)
    spikes = []
    for t in range(num_steps):
        s7, l7 = snnf.lif_feed_forward_step(
            torch.matmul(_spikes(codes6, t, dtype), w7).float(), l7)
        spikes.append(s7)
    return _codes_and_counts(spikes)


def readout_plain(codes7: torch.Tensor, wc: torch.Tensor, wb: torch.Tensor,
                  num_steps: int, dtype):
    """Pass (c): the cls and bbox LI readouts on dtype(s7_t @ wc) and
    dtype(s7_t @ wb). Returns their final membranes ([R, n_cls], [R, n_reg]
    f32)."""
    wc, wb = wc.to(dtype), wb.to(dtype)
    r, dev = codes7.shape[0], codes7.device
    li_c = snnf.zeros_li_state((r, wc.shape[1]), device=dev)
    li_b = snnf.zeros_li_state((r, wb.shape[1]), device=dev)
    for t in range(num_steps):
        s7 = _spikes(codes7, t, dtype)
        _, li_c = snnf.li_feed_forward_step(torch.matmul(s7, wc).float(), li_c)
        _, li_b = snnf.li_feed_forward_step(torch.matmul(s7, wb).float(), li_b)
    return li_c.v, li_b.v


def _launch(cur6: torch.Tensor, w7: torch.Tensor, wro: torch.Tensor,
            n_cls: int):
    t, r, rep = cur6.shape
    n_out = wro.shape[1]
    cb.require(cur6, "cur6", torch.bfloat16)
    if rep % 128 or not 1 <= t <= MAX_T:
        raise ValueError(f"box_tail kernel takes rep % 128 == 0 and T <= {MAX_T}; "
                         f"got rep={rep}, T={t}")
    cb.require(w7, "w7", torch.bfloat16, (rep, rep))
    cb.require(wro, "w_readout", torch.bfloat16, (rep, n_out))
    if n_out % 8:   # 16-byte weight rows for the kernel's TMA loads
        wro = torch.nn.functional.pad(wro, (0, 8 - n_out % 8))
    out = torch.empty((r, n_out), dtype=torch.float32, device=cur6.device)
    counts = torch.zeros((r, 2), dtype=torch.int32, device=cur6.device)
    codes = torch.empty((2, r, rep), dtype=torch.int16, device=cur6.device)
    fn = cb.function(NAME, "box_tail_bf16",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    code = fn(cur6.data_ptr(), w7.data_ptr(), wro.data_ptr(), out.data_ptr(),
              counts.data_ptr(), codes[0].data_ptr(), codes[1].data_ptr(), r, t, rep,
              n_out, cb.stream_ptr(cur6.device))
    cb.check(code, NAME)
    cb.LAUNCHES[NAME] += 1
    counts = counts.long()
    return out[:, :n_cls], out[:, n_cls:], counts[:, 0], counts[:, 1]


def box_tail(cur6: torch.Tensor, w7: torch.Tensor, wc: torch.Tensor,
             wb: torch.Tensor):
    """Kernel (CUDA) or plain version (CPU); see :func:`box_tail_plain`."""
    if cb.dispatch_device(cur6, NAME):
        wro = torch.cat([wc, wb], dim=1).to(torch.bfloat16).contiguous()
        return _launch(cur6, w7.to(torch.bfloat16).contiguous(), wro,
                       wc.shape[1])
    return box_tail_plain(cur6, w7, wc, wb)
