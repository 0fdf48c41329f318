"""Spiking box-head tail through the hand-written CUDA kernel (K4).

Replaces ``snn/pallas_tail.py`` (``box_tail_pallas``): LIF6 -> fc7 -> LIF7
-> cls/bbox LI readouts over T steps on precomputed fc6 currents. The
kernel is ``csrc/box_tail.cu``; :func:`box_tail_plain` is its plain PyTorch
version with the same numerics: f32 states, each matmul result rounded
once to the compute dtype. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel (bf16 currents and weights, rep 1024) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

NAME = "box_tail"
REP = 1024
MAX_OUT = 64


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


def _launch(cur6: torch.Tensor, w7: torch.Tensor, wro: torch.Tensor,
            n_cls: int):
    t, r, rep = cur6.shape
    n_out = wro.shape[1]
    cb.require(cur6, "cur6", torch.bfloat16)
    if rep != REP or n_out > MAX_OUT:
        raise ValueError(f"box_tail kernel takes rep={REP} and at most "
                         f"{MAX_OUT} readout columns; got {rep}, {n_out}")
    cb.require(w7, "w7", torch.bfloat16, (rep, rep))
    cb.require(wro, "w_readout", torch.bfloat16, (rep, n_out))
    out = torch.empty((r, n_out), dtype=torch.float32, device=cur6.device)
    counts = torch.zeros((r, 2), dtype=torch.int32, device=cur6.device)
    fn = cb.load(NAME).box_tail_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    code = fn(cur6.data_ptr(), w7.data_ptr(), wro.data_ptr(), out.data_ptr(),
              counts.data_ptr(), r, t, n_out, cb.stream_ptr(cur6.device))
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
