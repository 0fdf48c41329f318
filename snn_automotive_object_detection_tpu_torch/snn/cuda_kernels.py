"""The whole spiking box head in one call, through the hand-written CUDA
kernel (K9).

Replaces ``snn/pallas_kernels.py`` (``fastrcnn_snn_pallas``): encoder
spikes from the closed-form periods, fc6, LIF6, fc7, LIF7 and the cls and
bbox LI readouts for all T steps, with the per-RoI fc6 and fc7 spike rates.
The kernel is ``csrc/box_head_fused.cu``: four passes of one call, the
periods to spike-train codes, then the spike-code GEMM of
``csrc/spike_gemm.cuh`` on w6 and on w7 with an f32 LIF epilogue each and
on the cls|bbox readout with an f32 LI epilogue. :func:`fastrcnn_snn_plain`
is its plain PyTorch version with the same numerics: bf16 matmul operands,
f32 sums that go into the neurons unrounded, f32 states. It is
:func:`fc6_trains_plain` followed by :func:`box_tail_f32_plain`, which a
check can also run on the kernel's own fc6 spikes; :func:`period_codes_plain`
is the plain version of the first pass. These are not the numerics of the
two-kernel route (``snn/cuda_fc6.py`` then ``snn/cuda_tail.py``), which
rounds every product once to bf16 and takes the threshold-count encoder
periods; the detector keeps that route, as the reference does, and this
module is an entry point of its own.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(representation size 1024, at most 64 readout columns, T <= 254 and K a
multiple of 64, the GEMM's stage depth) or raises. A spike train is kept as
codes of 16 steps each: codes [P, R, N], P = ceil(T / 16), bit t - 16 h of
plane h set where the neuron spikes at step t. The kernel runs each GEMM
pass once per plane and carries the LIF and LI states from one plane to
the next, so it takes any T the reference kernel takes: the periods are
uint8 with 255 for "never", which bounds T at 254 on both.
"""

from __future__ import annotations

import ctypes

import torch

from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.snn.cuda_fc6 import PLANE_STEPS, planes
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

NAME = "box_head_fused"
REP = 1024
MAX_OUT = 64
K_STAGE = 64        # k per stage of the spike-code GEMM
ROWS = 16           # RoI rows per block of the GEMM
SMEM_LIMIT = 232448
MAX_T = snnf.NEVER - 1   # a step t + 1 = 255 would read "never" as a period


def smem_bytes(n_cols: int, stages: int, staging_in_ring: bool) -> int:
    """Shared memory of one block of a K9 GEMM pass with ``n_cols`` output
    columns (128 for fc6 and fc7, 64 for the readout) and a ring of
    ``stages``, as ``sgemm_host::smem_bytes`` in csrc/spike_gemm.cuh
    computes it (:func:`smem_on_card` asks the C side): the alignment
    slack, the ring (each slot a 64-deep weight stage plus the block's
    16 x 64 codes), the f32 staging of 16 rows x 16 steps (one code plane)
    x (n_cols + 8) unless it overlays the drained ring, and the full and
    empty barriers."""
    ring = stages * (n_cols * K_STAGE * 2 + ROWS * K_STAGE * 2)
    staging = PLANE_STEPS * ROWS * (n_cols + 8) * 4
    if staging_in_ring and staging > ring:
        raise ValueError(f"{staging} bytes of staging do not fit in a {ring}-byte ring")
    return 1024 + ring + (0 if staging_in_ring else staging) + 2 * stages * 8


def smem_on_card():
    """Shared memory per block that the kernel's fc6/fc7 passes and its
    readout pass launch with, as the C side computes it:
    (bytes, bytes)."""
    out = (ctypes.c_int * 2)()
    fn = cb.function(NAME, "box_head_fused_smem", [ctypes.c_void_p])
    cb.check(fn(ctypes.addressof(out)), NAME)
    return out[0], out[1]


def period_codes_plain(periods: torch.Tensor, num_steps: int) -> torch.Tensor:
    """The kernel's first pass: encoder periods [R, K] (uint8, 255 = never)
    to spike-train codes [P, R, K] int32, bit t - 16 h of plane h set when
    (t + 1) % p == 0."""
    return codes_of(torch.stack([snnf.encoder_spikes_at(periods, t)
                                 for t in range(num_steps)]))


def codes_of(trains: torch.Tensor) -> torch.Tensor:
    """Spike trains [T, R, N] (0/1) -> codes [P, R, N] int32, P = ceil(T /
    16): bit t - 16 h of plane h the spike at step t."""
    codes = torch.zeros((planes(trains.shape[0]), *trains.shape[1:]), dtype=torch.int32,
                        device=trains.device)
    for t, s in enumerate(trains):
        codes[t // PLANE_STEPS] |= (s > 0).to(torch.int32) << (t % PLANE_STEPS)
    return codes


def trains_of(codes: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Codes [P, R, N] (any integer dtype, the kernel's int16 planes too;
    bit t - 16 h of plane h the spike at step t) -> spike trains [T, R, N]
    float32."""
    return torch.stack([((codes[t // PLANE_STEPS].int() >> (t % PLANE_STEPS)) & 1).float()
                        for t in range(num_steps)])


def fc6_trains_plain(x: torch.Tensor, w6: torch.Tensor, num_steps: int) -> torch.Tensor:
    """The encoder and LIF6 over the T steps: x [R, K] flattened RoI
    features (any float dtype), w6 [K, H]. Returns the fc6 spikes [T, R, H]
    float32, from z_t @ bf16(w6) summed in f32 and taken unrounded."""
    periods = snnf.encoder_periods(x)
    w6 = w6.to(torch.bfloat16).float()
    l6 = snnf.zeros_lif_state((x.shape[0], w6.shape[1]), device=x.device)
    trains = []
    for t in range(num_steps):
        s6, l6 = snnf.lif_feed_forward_step(
            torch.matmul(snnf.encoder_spikes_at(periods, t), w6), l6)
        trains.append(s6)
    return torch.stack(trains)


def box_tail_f32_plain(s6: torch.Tensor, w7: torch.Tensor, wc: torch.Tensor,
                       wb: torch.Tensor):
    """fc7, LIF7 and the two LI readouts in f32 on bf16-valued weights, from
    the fc6 spikes s6 [T, R, H] (0/1). Returns (class logits [R, C] f32,
    box deltas [R, B] f32, fc7 spikes [T, R, H] f32)."""
    w7, wc, wb = (w.to(torch.bfloat16).float() for w in (w7, wc, wb))
    r, dev = s6.shape[1], s6.device
    l7 = snnf.zeros_lif_state((r, w7.shape[1]), device=dev)
    li_c = snnf.zeros_li_state((r, wc.shape[1]), device=dev)
    li_b = snnf.zeros_li_state((r, wb.shape[1]), device=dev)
    trains = []
    for s in s6:
        s7, l7 = snnf.lif_feed_forward_step(torch.matmul(s, w7), l7)
        _, li_c = snnf.li_feed_forward_step(torch.matmul(s7, wc), li_c)
        _, li_b = snnf.li_feed_forward_step(torch.matmul(s7, wb), li_b)
        trains.append(s7)
    return li_c.v, li_b.v, torch.stack(trains)


def fastrcnn_snn_plain(x: torch.Tensor, w6: torch.Tensor, w7: torch.Tensor,
                       wc: torch.Tensor, wb: torch.Tensor, num_steps: int):
    """x [R, K] flattened RoI features (any float dtype); w6 [K, H]; w7
    [H, H]; wc [H, C]; wb [H, B]. Returns (class logits [R, C] f32, box
    deltas [R, B] f32, fc6 rate [R] f32, fc7 rate [R] f32); the rates are
    mean spikes per neuron and step."""
    cb.note_plain(NAME, x)
    s6 = fc6_trains_plain(x, w6, num_steps)
    cls, reg, s7 = box_tail_f32_plain(s6, w7, wc, wb)
    denom = float(num_steps * w6.shape[1])
    c6 = s6.sum(dim=(0, 2), dtype=torch.int64)
    c7 = s7.sum(dim=(0, 2), dtype=torch.int64)
    return cls, reg, (c6.double() / denom).float(), (c7.double() / denom).float()


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch(periods: torch.Tensor, w6: torch.Tensor, w7: torch.Tensor,
            wro: torch.Tensor, n_cls: int, num_steps: int, codes: bool = False):
    """K9 on the encoder periods [R, K] uint8. Returns (cls, reg, fc6 spike
    counts [R] int64, fc7 spike counts [R] int64); with ``codes`` also the
    fc6 and fc7 spike trains as the kernel's code planes [P, R, H] int16
    (see :func:`trains_of`), which checks compare step by step."""
    r, d = periods.shape
    rep, n_out = wro.shape
    cb.require(periods, "periods", torch.uint8)
    if rep != REP or n_out > MAX_OUT or d % K_STAGE or not 1 <= num_steps <= MAX_T:
        raise ValueError(
            f"box_head_fused kernel takes rep={REP}, at most {MAX_OUT} readout "
            f"columns, K % {K_STAGE} == 0 and T <= {MAX_T}; got rep={rep}, {n_out} "
            f"columns, K={d}, T={num_steps}")
    cb.require(w6, "w6", torch.bfloat16, (d, rep))
    cb.require(w7, "w7", torch.bfloat16, (rep, rep))
    cb.require(wro, "w_readout", torch.bfloat16, (rep, n_out))
    if n_out % 8:   # 16-byte weight rows for the kernel's TMA loads
        wro = torch.nn.functional.pad(wro, (0, 8 - n_out % 8))
    dev = periods.device
    out = torch.empty((r, n_out), dtype=torch.float32, device=dev)
    counts = torch.zeros((r, 2), dtype=torch.int32, device=dev)
    n_planes = planes(num_steps)
    code_x = torch.empty((n_planes, r, d), dtype=torch.int16, device=dev)
    code67 = torch.empty((2, n_planes, r, rep), dtype=torch.int16, device=dev)
    state = torch.empty((2, r, rep) if n_planes > 1 else (0,), dtype=torch.float32, device=dev)
    fn = cb.function(NAME, "box_head_fused_bf16", _ARGTYPES)
    cb.launch(NAME, fn, [periods.data_ptr(), w6.data_ptr(), w7.data_ptr(), wro.data_ptr(),
                         out.data_ptr(), counts.data_ptr(), code_x.data_ptr(),
                         code67[0].data_ptr(), code67[1].data_ptr(), state.data_ptr(), r, d,
                         num_steps, n_out], dev)
    counts = counts.long()
    got = (out[:, :n_cls], out[:, n_cls:], counts[:, 0], counts[:, 1])
    return got + (code67[0], code67[1]) if codes else got


def launch_args(x: torch.Tensor, w6: torch.Tensor, w7: torch.Tensor, wc: torch.Tensor,
                wb: torch.Tensor):
    """The kernel's inputs from :func:`fastrcnn_snn_cuda`'s: (encoder periods
    [R, K] uint8, w6 and w7 in bf16, the cls|bbox readout [H, C + B] bf16,
    C)."""
    if not x.is_floating_point():
        raise TypeError(f"x: expected a float tensor, got {x.dtype}")
    bf = torch.bfloat16
    return (snnf.encoder_periods(x).contiguous(), w6.to(bf).contiguous(),
            w7.to(bf).contiguous(), torch.cat([wc, wb], dim=1).to(bf).contiguous(), wc.shape[1])


def fastrcnn_snn_cuda(x: torch.Tensor, w6: torch.Tensor, w7: torch.Tensor,
                      wc: torch.Tensor, wb: torch.Tensor, num_steps: int):
    """The fused spiking box head: the kernel (CUDA) or its plain version
    (CPU). Arguments and returns of :func:`fastrcnn_snn_plain`."""
    if not cb.dispatch_device(x, NAME):
        return fastrcnn_snn_plain(x, w6, w7, wc, wb, num_steps)
    cls, reg, c6, c7 = _launch(*launch_args(x, w6, w7, wc, wb), num_steps)
    denom = float(num_steps * w6.shape[1])
    return cls, reg, (c6.double() / denom).float(), (c7.double() / denom).float()
