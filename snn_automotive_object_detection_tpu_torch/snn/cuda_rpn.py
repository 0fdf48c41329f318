"""Spiking RPN head through the hand-written CUDA kernel (K1).

Replaces ``snn/pallas_rpn.py`` (``rpn_head_snn_pallas_apply`` and its
per-level ``_run_level``). The kernel is ``csrc/rpn_head.cu``;
:func:`rpn_level_plain` beside it is its plain PyTorch version and follows
the TPU kernel's formulation: threshold-count encoder periods, the conv
current rounded to the plane dtype, f32 LIF states, an LI-weighted spike
sum with :func:`snnf.li_coefficients` and one fused readout after the
loop, rounded to the plane dtype.

A CPU tensor takes the plain version (bf16 or f32 planes); a CUDA tensor
launches the kernel, which takes bf16 planes only, or raises.
"""

from __future__ import annotations

import ctypes
import torch
import torch.nn.functional as F

from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

NAME = "rpn_head"
MAX_T = 32
MAX_OUT = 64


def _constants(num_steps: int, device) -> torch.Tensor:
    """[2T] float32 on ``device``: the encoder thresholds, then the LI
    coefficients."""
    return device_constant(tuple(snnf.encoder_thresholds(num_steps).tolist())
                           + tuple(snnf.li_coefficients(num_steps).tolist()),
                           torch.float32, device)


def rpn_level_plain(feat: torch.Tensor, w_shared: torch.Tensor,
                    w_out: torch.Tensor, num_steps: int, spike_sum: bool = False):
    """One FPN level, plain PyTorch.

    feat [N, H, W, C] in the plane dtype (bf16 or f32); w_shared
    [3, 3, C, C] HWIO; w_out [C, n_out]. Returns (readout [N, H, W, n_out]
    float32 holding plane-dtype values, encoder counts [N] int64, LIF spike
    counts [N] int64), and with ``spike_sum`` also the LI-weighted spike sum
    [N, H, W, C] f32 of every neuron, for checks that count flipped spikes
    neuron by neuron.
    """
    cb.note_plain(NAME, feat)
    cd = feat.dtype
    n, h, w, c = feat.shape
    consts = _constants(num_steps, feat.device)
    thr, li = consts[:num_steps], consts[num_steps:]
    periods = snnf.threshold_periods(feat.float(), thr)
    weight = w_shared.to(cd).permute(3, 2, 0, 1).contiguous()
    state = snnf.zeros_lif_state((n, h, w, c), device=feat.device)
    ssum = torch.zeros((n, h, w, c), dtype=torch.float32, device=feat.device)
    enc = torch.zeros(n, dtype=torch.int64, device=feat.device)
    lif = torch.zeros(n, dtype=torch.int64, device=feat.device)
    for t in range(num_steps):
        z = snnf.encoder_spikes_at(periods, t, cd)
        cur = F.conv2d(z.permute(0, 3, 1, 2), weight, padding=1)
        cur = cur.permute(0, 2, 3, 1).float()
        s, state = snnf.lif_feed_forward_step(cur, state)
        ssum = ssum + li[t] * s
        enc += z.sum(dim=(1, 2, 3), dtype=torch.int64)
        lif += s.sum(dim=(1, 2, 3), dtype=torch.int64)
    out = torch.matmul(ssum, w_out.to(cd).float()).to(cd).float()
    return (out, enc, lif, ssum) if spike_sum else (out, enc, lif)


def _launch(feat: torch.Tensor, w9: torch.Tensor, w_out: torch.Tensor,
            num_steps: int, spike_sum: bool = False):
    n, h, w, c = feat.shape
    n_out = w_out.shape[1]
    cb.require(feat, "feat", torch.bfloat16)
    if c != 256:
        raise ValueError(f"rpn_head kernel takes 256 channels, got {c}")
    cb.require(w9, "w9", torch.bfloat16, (9, c, c))
    cb.require(w_out, "w_out", torch.bfloat16, (c, n_out))
    if not 1 <= num_steps <= MAX_T or n_out > MAX_OUT:
        raise ValueError(f"rpn_head kernel takes T <= {MAX_T} and at most "
                         f"{MAX_OUT} readout channels")
    consts = _constants(num_steps, feat.device)
    out = torch.empty((n, h, w, n_out), dtype=torch.float32, device=feat.device)
    counts = torch.zeros((n, 2), dtype=torch.int64, device=feat.device)
    ssum = (torch.empty((n, h, w, c), dtype=torch.float32, device=feat.device)
            if spike_sum else None)
    fn = cb.load(NAME).rpn_level_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    code = fn(feat.data_ptr(), w9.data_ptr(), w_out.data_ptr(), consts.data_ptr(),
              out.data_ptr(), counts.data_ptr(),
              None if ssum is None else ssum.data_ptr(), n, h, w, num_steps,
              n_out, cb.stream_ptr(feat.device))
    cb.check(code, NAME)
    cb.LAUNCHES[NAME] += 1
    if spike_sum:
        return out, counts[:, 0], counts[:, 1], ssum
    return out, counts[:, 0], counts[:, 1]


def rpn_level(feat: torch.Tensor, w_shared: torch.Tensor, w_out: torch.Tensor,
              num_steps: int, spike_sum: bool = False):
    """One level through the kernel (CUDA) or the plain version (CPU).
    Same returns as :func:`rpn_level_plain`."""
    if cb.dispatch_device(feat, NAME):
        c = w_shared.shape[2]
        w9 = w_shared.reshape(9, c, c).to(torch.bfloat16).contiguous()
        return _launch(feat, w9, w_out.to(torch.bfloat16).contiguous(),
                       num_steps, spike_sum)
    return rpn_level_plain(feat, w_shared, w_out, num_steps, spike_sum)

