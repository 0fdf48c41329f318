"""Box-head encoder + fc6 through the hand-written CUDA kernel (K3).

Replaces ``snn/pallas_fc6.py`` (``encoder_fc6_pallas``). The kernel is
``csrc/encoder_fc6.cu`` (a code pass, then the spike-code GEMM of
``csrc/spike_gemm.cuh``); :func:`encoder_fc6_plain` is its plain PyTorch
version: threshold-count encoder periods, then cur6[t] = z_t @ w6 in float32
for every step. :func:`encoder_codes_plain` is the plain version of the
kernel's first pass alone, the spike train of each element as a code. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel (bf16 x
and w6) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

NAME = "encoder_fc6"
MAX_T = 16


def _thresholds(num_steps: int, device) -> torch.Tensor:
    return device_constant(tuple(snnf.encoder_thresholds(num_steps).tolist()),
                           torch.float32, device)


def encoder_fc6_plain(x: torch.Tensor, w6: torch.Tensor, num_steps: int):
    """x [R, D] in the compute dtype; w6 [D, rep]. Returns (cur6 [T, R, rep]
    float32, encoder spike counts [R] int64)."""
    cb.note_plain(NAME, x)
    thr = _thresholds(num_steps, x.device)
    periods = snnf.threshold_periods(x.float(), thr)
    wf = w6.to(x.dtype).float()
    cur6 = torch.empty((num_steps, x.shape[0], w6.shape[1]), dtype=torch.float32,
                       device=x.device)
    counts = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for t in range(num_steps):
        z = snnf.encoder_spikes_at(periods, t)
        cur6[t] = torch.matmul(z, wf)
        counts += z.sum(dim=1, dtype=torch.int64)
    return cur6, counts


def encoder_codes_plain(x: torch.Tensor, num_steps: int):
    """The kernel's code pass: x [R, D]. Returns (codes [R, D] int32, bit t
    set where the element's encoder spikes at step t; encoder spike counts
    [R] int64)."""
    periods = snnf.threshold_periods(x.float(), _thresholds(num_steps, x.device))
    codes = torch.zeros_like(periods)
    counts = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for t in range(num_steps):
        z = snnf.encoder_spikes_at(periods, t, torch.int32)
        codes |= z << t
        counts += z.sum(dim=1, dtype=torch.int64)
    return codes, counts


def _launch(x: torch.Tensor, w6: torch.Tensor, num_steps: int):
    r, d = x.shape
    rep = w6.shape[1]
    cb.require(x, "x", torch.bfloat16)
    cb.require(w6, "w6", torch.bfloat16, (d, rep))
    if d % 64 or rep % 128 or not 1 <= num_steps <= MAX_T:
        raise ValueError(f"encoder_fc6 kernel takes D % 64 == 0, rep % 128 == 0 "
                         f"and T <= {MAX_T}; got D={d}, rep={rep}, T={num_steps}")
    thr = _thresholds(num_steps, x.device)
    cur6 = torch.empty((num_steps, r, rep), dtype=torch.float32, device=x.device)
    counts = torch.empty(r, dtype=torch.int32, device=x.device)   # one store per row
    codes = torch.empty((r, d), dtype=torch.int16, device=x.device)
    fn = cb.function(NAME, "encoder_fc6_bf16",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    code = fn(x.data_ptr(), w6.data_ptr(), thr.data_ptr(), cur6.data_ptr(),
              counts.data_ptr(), codes.data_ptr(), r, d, rep, num_steps,
              cb.stream_ptr(x.device))
    cb.check(code, NAME)
    cb.LAUNCHES[NAME] += 1
    return cur6, counts.long()


def encoder_fc6(x: torch.Tensor, w6: torch.Tensor, num_steps: int):
    """Kernel (CUDA) or plain version (CPU); see :func:`encoder_fc6_plain`."""
    if cb.dispatch_device(x, NAME):
        return _launch(x, w6.to(torch.bfloat16).contiguous(), num_steps)
    return encoder_fc6_plain(x, w6, num_steps)
