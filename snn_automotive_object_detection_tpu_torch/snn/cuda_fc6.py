"""Box-head encoder + fc6 through the hand-written CUDA kernel (K3), and
its training route with a spike-code weight-gradient kernel.

Replaces ``snn/pallas_fc6.py`` (``encoder_fc6_pallas``). The kernel is
``csrc/encoder_fc6.cu`` (a code pass, then the spike-code GEMM of
``csrc/spike_gemm.cuh``); :func:`encoder_fc6_plain` is its plain PyTorch
version: threshold-count encoder periods, then cur6[t] = z_t @ w6 in float32
for every step. :func:`encoder_codes_plain` is the plain version of the
kernel's first pass alone, the spike train of each element as a code. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel (bf16 x
and w6, T <= 32) or raises. Above 16 steps the kernel keeps each code as
two 16-bit planes and runs its GEMM once per plane.

Training (:class:`EncoderFc6Train`, the box head's encoder and fc6 while
the features are frozen): K3's training instance forward, whose code pass
carries the encoder's float32 membrane as ``snnf.lif_current_encoder``
does, as the training scan does (:func:`encoder_codes_train_plain`; the
threshold count differs from it at x = 2.5, where the membrane reaches
exactly 0.25 after one step), and rounds each product to bf16; it keeps
only the codes. Backward, dW6 = sum over steps of z_t^T dcur6_t from the
codes, by ``csrc/encoder_fc6_wgrad.cu`` (:func:`encoder_fc6_wgrad`, plain
version :func:`encoder_fc6_wgrad_plain`).
"""

from __future__ import annotations

import ctypes

import torch

from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

NAME = "encoder_fc6"
WGRAD_NAME = "encoder_fc6_wgrad"
MAX_T = 32
PLANE_STEPS = 16    # steps of one code plane, one GEMM pass of the kernel


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


def planes(num_steps: int) -> int:
    """16-bit code planes the kernels keep for a train of ``num_steps``."""
    return -(-num_steps // PLANE_STEPS)


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
    codes = torch.empty((planes(num_steps), r, d), dtype=torch.int16, device=x.device)
    fn = cb.function(NAME, "encoder_fc6_bf16",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    cb.launch(NAME, fn, [x.data_ptr(), w6.data_ptr(), thr.data_ptr(), cur6.data_ptr(),
                         counts.data_ptr(), codes.data_ptr(), r, d, rep, num_steps], x.device)
    return cur6, counts.long()


def encoder_fc6(x: torch.Tensor, w6: torch.Tensor, num_steps: int):
    """Kernel (CUDA) or plain version (CPU); see :func:`encoder_fc6_plain`."""
    if cb.dispatch_device(x, NAME):
        return _launch(x, w6.to(torch.bfloat16).contiguous(), num_steps)
    return encoder_fc6_plain(x, w6, num_steps)


def step_spikes(codes: torch.Tensor, t: int) -> torch.Tensor:
    """The spikes [R, D] float32 at step t of code planes [P, R, D]."""
    return ((codes[t // PLANE_STEPS].int() >> (t % PLANE_STEPS)) & 1).float()


def encoder_codes_train_plain(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """The training instance's code pass: x [R, D]. Each element's first
    spike from the membrane of ``snnf.lif_current_encoder`` carried in
    float32 from 0, by its operations in their order; the reset sets it to
    exactly 0, so the train repeats with that period. Returns the code
    planes [P, R, D] int16."""
    xf = x.float()
    v = torch.zeros_like(xf)
    first = torch.full(xf.shape, num_steps + 1, dtype=torch.int32, device=x.device)
    for m in range(1, num_steps + 1):
        v = v + 0.1 * ((0.0 - v) + xf)
        first = torch.where((v - 0.25 > 0) & (first > num_steps), m, first)
    codes = torch.zeros((planes(num_steps),) + xf.shape, dtype=torch.int32, device=x.device)
    for t in range(num_steps):
        codes[t // PLANE_STEPS] |= snnf.encoder_spikes_at(first, t, torch.int32) << (
            t % PLANE_STEPS)
    return torch.where(codes >= 1 << 15, codes - (1 << 16), codes).to(torch.int16)


def encoder_fc6_train_plain(x: torch.Tensor, w6: torch.Tensor, num_steps: int):
    """The plain version of K3's training instance: x [R, D] in the compute
    dtype; w6 [D, rep]. Returns (cur6 [T, R, rep] in x's dtype, the float32
    sums z_t @ w6 of the carried encoder's spikes rounded once; the code
    planes [P, R, D] int16)."""
    cb.note_plain(NAME, x)
    codes = encoder_codes_train_plain(x, num_steps)
    wf = w6.to(x.dtype).float()
    cur6 = torch.empty((num_steps, x.shape[0], w6.shape[1]), dtype=x.dtype, device=x.device)
    for t in range(num_steps):
        cur6[t] = torch.matmul(step_spikes(codes, t), wf)
    return cur6, codes


def encoder_fc6_wgrad_plain(codes: torch.Tensor, dcur6: torch.Tensor, num_steps: int):
    """dW6 = sum_t z_t^T @ dcur6[t] [D, rep] float32, from the code planes
    [P, R, D] and the currents' cotangent dcur6 [T, R, rep]: each step's
    spikes expanded, then a float32 product."""
    cb.note_plain(WGRAD_NAME, codes)
    dw = torch.zeros((codes.shape[2], dcur6.shape[2]), dtype=torch.float32,
                     device=codes.device)
    for t in range(num_steps):
        dw += torch.matmul(step_spikes(codes, t).t(), dcur6[t].float())
    return dw


def _launch_train(x: torch.Tensor, w6: torch.Tensor, num_steps: int):
    r, d = x.shape
    rep = w6.shape[1]
    cb.require(x, "x", torch.bfloat16)
    cb.require(w6, "w6", torch.bfloat16, (d, rep))
    if d % 64 or rep % 128 or not 1 <= num_steps <= MAX_T:
        raise ValueError(f"encoder_fc6 kernel takes D % 64 == 0, rep % 128 == 0 "
                         f"and T <= {MAX_T}; got D={d}, rep={rep}, T={num_steps}")
    cur6 = torch.empty((num_steps, r, rep), dtype=torch.bfloat16, device=x.device)
    codes = torch.empty((planes(num_steps), r, d), dtype=torch.int16, device=x.device)
    fn = cb.function(NAME, "encoder_fc6_train_bf16",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    cb.launch(NAME, fn, [x.data_ptr(), w6.data_ptr(), cur6.data_ptr(), codes.data_ptr(),
                         r, d, rep, num_steps], x.device)
    return cur6, codes


def encoder_fc6_train(x: torch.Tensor, w6: torch.Tensor, num_steps: int):
    """K3's training instance (CUDA) or its plain version (CPU); see
    :func:`encoder_fc6_train_plain`."""
    if cb.dispatch_device(x, NAME):
        return _launch_train(x, w6.to(torch.bfloat16).contiguous(), num_steps)
    return encoder_fc6_train_plain(x, w6, num_steps)


def _launch_wgrad(codes: torch.Tensor, dcur6: torch.Tensor, num_steps: int):
    p, r, d = codes.shape
    rep = dcur6.shape[2]
    cb.require(codes, "codes", torch.int16, (planes(num_steps), r, d))
    cb.require(dcur6, "dcur6", torch.bfloat16, (num_steps, r, rep))
    if d % 64 or rep % 128 or not 1 <= num_steps <= MAX_T:
        raise ValueError(f"encoder_fc6_wgrad kernel takes D % 64 == 0, rep % 128 == 0 "
                         f"and T <= {MAX_T}; got D={d}, rep={rep}, T={num_steps}")
    dw = torch.empty((d, rep), dtype=torch.float32, device=codes.device)
    fn = cb.function(WGRAD_NAME, "encoder_fc6_wgrad_bf16",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    cb.launch(WGRAD_NAME, fn, [codes.data_ptr(), dcur6.data_ptr(), dw.data_ptr(), r, d, rep,
                               num_steps], codes.device)
    return dw


def encoder_fc6_wgrad(codes: torch.Tensor, dcur6: torch.Tensor, num_steps: int):
    """The weight-gradient kernel (CUDA) or its plain version (CPU); see
    :func:`encoder_fc6_wgrad_plain`."""
    if cb.dispatch_device(codes, WGRAD_NAME):
        return _launch_wgrad(codes, dcur6.to(torch.bfloat16).contiguous(), num_steps)
    return encoder_fc6_wgrad_plain(codes, dcur6, num_steps)


class EncoderFc6Train(torch.autograd.Function):
    """The box head's encoder and fc6 as one differentiable node for w6:
    forward :func:`encoder_fc6_train` (cur6 [T, R, rep] in the compute
    dtype), backward :func:`encoder_fc6_wgrad` on the code planes, the only
    tensor it saves. x gets no gradient: the features are frozen wherever
    this route is taken."""

    @staticmethod
    def forward(ctx, x, w6, num_steps):
        cur6, codes = encoder_fc6_train(x, w6, num_steps)
        ctx.save_for_backward(codes)
        ctx.num_steps = num_steps
        ctx.w_dtype = w6.dtype
        return cur6

    @staticmethod
    def backward(ctx, g_cur6):
        (codes,) = ctx.saved_tensors
        return None, encoder_fc6_wgrad(codes, g_cur6, ctx.num_steps).to(ctx.w_dtype), None
