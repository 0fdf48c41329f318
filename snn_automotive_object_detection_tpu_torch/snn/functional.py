"""LIF / LI neuron dynamics (norse 0.0.7 Euler semantics) in PyTorch.

Port of ``snn_automotive_object_detection_tpu/snn/functional.py``. All steps
use Euler integration with dt=0.001 and the norse defaults tau_mem_inv=100,
tau_syn_inv=200, v_leak=0, v_reset=0. Update ordering is kept exactly:

  LIF step: decay v with OLD i -> decay i -> spike on decayed v -> reset v
            -> THEN add the input current to i (one-step input latency).
  LI step:  jump i with input FIRST -> integrate v with jumped i -> decay i.

Spikes are :func:`heaviside_super`: the forward is the step function, the
backward the SuperSpike surrogate, so the steps below are differentiable
under autograd and their forward values are those of a plain ``x > 0``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class LIFParams(NamedTuple):
    """norse LIFParameters (0.0.7 defaults unless overridden)."""

    tau_syn_inv: float = 200.0
    tau_mem_inv: float = 100.0
    v_leak: float = 0.0
    v_th: float = 1.0
    v_reset: float = 0.0
    alpha: float = 100.0


class LIParams(NamedTuple):
    """norse LIParameters (0.0.7 defaults)."""

    tau_syn_inv: float = 200.0
    tau_mem_inv: float = 100.0
    v_leak: float = 0.0


ENCODER_PARAMS = LIFParams(v_th=0.25)
LIF_PARAMS = LIFParams(v_th=0.1, alpha=100.0)
LI_PARAMS = LIParams()

DT = 0.001

# Periods are carried as uint8; 255 means "never spikes" (valid for T <= 254).
NEVER = 255


class LIFState(NamedTuple):
    v: torch.Tensor
    i: torch.Tensor


class LIState(NamedTuple):
    v: torch.Tensor
    i: torch.Tensor


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """Spike nonlinearity forward: 1.0 where x > 0 else 0.0."""
    return (x > 0).to(x.dtype)


class _HeavisideSuper(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return heaviside(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / (ctx.alpha * x.abs() + 1.0) ** 2, None


def heaviside_super(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Spike nonlinearity (norse ``threshold(x, "super", alpha)``): forward
    1.0 where x > 0 else 0.0, backward g / (alpha * |x| + 1)^2."""
    return _HeavisideSuper.apply(x, alpha)


def lif_current_encoder(input_current, voltage, p: LIFParams = ENCODER_PARAMS,
                        dt: float = DT):
    """Constant-current LIF encoder step (norse ``lif_current_encoder``).
    Returns (z, v)."""
    dv = dt * p.tau_mem_inv * ((p.v_leak - voltage) + input_current)
    voltage = voltage + dv
    z = heaviside_super(voltage - p.v_th, p.alpha)
    voltage = voltage - z * (voltage - p.v_reset)
    return z, voltage


def lif_feed_forward_step(input_current, state: LIFState,
                          p: LIFParams = LIF_PARAMS, dt: float = DT):
    """Feed-forward LIF step (norse ``lif_feed_forward_step``).
    Returns (z, new_state); the input reaches the membrane one step later."""
    dv = dt * p.tau_mem_inv * ((p.v_leak - state.v) + state.i)
    v_decayed = state.v + dv
    di = -dt * p.tau_syn_inv * state.i
    i_decayed = state.i + di
    z = heaviside_super(v_decayed - p.v_th, p.alpha)
    v_new = (1.0 - z) * v_decayed + z * p.v_reset
    i_new = i_decayed + input_current
    return z, LIFState(v=v_new, i=i_new)


def li_feed_forward_step(input_current, state: LIState,
                         p: LIParams = LI_PARAMS, dt: float = DT):
    """Leaky-integrator step (norse ``li_feed_forward_step``).
    Returns (v_new, new_state); the input jumps the current first."""
    i_jump = state.i + input_current
    dv = dt * p.tau_mem_inv * ((p.v_leak - state.v) + i_jump)
    v_new = state.v + dv
    di = -dt * p.tau_syn_inv * i_jump
    i_decayed = i_jump + di
    return v_new, LIState(v=v_new, i=i_decayed)


def encoder_periods(x: torch.Tensor, p: LIFParams = ENCODER_PARAMS,
                    dt: float = DT) -> torch.Tensor:
    """Closed-form spike period of the constant-current LIF encoder.

    For a constant input x the membrane after m updates from reset is
    x * (1 - a^m) with a = 1 - dt*tau_mem_inv, so spikes are periodic with
    period min{m : v_m > v_th}. Log-form estimate, corrected against the
    pow-form membrane at fp boundaries; uint8, 255 = never.
    """
    a = 1.0 - dt * p.tau_mem_inv
    xf = x.float()
    can_spike = xf > p.v_th
    r = torch.where(can_spike, 1.0 - p.v_th / xf, torch.full_like(xf, 0.5))
    log_a = torch.log(torch.tensor(a, dtype=torch.float32, device=x.device))
    m = torch.floor(torch.log(r) / log_a).to(torch.int32) + 1
    m = torch.clamp(m, min=1)
    a32 = torch.tensor(a, dtype=torch.float32, device=x.device)
    v_m = xf * (1.0 - a32 ** m.float())
    m = torch.where(v_m <= p.v_th, m + 1, m)
    v_prev = xf * (1.0 - a32 ** (m - 1).float())
    m = torch.where((m > 1) & (v_prev > p.v_th), m - 1, m)
    m = torch.where(can_spike, torch.clamp(m, 1, NEVER),
                    torch.full_like(m, NEVER))
    return m.to(torch.uint8)


def encoder_spikes_at(periods: torch.Tensor, t: int, dtype=torch.float32):
    """Spike pattern of the constant-current encoder at step t (0-based)."""
    return (torch.remainder(torch.full_like(periods, t + 1), periods) == 0
            ).to(dtype)


def encoder_thresholds(num_steps: int, p: LIFParams = ENCODER_PARAMS,
                       dt: float = DT) -> np.ndarray:
    """The membrane constants 1 - a^m (m = 1..T) of the threshold-count
    period, as float32.

    Bit-equal to the JAX kernels' ``1 - a ** arange(1, T+1, f32)``: XLA's
    f32 pow is correctly rounded, which a float64 pow of f32(a) rounded
    once to f32 reproduces (a float32 numpy pow does not, for m = 4, 31).
    """
    a32 = np.float64(np.float32(1.0 - dt * p.tau_mem_inv))
    pw = (a32 ** np.arange(1, num_steps + 1, dtype=np.float64)).astype(
        np.float32)
    return np.float32(1.0) - pw


def li_coefficients(num_steps: int, p: LIParams = LI_PARAMS,
                    dt: float = DT) -> np.ndarray:
    """LI readout coefficients a_u with v_T = sum_u a_u * cur_u (the LI
    step unrolled: v' = 0.9 v + 0.1 i_jump, i' = 0.8 i_jump). Float64
    sums cast to float32, as the JAX RPN kernel computes them."""
    tm = dt * p.tau_mem_inv
    ts = dt * p.tau_syn_inv
    return np.asarray([
        tm * sum((1.0 - tm) ** (num_steps - k) * (1.0 - ts) ** (k - u)
                 for k in range(u, num_steps + 1))
        for u in range(1, num_steps + 1)
    ], np.float32)


def threshold_periods(xf: torch.Tensor, thresholds: torch.Tensor,
                      enc_vth: float = ENCODER_PARAMS.v_th) -> torch.Tensor:
    """Threshold-count period p = 1 + sum_m [x * (1 - a^m) <= v_th] over
    m = 1..T (the kernels' formulation): equal to :func:`encoder_periods`
    where that is <= T, and T + 1 ("never within T steps") otherwise.

    xf: float32 tensor; thresholds: [T] float32 from
    :func:`encoder_thresholds`. Returns int32 periods.
    """
    p = torch.ones_like(xf, dtype=torch.int32)
    for m in range(thresholds.shape[0]):
        p += (xf * thresholds[m] <= enc_vth).to(torch.int32)
    return p


def zeros_lif_state(shape, dtype=torch.float32, device=None) -> LIFState:
    return LIFState(v=torch.zeros(shape, dtype=dtype, device=device),
                    i=torch.zeros(shape, dtype=dtype, device=device))


def zeros_li_state(shape, dtype=torch.float32, device=None) -> LIState:
    return LIState(v=torch.zeros(shape, dtype=dtype, device=device),
                   i=torch.zeros(shape, dtype=dtype, device=device))
