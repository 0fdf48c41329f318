"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W) and
the least time of the RPN head kernel (K1) on a batch.

A roofline share is the least time over the measured time. The least time
is the larger of the compulsory bytes over the memory rate and the
operations over their peak rate: K1's operations are counted for these
inputs, a sparse 3x3 conv (2 x 256 operations for each of the 9 outputs
an encoder spike reaches), the dense 1x1 readout of 5A channels, and about
10 float32 operations a neuron and step for the LIF update, outside the
tensor cores.
"""

from __future__ import annotations

from typing import Iterable, Tuple

PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12


def bound_s(n_bytes: float, tensor_ops: float, f32_ops: float = 0.0) -> float:
    """The least time, in seconds, of work that moves ``n_bytes`` and does
    ``tensor_ops`` bf16 and ``f32_ops`` float32 operations."""
    return max(n_bytes / PEAK_BYTES_S, tensor_ops / PEAK_BF16_FLOPS + f32_ops / PEAK_F32_FLOPS)


def rpn_head_bound_s(levels: Iterable[Tuple[int, int]], batch: int, channels: int, t_steps: int,
                     readout: int, enc_spikes: float) -> float:
    """K1's least time on ``batch`` images of the FPN ``levels`` (h, w) with
    ``channels`` channels, ``t_steps`` steps and a ``readout``-channel 1x1
    readout, when the encoder fires ``enc_spikes`` times in all. Bytes: the
    bf16 levels read, the weights (9 taps and the readout, bf16), the f32
    readouts written."""
    levels = list(levels)
    pixels = batch * sum(h * w for h, w in levels)
    neurons = pixels * channels * t_steps
    n_bytes = (pixels * channels * 2 + (9 * channels * channels + channels * readout) * 2
               + pixels * readout * 4)
    sparse = 2.0 * enc_spikes * 9 * channels
    dense = 2.0 * pixels * channels * readout
    return bound_s(n_bytes, sparse + dense, 10.0 * neurons)
