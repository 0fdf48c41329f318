"""Fused ResNet stem through the hand-written CUDA kernel (K6).

Replaces ``ops/pallas_stem.py`` (``stem_pallas_apply`` and its
``_stem_kernel``): normalise + 7x7/2 conv + frozen BN + ReLU + 3x3/2
max-pool in one launch, from the raw NHWC image to the layer-1 input. The
kernel is ``csrc/stem.cu``; :func:`stem_plain` beside it is its plain
PyTorch version and repeats the TPU kernel's arithmetic step by step:

  * normalisation and the frozen-BN affine are folded into the 7x7 weights
    (``w / std * bn_scale`` in f32) and a bias (``bn_bias - sum w_f32 mean``,
    from the unrounded folded weights), :func:`fold_stem_weights`;
  * the raw pixel and the folded weight are rounded to the state dtype
    before the product; a tap outside the image reads the per-channel raw
    mean, rounded likewise, so that it stands for the normalised zero (in
    bf16 the rounded taps times the rounded mean do not cancel the f32 bias
    share exactly, and the TPU kernel does not repair that either);
  * the 147 products accumulate in f32 and round once to the state dtype;
    the bias is added in f32, then ReLU, then one more rounding;
  * the pool is an exact max over 3x3 windows, stride 2, where positions
    outside the conv map never win.

The TPU kernel's planar space-to-depth input layout is Mosaic's need and is
not carried over: the image stays ``[N, H, W, 3]`` float32 in [0, 1]. H and
W must be multiples of 4.

A CPU tensor takes the plain version (bf16 or f32 state); a CUDA tensor
launches the kernel, which computes the bf16 variant only, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

NAME = "stem"
K_ROW = 32   # the kernel's k index is dy * K_ROW + dx * 3 + cin; 21 of 32 used
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_float] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]


def fold_stem_weights(w: torch.Tensor, bn_scale: torch.Tensor,
                      bn_bias: torch.Tensor, image_mean: Sequence[float],
                      image_std: Sequence[float]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold ``(x - mean) / std`` and the frozen-BN affine into the stem conv.

    w [7, 7, 3, 64] HWIO. Returns (folded weights [7, 7, 3, 64] f32, bias
    [64] f32): ``conv(x, folded) + bias == bn(conv((x - mean) / std, w))``
    wherever every tap lies inside the image.
    """
    mean = device_constant(tuple(image_mean), torch.float32, w.device)
    std = device_constant(tuple(image_std), torch.float32, w.device)
    wf = w.float() * (1.0 / std)[None, None, :, None]
    wf = wf * bn_scale.float()[None, None, None, :]
    bias = bn_bias.float() - (wf * mean[None, None, :, None]).sum(dim=(0, 1, 2))
    return wf, bias


def _folded_plain(images: torch.Tensor, wf: torch.Tensor, bias: torch.Tensor,
                  image_mean: Sequence[float],
                  state_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The stem on folded operands, plain PyTorch; see :func:`stem_plain`."""
    cb.note_plain(NAME, images)
    n, h, w, _ = images.shape
    sd = state_dtype
    mean = device_constant(tuple(image_mean), torch.float32, images.device)
    # Border taps read the raw mean: pad by 3 with it, then round all taps.
    x = mean.expand(n, h + 6, w + 6, 3).clone()
    x[:, 3:h + 3, 3:w + 3] = images.float()
    x = x.to(sd).float()
    y = F.conv2d(x.permute(0, 3, 1, 2), wf.to(sd).float().permute(3, 2, 0, 1),
                 stride=2)
    y = y.to(sd).float() + bias[None, :, None, None]
    y = torch.relu(y).to(sd)
    y = F.max_pool2d(y, 3, 2, padding=1)   # pads with -inf: padding never wins
    return y.permute(0, 2, 3, 1).contiguous()


def stem_plain(stem_params: Dict, images: torch.Tensor,
               image_mean: Sequence[float], image_std: Sequence[float],
               state_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the fused stem.

    images [N, H, W, 3] float32 raw in [0, 1]; stem_params {"w": [7, 7, 3,
    64], "bn": {"scale", "bias": [64]}}. Returns [N, H/4, W/4, 64] in
    ``state_dtype``; with float32 nothing is rounded to bf16.
    """
    _check_size(images)
    wf, bias = fold_stem_weights(stem_params["w"], stem_params["bn"]["scale"],
                                 stem_params["bn"]["bias"], image_mean, image_std)
    return _folded_plain(images, wf, bias, image_mean, state_dtype)


def _check_size(images: torch.Tensor) -> None:
    if images.dim() != 4 or images.shape[3] != 3:
        raise ValueError(f"stem: expected [N, H, W, 3] images, got "
                         f"{tuple(images.shape)}")
    if images.shape[1] % 4 or images.shape[2] % 4 or 0 in images.shape:
        raise ValueError(f"stem: H and W must be positive multiples of 4, got "
                         f"{tuple(images.shape[1:3])}")


def kernel_weights(wf: torch.Tensor) -> torch.Tensor:
    """Folded weights [7, 7, 3, 64] f32 in the kernel's arrangement:
    [64, 7 * K_ROW] bf16, row = output channel, column = dy * K_ROW +
    dx * 3 + cin, the other columns zero."""
    rows = wf.reshape(7, 21, 64).to(torch.bfloat16)
    rows = F.pad(rows, (0, 0, 0, K_ROW - 21))
    return rows.reshape(7 * K_ROW, 64).t().contiguous()


def _launch(images: torch.Tensor, w_k: torch.Tensor, bias: torch.Tensor,
            image_mean: Sequence[float], late: bool = False) -> torch.Tensor:
    """One launch of the kernel; ``late`` takes the instance that exists for
    the checks (``stem_late_bf16``: each window loaded only at its own tile,
    so that the wait on its barrier is what keeps the results right)."""
    _check_size(images)
    n, h, w, _ = images.shape
    cb.require(images, "images", torch.float32)
    cb.require(w_k, "w_k", torch.bfloat16, (64, 7 * K_ROW))
    cb.require(bias, "bias", torch.float32, (64,))
    out = torch.empty((n, h // 4, w // 4, 64), dtype=torch.bfloat16,
                      device=images.device)
    fn = cb.function(NAME, "stem_late_bf16" if late else "stem_bf16", _ARGTYPES)
    cb.launch(NAME, fn, [images.data_ptr(), w_k.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), *[float(m) for m in image_mean], n, h, w],
              images.device)
    return out


def stem_apply(stem_params: Dict, images: torch.Tensor,
               image_mean: Sequence[float], image_std: Sequence[float]
               ) -> torch.Tensor:
    """The fused stem, bf16: the kernel (CUDA) or the plain version (CPU).
    images [N, H, W, 3] float32 raw in [0, 1] -> [N, H/4, W/4, 64] bf16."""
    if cb.dispatch_device(images, NAME):
        wf, bias = fold_stem_weights(
            stem_params["w"], stem_params["bn"]["scale"],
            stem_params["bn"]["bias"], image_mean, image_std)
        return _launch(images, kernel_weights(wf), bias.contiguous(), image_mean)
    return stem_plain(stem_params, images, image_mean, image_std)
