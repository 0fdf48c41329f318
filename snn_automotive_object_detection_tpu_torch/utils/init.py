"""Seeded draws for parameter initialisation, on an explicit device."""

from __future__ import annotations

import math

import torch

from snn_automotive_object_detection_tpu_torch.utils.constants import resolve_device


def draw_device(g: torch.Generator, device) -> torch.device:
    """The device the parameters are drawn on (None: the CUDA device). The
    generator must live there too: a draw with a generator of another
    device would have to happen elsewhere and be copied."""
    device = resolve_device(device, "init_params")
    if g.device != device:
        raise ValueError(
            f"init_params: the generator lives on {g.device} but the "
            f"parameters are drawn on {device}; make it with "
            f"torch.Generator(device={str(device)!r})")
    return device


def normal(g, shape, std, device):
    return torch.randn(shape, generator=g, device=device) * std


def uniform(g, shape, bound, device):
    return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * bound


def conv_he(g, kh, kw, cin, cout, device):
    """He / fan-out normal (torchvision's kaiming_normal_, mode fan_out)."""
    return normal(g, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cout)), device)


def bn_affine(cout, device):
    return {"scale": torch.ones(cout, device=device),
            "bias": torch.zeros(cout, device=device)}
