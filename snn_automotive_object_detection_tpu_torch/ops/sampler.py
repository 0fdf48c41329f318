"""Balanced positive/negative sampling with fixed shapes.

Port of ``snn_automotive_object_detection_tpu/ops/sampler.py`` (torchvision
``BalancedPositiveNegativeSampler``; RPN 256 at 0.5, RoI 512 at 0.25), as
boolean masks: each element gets a uniform random key and the largest keys
win. :func:`balanced_sample_from_draws` is the pure part, on given draws, so
that two libraries with different generators can be held to the same sample;
:func:`balanced_sample` draws the keys from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def _top_mask(keys: torch.Tensor, k: int, limit=None) -> torch.Tensor:
    """Mask of the (at most) ``k`` largest keys above NEG_INF in each row,
    ties lowest index first; ``limit`` [..., 1] caps the count per row."""
    vals, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    take = vals > NEG_INF
    if limit is not None:
        take = take & (torch.arange(k, device=keys.device) < limit)
    return torch.zeros_like(keys, dtype=torch.bool).scatter(-1, idx, take)


def balanced_sample_from_draws(positive: torch.Tensor, negative: torch.Tensor,
                               rp: torch.Tensor, rn: torch.Tensor,
                               batch_size: int, positive_fraction: float):
    """positive/negative [..., K] bool masks (mutually exclusive); rp, rn
    [..., K] uniform draws. Returns (pos_sampled, neg_sampled) bool masks
    with |pos| = min(#pos, int(batch * fraction)) and
    |neg| = min(#neg, batch - |pos|): the positives with the largest ``rp``
    and the negatives with the largest ``rn``."""
    k = positive.shape[-1]
    num_pos_target = int(batch_size * positive_fraction)
    pos_sampled = _top_mask(torch.where(positive, rp, NEG_INF),
                            min(num_pos_target, k))
    num_neg_target = batch_size - pos_sampled.sum(dim=-1, keepdim=True)
    neg_sampled = _top_mask(torch.where(negative, rn, NEG_INF),
                            min(batch_size, k), num_neg_target)
    return pos_sampled, neg_sampled


def balanced_sample(generator: torch.Generator, positive: torch.Tensor,
                    negative: torch.Tensor, batch_size: int,
                    positive_fraction: float):
    """:func:`balanced_sample_from_draws` on draws from ``generator``, which
    lives on the masks' device."""
    rp = torch.rand(positive.shape, generator=generator, device=positive.device)
    rn = torch.rand(positive.shape, generator=generator, device=positive.device)
    return balanced_sample_from_draws(positive, negative, rp, rn, batch_size,
                                      positive_fraction)
