"""The bounds that hold the CUDA kernels against their plain versions
(utils/kernel_checks.py): one bf16 ulp passes, the faults they are meant
to catch do not, and the sum of terms' magnitudes widens the chain bound
by SUM_REL of it only. Exact checks on seeded values; no tolerance of their own.
"""

import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc


def _want():
    x = np.random.default_rng(0).normal(0, 0.05, 4096).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _next_bf16_up(x):
    bits = x.to(torch.bfloat16).view(torch.int16)
    return (bits + 1).view(torch.bfloat16).float()


def test_one_bf16_ulp_is_within_the_bound():
    want = _want()
    got = _next_bf16_up(want)
    assert kc.bf16_valued(got)
    assert kc.excess(got, want) <= 1
    assert kc.excess(want, want, atol=0.0) == 0


@pytest.mark.parametrize("fault", ["scaled", "shifted", "unrounded"])
def test_bound_catches_faults(fault):
    want = _want()
    if fault == "scaled":        # readout off by 30%
        assert kc.excess(want * 1.3, want) > 1
    elif fault == "shifted":     # a missing term of about 0.004
        assert kc.excess(want + 0.004, want) > 1
    else:                        # the f32 sum not rounded to bf16
        got = want + want * 2.0 ** -10
        assert not kc.bf16_valued(got)


def test_chain_excess_counts_the_sum_of_terms():
    """Sums near zero of large products: a move of the f32 sum with the
    order, 2^-21 of the terms' magnitudes, passes only with ``terms``; a
    missing term of 1% of them fails with it."""
    want = torch.zeros(64)
    terms = torch.full((64,), 7600.0)
    moved = want + 2.0 ** -21 * terms
    assert kc.chain_excess(moved, want, 2) > 1
    assert kc.chain_excess(moved, want, 2, terms=terms) <= 1
    assert kc.chain_excess(want + 0.01 * terms, want, 2, terms=terms) > 1
