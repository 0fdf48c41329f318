"""Port vs JAX: multi-level RoIAlign (plain version of kernel K2).

The port's ``ops/cuda_roi_align.roi_align`` (gather formulation on the
CPU) against the JAX gather path ``ops/roi_align.multiscale_roi_align`` and
the JAX Pallas patch kernel in interpret mode.

Tolerances: vs the JAX gather path 1e-6 absolute (the same float32
operations in the same order; features are N(0, 1)); vs the Pallas kernel
2e-5 (f32) and 2e-4 / 2e-3 relative (bf16), the kernel test's own bounds,
since it sums the interpolation as one matmul with split bf16 weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.ops.pallas_roi_align import (
    multiscale_roi_align_pallas,
)
from snn_automotive_object_detection_tpu.ops.roi_align import (
    multiscale_roi_align as j_align,
)
from snn_automotive_object_detection_tpu_torch.ops.cuda_roi_align import roi_align

SHAPES = [(32, 48), (16, 24), (8, 12), (4, 6)]
SIZE = (128, 192)


def _setup(seed, n=2, r=12):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(n, a, b, 256)).astype(np.float32) for a, b in SHAPES]
    h, w = SIZE
    b = np.zeros((n, r, 4), np.float32)
    for i in range(n):
        for j in range(r):
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            bw, bh = rng.uniform(4, 120), rng.uniform(4, 90)
            b[i, j] = [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2]
    b[0, 0] = [0, 0, w, h]                  # full image
    b[0, 1] = [-20, -20, 5, 5]              # partly outside
    b[0, 2] = [50, 50, 50.5, 50.5]          # degenerate (min-1 rule)
    b[1, 0] = [w - 3, h - 3, w + 9, h + 9]  # clipped at the far border
    b[1, 1] = [2, 60, 190, 62]              # sliver beyond the TPU patch
    return feats, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_matches_jax(dtype):
    feats, boxes = _setup(3)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jfeats = [jnp.asarray(f).astype(jd) for f in feats]
    tfeats = [torch.from_numpy(f).to(td) for f in feats]
    got = roi_align(tfeats, torch.from_numpy(boxes), SIZE)
    assert got.shape == (2, 12, 7, 7, 256) and got.dtype == torch.float32
    want = np.asarray(j_align(jfeats, jnp.asarray(boxes), SIZE)).astype(np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    pallas = np.asarray(multiscale_roi_align_pallas(
        jfeats, jnp.asarray(boxes), SIZE, interpret=True))
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == "float32" else dict(
        atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(got.numpy(), pallas, **tol)
