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
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

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


def _torch_border_boxes():
    from snn_automotive_object_detection_tpu_torch.ops.roi_align import assign_fpn_levels
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    return kc.level_border_boxes(lambda b: assign_fpn_levels(b, 4), "cpu")


@pytest.mark.parametrize("k_min,k_max", [(2, 5), (5, 5), (2, 4)])
def test_level_mapper_matches_jax_on_borders(k_min, k_max):
    """The port's mapper (which K2's prologue repeats in the same float
    operations) against the JAX package's, exactly, on boxes whose
    sqrt(area) is 112, 224 or 448, the float32 below, and the neighbouring
    widths between which the level changes."""
    from snn_automotive_object_detection_tpu.ops.roi_align import assign_fpn_levels as j_map
    from snn_automotive_object_detection_tpu_torch.ops.roi_align import assign_fpn_levels

    boxes = _torch_border_boxes()
    nl = k_max - k_min + 1
    got = assign_fpn_levels(boxes, nl, k_min=k_min, k_max=k_max).numpy()
    want = np.asarray(j_map(jnp.asarray(boxes.numpy()), nl, k_min=k_min, k_max=k_max))
    np.testing.assert_array_equal(got, want)
    if (k_min, k_max) == (2, 5):
        # Each border pair straddles a level: 0 | 1, 1 | 2, 2 | 3.
        assert got.tolist() == [1, 1, 0, 1, 2, 2, 1, 2, 3, 3, 2, 3]


def test_roi_align_matches_jax_on_level_borders():
    feats, boxes = _setup(7, r=12)
    border = _torch_border_boxes().numpy()
    boxes[0] = border
    boxes[1] = border + 11.0
    got = roi_align([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), SIZE)
    want = np.asarray(j_align([jnp.asarray(f) for f in feats], jnp.asarray(boxes), SIZE))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_kernel_geometry():
    """What K2's wrapper passes besides pointers: the level sizes and
    scales padded to five levels, and the mapper's level range."""
    from snn_automotive_object_detection_tpu_torch.ops import cuda_roi_align as k2
    from snn_automotive_object_detection_tpu_torch.ops.roi_align import level_range

    flagship = ((192, 384), (96, 192), (48, 96), (24, 48))
    geo = k2.geometry(flagship, (768, 1536))
    assert (geo.num_levels, geo.k_min, geo.k_max) == (4, 2, 5)
    assert list(geo.h) == [192, 96, 48, 24, 192] and list(geo.w) == [384, 192, 96, 48, 384]
    assert list(geo.scale) == [0.25, 0.125, 0.0625, 0.03125, 0.25]
    assert level_range([0.25, 0.125, 0.0625, 0.03125]) == (2, 5)
    assert k2.geometry(flagship, (768, 1536)) is geo
    # MobileNet: two levels of stride 32, every box on the first.
    top = k2.geometry(((24, 48), (24, 48)), (768, 1536))
    assert (top.num_levels, top.k_min, top.k_max) == (2, 5, 5)
    with pytest.raises(ValueError, match="at most 5"):
        k2.geometry(flagship + ((12, 24), (6, 12)), (768, 1536))
    with pytest.raises(ValueError, match="mapper range"):   # a gap between the levels
        k2.geometry(((192, 384), (24, 48)), (768, 1536))


def test_roi_align_refuses_other_devices_and_takes_the_plain_version_on_cpu():
    from snn_automotive_object_detection_tpu_torch.ops import cuda_roi_align as k2
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    feats, boxes = _setup(9, r=3)
    tf = [torch.from_numpy(f).to(torch.bfloat16) for f in feats]
    cb.reset_counts()
    out = k2.roi_align(tf, torch.from_numpy(boxes), SIZE)
    assert cb.LAUNCHES[k2.NAME] == 0 and cb.PLAIN_CUDA_CALLS[k2.NAME] == 0
    assert torch.equal(out, k2.plain(tf, torch.from_numpy(boxes), SIZE))
    with pytest.raises(ValueError, match="unsupported device"):
        k2.roi_align(tf, torch.from_numpy(boxes).to("meta"), SIZE)


def test_rows_read_counts_the_rows_with_a_gradient():
    """K2's compulsory bytes: ``rows_read`` against the rows that the plain
    version's gradient reaches (every bilinear weight is >= 0, so a row's
    gradient of the summed output is nonzero exactly when a sample reads
    it with a nonzero weight)."""
    from snn_automotive_object_detection_tpu_torch.ops.roi_align import (
        multiscale_roi_align, rows_read)

    feats, boxes = _setup(11, r=6)
    tf = [torch.from_numpy(f[..., :8]).requires_grad_() for f in feats]
    tb = torch.from_numpy(boxes)
    multiscale_roi_align(tf, tb, SIZE).sum().backward()
    want = sum(int((f.grad.abs().sum(-1) != 0).sum()) for f in tf)
    assert 0 < want < sum(f[..., 0].numel() for f in tf)
    assert rows_read(tf, tb, SIZE) == want
