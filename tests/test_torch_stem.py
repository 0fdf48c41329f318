"""Port vs JAX: the fused stem (K6's plain version) against the Pallas
kernel ``ops/pallas_stem.py`` in interpret mode, on the CPU.

The JAX kernel takes the planar space-to-depth layout (``planarize_image``);
the port takes the same numpy image as NHWC. Tolerances:

  * float32 state: rtol = atol = 1e-4, the bound of the JAX package's own
    test of its kernel against the XLA chain (sums in another order);
  * bf16 state: both sides round the same f32 sums at the same places, so
    they differ only where a sum in another order crosses a bf16 rounding
    boundary. The test prints how many elements differ at all and how many
    leave one bf16 ulp of the value (2^-7 |want| + 1e-4), holds every
    element to ``kernel_checks.chain_excess`` with two roundings and the
    bias as addend (the flipped conv sum is off by one ulp of ITS
    magnitude, and the bias may cancel most of it), and lets at most 1% of
    the elements differ at all;
  * the fold: weights to rtol 1e-6 against the JAX fold mapped back from
    its space-to-depth arrangement, the bias to 1e-6 of the magnitude of
    the 147 terms it sums.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.ops import pallas_stem as jstem
from snn_automotive_object_detection_tpu_torch.models import resnet_fpn, transform
from snn_automotive_object_detection_tpu_torch.ops import cuda_stem
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

MEAN = (0.2869, 0.3251, 0.2839)
STD = (0.1870, 0.1902, 0.1872)


def _stem_params(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(0, 0.11, (7, 7, 3, 64))).astype(np.float32),
            "bn": {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
                   "bias": rng.normal(0, 0.2, 64).astype(np.float32)}}


@functools.lru_cache(maxsize=None)
def _jax_stem_fn(dtype):
    """The Pallas stem in interpret mode under one ``jax.jit`` per state
    dtype: the image cases of one shape share its compile."""
    return jax.jit(lambda jp, x: jstem.stem_pallas_apply(
        jp, jstem.planarize_image(x, MEAN), MEAN, STD, state_dtype=dtype, interpret=True))


def _jax_stem(params, x, dtype):
    jp = {"w": jnp.asarray(params["w"]),
          "bn": {k: jnp.asarray(v) for k, v in params["bn"].items()}}
    return np.asarray(_jax_stem_fn(dtype)(jp, jnp.asarray(x)), np.float32)


def _torch_params(params):
    return {"w": torch.from_numpy(params["w"]),
            "bn": {k: torch.from_numpy(v) for k, v in params["bn"].items()}}


def _images(seed, shape, pad=False):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    if pad:   # bucket padding: real zeros inside the image, convolved as data
        x[:, shape[1] * 3 // 4:] = 0.0
        x[:, :, shape[2] * 25 // 32:] = 0.0
    return x


@pytest.mark.parametrize("pad", [False, True], ids=["full", "bucket_pad"])
def test_f32_state_matches_pallas(pad):
    params, x = _stem_params(0), _images(1, (2, 64, 256, 3), pad)
    want = _jax_stem(params, x, jnp.float32)
    got = cuda_stem.stem_plain(_torch_params(params), torch.from_numpy(x), MEAN, STD,
                               state_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 16, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pad", [False, True], ids=["full", "bucket_pad"])
def test_bf16_state_matches_pallas(pad):
    params, x = _stem_params(2), _images(3, (2, 64, 256, 3), pad)
    want = torch.from_numpy(_jax_stem(params, x, jnp.bfloat16))
    cb.reset_counts()
    got = cuda_stem.stem_apply(_torch_params(params), torch.from_numpy(x), MEAN, STD)
    assert cb.LAUNCHES[cuda_stem.NAME] == 0 and cb.PLAIN_CUDA_CALLS[cuda_stem.NAME] == 0
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _, bias = cuda_stem.fold_stem_weights(
        torch.from_numpy(params["w"]), torch.from_numpy(params["bn"]["scale"]),
        torch.from_numpy(params["bn"]["bias"]), MEAN, STD)
    got = got.float()
    diff = kc.differing(got, want)
    one_ulp = int(((got - want).abs() > kc.BF16_REL * want.abs() + kc.ATOL).sum())
    worst = kc.chain_excess(got, want, 2, (bias,))
    print(f"stem bf16: {diff} of {want.numel()} elements differ, {one_ulp} by more "
          f"than one bf16 ulp of the value; {worst:.3g} of the chain bound; "
          f"max |want| {float(want.abs().max()):.3g}")
    assert worst <= 1
    assert diff <= kc.MAX_DIFFERING * want.numel()
    assert float(want.max()) > 1.0 and float((want == 0).float().mean()) < 0.9


def test_fold_matches_jax_fold():
    """The JAX fold's w256[k, o], k = ((drh + 2) * 4 + (sx + 2)) * 16 +
    subH * 6 + subW * 3 + cin, mapped back to [dy, dx, cin, o]; its 15
    unused (drh, sx, subH, subW) slots and the 4 pad planes are zero."""
    params = _stem_params(4)
    w256, jbias, _ = jstem.fold_stem_weights(
        jnp.asarray(params["w"]), jnp.asarray(params["bn"]["scale"]),
        jnp.asarray(params["bn"]["bias"]), MEAN, STD)
    w256 = np.asarray(w256).reshape(4, 4, 16, 64)
    want = np.zeros((7, 7, 3, 64), np.float32)
    used = np.zeros((4, 4, 16), bool)
    for dy in range(7):
        drh, sub_h = divmod(dy - 3, 2)
        for dx in range(7):
            sx, sub_w = divmod(dx - 3, 2)
            c = sub_h * 6 + sub_w * 3
            want[dy, dx] = w256[drh + 2, sx + 2, c:c + 3]
            used[drh + 2, sx + 2, c:c + 3] = True
    assert used.sum() == 147 and not w256[~used].any()
    t = _torch_params(params)
    wf, bias = cuda_stem.fold_stem_weights(t["w"], t["bn"]["scale"], t["bn"]["bias"],
                                           MEAN, STD)
    assert wf.dtype == bias.dtype == torch.float32 and tuple(wf.shape) == (7, 7, 3, 64)
    np.testing.assert_allclose(wf.numpy(), want, rtol=1e-6, atol=0)
    # The bias is an f32 sum of 147 terms that largely cancel; summed in
    # another order it moves by 1e-6 of the terms' magnitude, not the sum's.
    terms = np.abs(params["bn"]["bias"]) + np.abs(want * np.asarray(MEAN, np.float32)[:, None]).sum((0, 1, 2))
    assert np.all(np.abs(bias.numpy() - np.asarray(jbias)) <= 1e-6 * terms)
    # The kernel's arrangement: column dy * 32 + dx * 3 + cin, the rest zero.
    wk = cuda_stem.kernel_weights(wf)
    assert tuple(wk.shape) == (64, 224) and wk.dtype == torch.bfloat16
    back = wk.t().reshape(7, 32, 64)
    assert torch.equal(back[:, :21].reshape(7, 7, 3, 64), wf.to(torch.bfloat16))
    assert not back[:, 21:].any()


def test_width_the_tpu_kernel_refuses():
    """64 x 192: W is no multiple of 256, which the TPU kernel needs. In
    float32 the fused stem is the port's own unfused chain (normalise ->
    conv -> BN -> ReLU -> pool) up to summation order, borders included."""
    params, x = _torch_params(_stem_params(5)), torch.from_numpy(_images(6, (1, 64, 192, 3)))
    got = cuda_stem.stem_plain(params, x, MEAN, STD, state_dtype=torch.float32)
    want = resnet_fpn.stem_apply_unfused(params, transform.normalize_images(x, MEAN, STD))
    assert tuple(got.shape) == (1, 16, 48, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_sizes_are_checked():
    params = _torch_params(_stem_params(7))
    with pytest.raises(ValueError, match="multiples of 4"):
        cuda_stem.stem_apply(params, torch.zeros((1, 64, 130, 3)), MEAN, STD)
    with pytest.raises(ValueError, match=r"\[N, H, W, 3\]"):
        cuda_stem.stem_apply(params, torch.zeros((1, 3, 64, 128)), MEAN, STD)
