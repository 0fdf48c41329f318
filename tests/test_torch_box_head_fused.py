"""Port vs JAX: the whole spiking box head in one call (plain version of
kernel K9).

``fastrcnn_snn_plain`` (snn/cuda_kernels.py) against the TPU kernel
``fastrcnn_snn_pallas`` under ``pltpu.force_tpu_interpret_mode()``, at the
shapes of tests/test_pallas_head.py: R = 160 RoIs (not a multiple of the
TPU kernel's row tile), K = 12544, H = 64, 6 classes, T in (4, 12). Both
sides take the closed-form encoder periods, bf16 matmul operands, f32 sums
and f32 neuron states, so they compute the same spikes unless a membrane
lies within a summation-order difference of the threshold.

Tolerances: a row's fc6 and fc7 rates are spike counts over T * H, so two
rates are equal or a whole spike apart. Rows whose rates agree on both
layers (to a tenth of a spike) must agree in every logit and delta to
1e-4 absolute (the same spikes; f32 sums of at most 64 terms in another
order); at most 2% of the rows may differ in a rate, and those stay within
0.15 + 0.1 |want| and 3 spikes per row, the spike-scale tolerances of
tests/test_pallas_head.py. The flipped spikes (per-row count differences)
are printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import heads as jheads
from snn_automotive_object_detection_tpu_torch.snn import cuda_kernels as k9
from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

R, K, H, CLASSES = 160, 12544, 64, 6
WEIGHTS = ("fc6", "fc7", "cls_score", "bbox_pred")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    params = jheads.init_fastrcnn_snn(jax.random.PRNGKey(0), K, H, CLASSES)
    x = rng.uniform(0, 2.5, (R, K)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("t", [4, 12])
def test_fused_head_plain_matches_pallas_interpret(setup, t):
    from jax.experimental.pallas import tpu as pltpu

    from snn_automotive_object_detection_tpu.snn.pallas_kernels import fastrcnn_snn_pallas

    params, x = setup
    with pltpu.force_tpu_interpret_mode():
        want = fastrcnn_snn_pallas(jnp.asarray(x), *[params[k]["w"] for k in WEIGHTS], t)
    want = [np.asarray(a, np.float32) for a in want]
    got = k9.fastrcnn_snn_cuda(
        torch.from_numpy(x), *[torch.from_numpy(np.asarray(params[k]["w"])) for k in WEIGHTS], t)
    got = [a.numpy() for a in got]
    for a, b, shp in zip(got, want, ((R, CLASSES), (R, 4 * CLASSES), (R,), (R,))):
        assert a.shape == b.shape == shp and a.dtype == np.float32

    d6 = np.abs(got[2] - want[2]) * (t * H)
    d7 = np.abs(got[3] - want[3]) * (t * H)
    clean = (d6 < 0.1) & (d7 < 0.1)
    print(f"T={t}: rates fc6 {want[2].mean():.4f} fc7 {want[3].mean():.4f}; flipped spikes "
          f"fc6 {d6.sum():.0f} of {want[2].sum() * t * H:.0f}, fc7 {d7.sum():.0f} of "
          f"{want[3].sum() * t * H:.0f}; {int(clean.sum())} of {R} rows with equal counts")
    assert want[2].mean() > 0.01 and (t == 4 or want[3].mean() > 0.005)
    assert clean.sum() >= 0.98 * R
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a[clean], b[clean], atol=1e-4, rtol=0)
        np.testing.assert_allclose(a, b, atol=0.15, rtol=0.1)
    assert d6.max() <= 3 and d7.max() <= 3


def test_fused_head_is_the_scan_with_unrounded_currents():
    """The plain version written out another way: the port's scan head with
    the closed-form encoder in float32 on bf16-rounded weights is the same
    function (every product of 0/1 spikes with bf16-valued weights is exact
    in both, and neither rounds a sum)."""
    from snn_automotive_object_detection_tpu_torch.models import heads as theads

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 2.5, (40, 256)).astype(np.float32))
    ws = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32) / b)
          for s, b in (((256, 32), 8.0), ((32, 32), 4.0), ((32, 3), 4.0), ((32, 12), 4.0))]
    cls, reg, r6, r7 = k9.fastrcnn_snn_plain(x, *ws, 10)
    params = {k: {"w": w.to(torch.bfloat16).float()} for k, w in zip(WEIGHTS, ws)}
    s_cls, s_reg, rates = theads.fastrcnn_snn_scan_apply(
        params, x, 10, collect_rates=True, compute_dtype=torch.float32, fast_encoder=True)
    torch.testing.assert_close(cls, s_cls, rtol=0, atol=1e-6)
    torch.testing.assert_close(reg, s_reg, rtol=0, atol=1e-6)
    torch.testing.assert_close(r6, rates["fc6"], rtol=0, atol=1e-7)
    torch.testing.assert_close(r7, rates["fc7"], rtol=0, atol=1e-7)
    assert float(r7.mean()) > 0


def test_padding_rows_and_dispatch():
    """The period map of the kernel's input: uint8, 255 where the encoder
    never spikes; a tensor on another device than the CPU or CUDA raises."""
    x = torch.tensor([[0.0, 0.2, 0.3, 5.0]])
    p = snnf.encoder_periods(x)
    assert p.dtype == torch.uint8 and p.tolist()[0][:2] == [255, 255] and p[0, 3] == 1
    before = cb.LAUNCHES[k9.NAME]
    out = k9.fastrcnn_snn_cuda(x, torch.ones(4, 8), torch.ones(8, 8), torch.ones(8, 2),
                               torch.ones(8, 8), 3)
    assert cb.LAUNCHES[k9.NAME] == before and out[0].shape == (1, 2)
    with pytest.raises(ValueError):
        k9.fastrcnn_snn_cuda(x.to("meta"), torch.ones(4, 8), torch.ones(8, 8),
                             torch.ones(8, 2), torch.ones(8, 8), 3)
