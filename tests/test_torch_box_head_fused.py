"""Port vs JAX: the whole spiking box head in one call (plain version of
kernel K9).

``fastrcnn_snn_plain`` (snn/cuda_kernels.py) against the TPU kernel
``fastrcnn_snn_pallas`` under ``pltpu.force_tpu_interpret_mode()``, at the
shapes of tests/test_pallas_head.py: R = 160 RoIs (not a multiple of the
TPU kernel's row tile), K = 12544, H = 64, 6 classes, T in (4, 12). Both
sides take the closed-form encoder periods, bf16 matmul operands, f32 sums
and f32 neuron states, so they compute the same spikes unless a membrane
lies within a summation-order difference of the threshold.

Also, on the CPU: the plain version is ``box_tail_f32_plain`` run on
``fc6_trains_plain``'s spikes, bit for bit; the kernel's first pass (periods
to spike-train codes) and its LIF order; the shared-memory rule that puts
the f32 staging in the drained ring; and the spike-by-spike check that
``chip_smoke.py`` holds the kernel to (``kernel_checks.box_head_fused_report``)
on the plain version's own outputs and on broken ones.

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
from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

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


def _small_head(seed, r=24, k=256, h=1024, classes=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 2.5, (r, k)).astype(np.float32))
    ws = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32) / b)
          for s, b in (((k, h), k ** 0.5 / 5), ((h, h), 32.0), ((h, classes), 32.0),
                       ((h, 4 * classes), 32.0))]
    return x, ws


@pytest.mark.parametrize("t", [4, 12, 16])
def test_plain_is_the_tail_on_its_own_fc6_spikes(t):
    """fastrcnn_snn_plain is fc6_trains_plain then box_tail_f32_plain, bit
    for bit, so a check may run the tail on the kernel's own fc6 spikes."""
    x, ws = _small_head(t)
    cls, reg, r6, r7 = k9.fastrcnn_snn_plain(x, *ws, t)
    s6 = k9.fc6_trains_plain(x, ws[0], t)
    t_cls, t_reg, s7 = k9.box_tail_f32_plain(s6, *ws[1:])
    assert s6.shape == s7.shape == (t, 24, 1024)
    assert torch.equal(cls, t_cls) and torch.equal(reg, t_reg)
    assert torch.equal(r6, s6.sum(dim=(0, 2)) / (t * 1024))
    assert torch.equal(r7, s7.sum(dim=(0, 2)) / (t * 1024))
    assert float(r6.mean()) > 0 and float(r7.mean()) > 0


@pytest.mark.parametrize("t", [1, 4, 12, 16])
def test_period_codes_rule(t):
    """The first pass: bit t of an element's code is set when the encoder
    spikes at step t, (t + 1) % p == 0; 255 never spikes. The codes and
    the trains are one another's."""
    periods = torch.arange(256, dtype=torch.int32).clamp(min=1).to(torch.uint8).reshape(16, 16)
    codes = k9.period_codes_plain(periods, t)
    assert codes.shape == (1, 16, 16)
    for p, c in zip(periods.flatten().tolist(), codes[0].flatten().tolist()):
        assert c == sum(1 << (k - 1) for k in range(p, t + 1, p)), (p, c)
    assert int(codes.flatten()[0]) == (1 << t) - 1 and int(codes.flatten()[-1]) == 0
    trains = k9.trains_of(codes, t)
    assert trains.shape == (t, 16, 16) and torch.equal(k9.codes_of(trains), codes)
    assert torch.equal(trains, torch.stack([snnf.encoder_spikes_at(periods, s)
                                            for s in range(t)]))


def test_staging_lies_in_the_drained_ring():
    """The f32 staging of 16 rows x 16 steps does not fit beside an 8-stage
    ring in the 227 KB of a block, so it overlays the drained ring; a
    4-stage ring is too small to hold it."""
    assert k9.smem_bytes(128, 8, staging_in_ring=False) > k9.SMEM_LIMIT
    for n_cols in (128, 64):
        assert k9.smem_bytes(n_cols, 8, staging_in_ring=True) <= k9.SMEM_LIMIT
    assert k9.smem_bytes(128, 8, staging_in_ring=True) == 1024 + 8 * 18432 + 128
    with pytest.raises(ValueError):
        k9.smem_bytes(128, 4, staging_in_ring=True)


def test_kernel_lif_order_is_lif_feed_forward_step():
    """The epilogue's LIF update in float32, in the kernel's order and with
    its spike test vd - 0.1 > 0, gives lif_feed_forward_step's bits, and on
    float32 vd - 0.1 > 0 is vd > 0.1, at the threshold's neighbours too."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(0.05, 0.1, 4096).astype(np.float32))
    i = torch.from_numpy(rng.normal(0.1, 0.3, 4096).astype(np.float32))
    cur = torch.from_numpy(rng.normal(0, 0.2, 4096).astype(np.float32))
    th = torch.tensor(0.1, dtype=torch.float32)
    near = torch.stack([torch.nextafter(th, torch.tensor(x, dtype=torch.float32))
                        for x in (0.0, 1.0)] + [th])
    v[:3] = near   # vd = v when i = v
    i[:3] = near
    z, st = snnf.lif_feed_forward_step(cur, snnf.LIFState(v, i))
    vd = v + 0.1 * ((0.0 - v) + i)
    id_ = i + (-0.2) * i
    zk = ((vd - 0.1) > 0).float()
    assert torch.equal(zk, z) and torch.equal(zk, (vd > 0.1).float())
    assert torch.equal((1.0 - zk) * vd, st.v) and torch.equal(id_ + cur, st.i)
    assert z[:3].tolist() == [0.0, 1.0, 0.0]


def test_spike_by_spike_check_holds_and_fails():
    """kernel_checks.box_head_fused_report, the check chip_smoke.py and the
    card tests hold K9 to: the plain version's own outputs pass with no
    flip; fc6 codes a step late, a logit of one clean row off and counts
    that are not the codes' popcounts fail."""
    t = 12
    x, (w6, w7, wc, wb) = _small_head(5)
    s6 = k9.fc6_trains_plain(x, w6, t)
    cls, reg, s7 = k9.box_tail_f32_plain(s6, w7, wc, wb)
    c6, c7 = k9.codes_of(s6), k9.codes_of(s7)
    counts = s6.sum(dim=(0, 2)).long(), s7.sum(dim=(0, 2)).long()
    good = (cls, reg, *counts, c6, c7)
    rep = kc.box_head_fused_report(good, x, w6, w7, wc, wb, t)
    print(kc.box_head_fused_line(rep))
    assert rep["ok"] and rep["flips6"] == rep["flips7"] == rep["rows7"] == 0
    assert rep["ex_row"] == rep["ex_head"] == 0.0 and rep["n6"] > 0 and rep["n7"] > 0
    late = (c6 << 1) & 0xFFF
    assert not kc.box_head_fused_report((cls, reg, *counts, late, c7), x, w6, w7, wc, wb,
                                        t)["ok"]
    off = cls.clone()
    off[3, 0] += 0.01
    rep = kc.box_head_fused_report((off, reg, *counts, c6, c7), x, w6, w7, wc, wb, t)
    assert not rep["ok"] and rep["ex_row"] > 1 and rep["ex_head"] <= 1
    wrong = (counts[0] + 1, counts[1])
    assert not kc.box_head_fused_report((cls, reg, *wrong, c6, c7), x, w6, w7, wc, wb,
                                        t)["ok"]
