"""Port vs JAX at box-head steps past one 16-bit code plane (T = 20, 32).

The box-head kernels K3, K4 and K9 keep a spike train of more than 16
steps as two 16-bit code planes and run each GEMM once per plane, with the
neuron states carried from the first to the second. Their plain versions,
and the plain versions of their code passes, take any T; here they are
held to the JAX functions at T = 20 and 32:

  * K3's ``encoder_fc6_plain`` and ``encoder_codes_plain`` against
    ``encoder_fc6_pallas`` in interpret mode (as tests/test_pallas_fc6.py
    runs it): encoder counts exact, currents to 1e-5.
  * K4's ``box_tail_plain``, and its three passes composed bit for bit,
    against the XLA tail scan (``heads._fastrcnn_snn_from_cur6``) in bf16
    with f32 states: fc6 counts exact, fc7 counts within 1% (a matmul
    result one bf16 ulp apart can move a membrane across the threshold),
    logits to 0.05 on rows with equal fc7 counts, as
    tests/test_torch_box_head.py holds all rows at T <= 12, and every row
    within the spike-scale 0.15 + 0.1 |want| of
    tests/test_torch_box_head_fused.py: over 32 steps one flipped fc7 spike
    moves the LI readout further than over 12.
  * K9's ``fastrcnn_snn_plain`` against ``fastrcnn_snn_pallas`` under
    ``pltpu.force_tpu_interpret_mode()`` at the tolerances of
    tests/test_torch_box_head_fused.py, and the period-to-code rule with bit
    31 set.
  * The route rule: a bf16 box head of ``t_det`` > 32 is the scan on either
    device, as the reference's gate sends it to the XLA scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import heads as jheads
from snn_automotive_object_detection_tpu.snn.pallas_fc6 import encoder_fc6_pallas
from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
from snn_automotive_object_detection_tpu_torch.models import heads as theads
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6, cuda_tail
from snn_automotive_object_detection_tpu_torch.snn import cuda_kernels as k9
from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

LONG_T = (20, 32)
# K9 takes any T: three code planes at 40.
K9_LONG_T = (20, 32, 40)


def _flips(a, b):
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).sum())


@pytest.mark.parametrize("t", LONG_T)
def test_encoder_fc6_and_codes_match_pallas(t):
    rng = np.random.default_rng(100 + t)
    x = rng.uniform(0, 2.5, (40, 512)).astype(np.float32)
    w6 = (rng.uniform(-1, 1, (512, 128)) / 22.0).astype(np.float32)
    want, want_cnt = encoder_fc6_pallas(jnp.asarray(x), jnp.asarray(w6), t,
                                        state_dtype=jnp.float32, interpret=True,
                                        collect_rates=True)
    want_cnt = np.asarray(want_cnt).astype(np.int64)
    got, cnt = cuda_fc6.encoder_fc6_plain(torch.from_numpy(x), torch.from_numpy(w6), t)
    assert got.shape == (t, 40, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    codes, c_cnt = cuda_fc6.encoder_codes_plain(torch.from_numpy(x), t)
    np.testing.assert_array_equal(c_cnt.numpy(), want_cnt)
    spikes = np.stack([((codes >> s) & 1).float().numpy() for s in range(t)])
    np.testing.assert_allclose(spikes @ w6, np.asarray(want), atol=1e-5, rtol=0)
    # Steps past 16 carry spikes (periods up to T), and elements of period 1
    # set bit 31 at T = 32.
    assert spikes[16:].sum() > 0
    assert t < 32 or bool((codes < 0).any())


@pytest.mark.parametrize("t", LONG_T)
def test_box_tail_passes_compose_and_match_scan(t):
    rng = np.random.default_rng(200 + t)
    r, rep = 40, 128
    cur6 = rng.normal(0.0, 0.4, (t, r, rep)).astype(np.float32)
    w7 = (rng.uniform(-1, 1, (rep, rep)) * 8.0 / rep ** 0.5).astype(np.float32)
    wc = (rng.uniform(-1, 1, (rep, 6)) / rep ** 0.5).astype(np.float32)
    wb = (rng.uniform(-1, 1, (rep, 24)) / rep ** 0.5).astype(np.float32)
    bf = torch.bfloat16
    tcur = torch.from_numpy(cur6).to(bf)
    tw = [torch.from_numpy(w) for w in (w7, wc, wb)]
    codes6, c6 = cuda_tail.lif6_codes_plain(tcur)
    codes7, c7 = cuda_tail.fc7_lif_codes_plain(codes6, tw[0], t, bf)
    cls, box = cuda_tail.readout_plain(codes7, tw[1], tw[2], t, bf)
    want = cuda_tail.box_tail_plain(tcur, *tw)
    for a, b in zip((cls, box, c6, c7), want):
        assert torch.equal(a, b)
    assert bool((((codes7 >> 16) & 0xFFFF) != 0).any())
    s_c, s_b, rates = jheads._fastrcnn_snn_from_cur6(
        jnp.asarray(cur6).astype(jnp.bfloat16), *map(jnp.asarray, (w7, wc, wb)), t, True,
        jnp.bfloat16, enc_counts=jnp.zeros(r), d_in=1, state_dtype=jnp.float32)
    s6 = np.rint(np.asarray(rates["fc6"]) * t * rep)
    s7 = np.rint(np.asarray(rates["fc7"]) * t * rep)
    f7 = _flips(c7, s7)
    clean = c7.numpy() == s7
    print(f"T={t}: fc7 spikes flipped {f7} of {int(c7.sum())}, in {int((~clean).sum())} of "
          f"{r} rows")
    assert _flips(c6, s6) == 0
    assert f7 <= 0.01 * float(c7.sum()) and float(c7.sum()) > 0
    for a, b in ((cls, s_c), (box, s_b)):
        np.testing.assert_allclose(a.numpy()[clean], np.asarray(b)[clean], atol=0.05)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=0.15, rtol=0.1)


@pytest.mark.parametrize("t", LONG_T)
def test_box_head_bf16_matches_jax(t):
    """The whole head on the kernels' plain versions (K3 then K4) against
    the JAX head with its fc6 kernel in interpret mode and its tail scan."""
    params = jheads.init_fastrcnn_snn(jax.random.PRNGKey(5), 512, 128, 6)
    tparams = {k: {"w": torch.tensor(np.asarray(v["w"]))} for k, v in params.items()}
    x = np.random.default_rng(t).uniform(0, 2.5, (64, 512)).astype(np.float32)
    want = jheads.fastrcnn_snn_apply(params, jnp.asarray(x), t, collect_rates=True,
                                     compute_dtype=jnp.bfloat16, pallas_fc6=True,
                                     pallas_tail=False, state_dtype=jnp.float32)
    got = theads.fastrcnn_snn_apply(tparams, torch.from_numpy(x), t, collect_rates=True,
                                    compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=0.05)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=0.05)
    np.testing.assert_array_equal(got[2]["encoder"].numpy(), np.asarray(want[2]["encoder"]))
    for k in ("fc6", "fc7"):
        flips = np.abs(got[2][k].numpy() - np.asarray(want[2][k])).sum() * t * 128
        assert flips <= 0.01 * float(got[2][k].sum()) * t * 128
    assert float(got[2]["fc7"].mean()) > 0


@pytest.fixture(scope="module")
def fused_setup():
    rng = np.random.default_rng(7)
    # K: two of the TPU kernel's 1792-deep chunks.
    params = jheads.init_fastrcnn_snn(jax.random.PRNGKey(7), 3584, 64, 6)
    return params, rng.uniform(0, 2.5, (96, 3584)).astype(np.float32)


@pytest.mark.parametrize("t", K9_LONG_T)
def test_fused_head_plain_matches_pallas_interpret(fused_setup, t):
    from jax.experimental.pallas import tpu as pltpu

    from snn_automotive_object_detection_tpu.snn.pallas_kernels import fastrcnn_snn_pallas

    params, x = fused_setup
    names = ("fc6", "fc7", "cls_score", "bbox_pred")
    with pltpu.force_tpu_interpret_mode():
        want = fastrcnn_snn_pallas(jnp.asarray(x), *[params[k]["w"] for k in names], t)
    want = [np.asarray(a, np.float32) for a in want]
    got = [a.numpy() for a in k9.fastrcnn_snn_plain(
        torch.from_numpy(x), *[torch.tensor(np.asarray(params[k]["w"])) for k in names], t)]
    r, h = x.shape[0], 64
    d6 = np.abs(got[2] - want[2]) * (t * h)
    d7 = np.abs(got[3] - want[3]) * (t * h)
    clean = (d6 < 0.1) & (d7 < 0.1)
    print(f"T={t}: flipped spikes fc6 {d6.sum():.0f}, fc7 {d7.sum():.0f}; "
          f"{int(clean.sum())} of {r} rows with equal counts")
    assert want[2].mean() > 0.01 and want[3].mean() > 0.005
    assert clean.sum() >= 0.98 * r
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a[clean], b[clean], atol=1e-4, rtol=0)
        np.testing.assert_allclose(a, b, atol=0.15, rtol=0.1)
    assert d6.max() <= 3 and d7.max() <= 3


@pytest.mark.parametrize("t", K9_LONG_T)
def test_period_codes_past_16_steps(t):
    """K9's first pass at T > 16: in plane h, bit s - 16 h set when (s + 1)
    % p == 0, the last step's bit included; the codes and the trains are one
    another's, and the kernel's int16 planes (bit 15 the sign) read as the
    same trains."""
    periods = torch.arange(256, dtype=torch.int32).clamp(min=1).to(torch.uint8).reshape(16, 16)
    codes = k9.period_codes_plain(periods, t)
    assert codes.shape == (cuda_fc6.planes(t), 16, 16)
    joined = sum(codes[h].long() << (16 * h) for h in range(codes.shape[0]))
    for p, c in zip(periods.flatten().tolist(), joined.flatten().tolist()):
        assert c == sum(1 << (k - 1) for k in range(p, t + 1, p)), (p, c)
    trains = k9.trains_of(codes, t)
    assert torch.equal(k9.codes_of(trains), codes)
    assert torch.equal(trains, torch.stack([snnf.encoder_spikes_at(periods, s)
                                            for s in range(t)]))
    assert torch.equal(k9.trains_of(codes.to(torch.int16), t), trains)


@pytest.mark.parametrize("t_det,route", [(12, "kernels"), (32, "kernels"), (40, "scan")])
def test_box_head_route_above_32_steps(monkeypatch, t_det, route):
    """bf16 evaluation takes the box head's kernels (their plain versions on
    the CPU) up to 32 steps and the scan above, a rule on the config."""
    called = []
    monkeypatch.setattr(theads, "fastrcnn_snn_apply",
                        lambda *a, **k: called.append("kernels"))
    monkeypatch.setattr(theads, "fastrcnn_snn_scan_apply",
                        lambda *a, **k: called.append("scan"))
    cfg = DetectorConfig(num_classes=3, t_rpn=3, t_det=t_det, min_size=64, max_size=128)
    _, box_head_apply = t_detector.make_head_applies(cfg, {"box_head": {}}, False)
    box_head_apply(torch.zeros((2, 8)))
    assert called == [route]
