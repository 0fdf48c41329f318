"""Port vs JAX: the spiking box head — encoder+fc6 (plain version of kernel
K3), the LIF/fc7/readout tail (plain version of K4) and the whole head.

Shapes are the JAX kernel tests' (tests/test_pallas_fc6.py,
tests/test_pallas_tail.py): d_in 512, rep 128, 6 classes, rows not a
multiple of 128.

The kernels' passes have plain versions of their own: K3's code pass
(``encoder_codes_plain``, spike trains as codes plus counts) is held to the
threshold count of ``encoder_fc6_pallas``, and K4's three passes
(``lif6_codes_plain``, ``fc7_lif_codes_plain``, ``readout_plain``) compose
to ``box_tail_plain`` bit for bit and through it to ``box_tail_pallas``.

Tolerances:
  * encoder spike counts: exact (integer functions of the input).
  * fc6 currents: 1e-5 absolute in f32 and bf16 (the same 0/1 x weight
    products summed in another order).
  * tail and whole head in f32: 1e-5 (reduction order only).
  * tail and whole head with bf16 operands and f32 states (production):
    logits to 0.05 absolute and at most 1% of the fc6/fc7 spikes flipped;
    a matmul result one bf16 ulp apart can move a membrane across the
    threshold. The flip count (net spike-count difference) is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import heads as jheads
from snn_automotive_object_detection_tpu.snn.pallas_fc6 import encoder_fc6_pallas
from snn_automotive_object_detection_tpu.snn.pallas_tail import box_tail_pallas
from snn_automotive_object_detection_tpu_torch.models import heads as theads
from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6, cuda_tail
from snn_automotive_object_detection_tpu_torch.snn.cuda_fc6 import encoder_fc6
from snn_automotive_object_detection_tpu_torch.snn.cuda_tail import box_tail
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree


@pytest.fixture(scope="module")
def head():
    params = jheads.init_fastrcnn_snn(jax.random.PRNGKey(3), 512, 128, 6)
    return params, from_numpy_tree(jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("t,dtype", [(4, "float32"), (12, "float32"),
                                     (12, "bfloat16")])
def test_encoder_fc6_matches_pallas(head, t, dtype):
    params, tparams = head
    x = np.random.default_rng(t).uniform(0, 2.5, (150, 512)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want, want_cnt = encoder_fc6_pallas(jnp.asarray(x), params["fc6"]["w"], t,
                                        state_dtype=jd, interpret=True,
                                        collect_rates=True)
    got, cnt = encoder_fc6(torch.from_numpy(x).to(td), tparams["fc6"]["w"], t)
    assert got.shape == (t, 150, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt).astype(np.int64))
    assert cnt.sum() > 0


@pytest.mark.parametrize("t,rep", [(4, 128), (12, 128), (12, 1024)])
def test_encoder_codes_match_pallas_threshold_count(t, rep):
    """K3's code pass: the codes' spike counts equal the Pallas kernel's
    encoder counts, and the spikes they encode times w6 give its currents."""
    rng = np.random.default_rng(40 + t + rep)
    x = rng.uniform(0, 2.5, (40, 512)).astype(np.float32)
    w6 = (rng.uniform(-1, 1, (512, rep)) / 22.0).astype(np.float32)
    want, want_cnt = encoder_fc6_pallas(jnp.asarray(x), jnp.asarray(w6), t,
                                        state_dtype=jnp.float32, interpret=True,
                                        collect_rates=True)
    codes, cnt = cuda_fc6.encoder_codes_plain(torch.from_numpy(x), t)
    assert codes.shape == (40, 512) and int(codes.max()) < 2 ** t
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt).astype(np.int64))
    assert cnt.sum() > 0
    cur6 = np.stack([((codes >> s) & 1).float().numpy() @ w6 for s in range(t)])
    np.testing.assert_allclose(cur6, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("t,rep,dtype", [(4, 128, "bfloat16"), (12, 128, "bfloat16"),
                                         (12, 1024, "bfloat16"), (12, 128, "float32")])
def test_box_tail_passes_compose_to_plain_and_pallas(t, rep, dtype):
    """K4's three passes, each through its plain version, give
    box_tail_plain's bits; and, as box_tail_plain does, the Pallas tail's
    logits and fc6 counts (fc7 within the flips of one-ulp currents)."""
    rng = np.random.default_rng(t + rep)
    r = 40
    cur6 = rng.normal(0.0, 0.4, (t, r, rep)).astype(np.float32)
    w7 = (rng.uniform(-1, 1, (rep, rep)) * 8.0 / rep ** 0.5).astype(np.float32)
    wc = (rng.uniform(-1, 1, (rep, 6)) / rep ** 0.5).astype(np.float32)
    wb = (rng.uniform(-1, 1, (rep, 24)) / rep ** 0.5).astype(np.float32)
    td = getattr(torch, dtype)
    tcur = torch.from_numpy(cur6).to(td)
    tw = [torch.from_numpy(w) for w in (w7, wc, wb)]
    codes6, c6 = cuda_tail.lif6_codes_plain(tcur)
    codes7, c7 = cuda_tail.fc7_lif_codes_plain(codes6, tw[0], t, td)
    cls, box = cuda_tail.readout_plain(codes7, tw[1], tw[2], t, td)
    want = cuda_tail.box_tail_plain(tcur, *tw)
    for a, b in zip((cls, box, c6, c7), want):
        assert torch.equal(a, b)
    assert int(c7.sum()) > 0 and int(codes6.max()) < 2 ** t
    if dtype == "bfloat16":
        k_c, k_b, k_6, k_7 = box_tail_pallas(jnp.asarray(cur6).astype(jnp.bfloat16),
                                             *map(jnp.asarray, (w7, wc, wb)), t,
                                             collect_rates=True, interpret=True)
        np.testing.assert_allclose(cls.numpy(), np.asarray(k_c), atol=0.05)
        np.testing.assert_allclose(box.numpy(), np.asarray(k_b), atol=0.05)
        assert _flips(c6, k_6) == 0
        assert _flips(c7, k_7) <= 0.01 * float(c7.sum())


def _flips(a, b):
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).sum())


def test_box_tail_bf16_matches_pallas_and_scan(head):
    params, tparams = head
    t, r = 5, 200
    cur6 = np.random.default_rng(1).normal(0.0, 0.4, (t, r, 128)).astype(np.float32)
    jcur = jnp.asarray(cur6).astype(jnp.bfloat16)
    # fc7 scaled x8 so LIF7 spikes at a realistic rate with these widths.
    scale = {"fc7": 8.0, "cls_score": 1.0, "bbox_pred": 1.0}
    w = [params[k]["w"] * scale[k] for k in scale]
    k_c, k_b, k_6, k_7 = box_tail_pallas(jcur, *w, t, collect_rates=True,
                                         interpret=True)
    s_c, s_b, _ = jheads._fastrcnn_snn_from_cur6(
        jcur, *w, t, False, jnp.bfloat16, state_dtype=jnp.float32)
    got = box_tail(torch.from_numpy(cur6).to(torch.bfloat16),
                   *[tparams[k]["w"] * scale[k] for k in scale])
    for want_c, want_b in ((k_c, k_b), (s_c, s_b)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want_c), atol=0.05)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want_b), atol=0.05)
    f6, f7 = _flips(got[2], k_6), _flips(got[3], k_7)
    print(f"tail flips: fc6 {f6} of {int(got[2].sum())}, fc7 {f7} of "
          f"{int(got[3].sum())}")
    assert f6 == 0  # LIF6 sees the identical bf16 currents
    assert f7 <= 0.01 * float(got[3].sum()) and float(got[3].sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_box_head_matches_jax(head, dtype):
    params, tparams = head
    t, r = 8, 96
    x = np.random.default_rng(2).uniform(0, 2.5, (r, 512)).astype(np.float32)
    if dtype == "float32":
        want = jheads.fastrcnn_snn_apply(params, jnp.asarray(x), t,
                                         collect_rates=True,
                                         compute_dtype=jnp.float32,
                                         fast_encoder=True)
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        want = jheads.fastrcnn_snn_apply(params, jnp.asarray(x), t,
                                         collect_rates=True,
                                         compute_dtype=jnp.bfloat16,
                                         pallas_fc6=True, pallas_tail=True,
                                         state_dtype=jnp.float32)
        tol = dict(atol=0.05)
    got = theads.fastrcnn_snn_apply(tparams, torch.from_numpy(x), t,
                                    collect_rates=True,
                                    compute_dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **tol)
    np.testing.assert_array_equal(got[2]["encoder"].numpy(),
                                  np.asarray(want[2]["encoder"]))
    for k in ("fc6", "fc7"):
        flips = np.abs(got[2][k].numpy() - np.asarray(want[2][k])).sum() * t * 128
        print(f"{dtype} {k}: {flips:.0f} spikes flipped (net)")
        assert flips <= 0.01 * float(got[2][k].sum()) * t * 128
    assert float(got[2]["fc7"].mean()) > 0
