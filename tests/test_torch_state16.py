"""Port vs JAX: bf16 neuron states (the reference's --no-amp), on the CPU.

  * K1's plain version with bf16 states (``cuda_rpn.rpn_level_plain(...,
    bf16_states=True)``) against the JAX kernel ``_run_level(...,
    lif_dtype=bf16, interpret=True)``. The plain version rounds every
    elementwise result to bf16, as the program is written. XLA on the CPU
    may keep f32 between fused operations (its excess precision), and the
    interpret-mode kernel does so: compiled with
    ``xla_allow_excess_precision`` off it is the plain version bit for bit
    (readout, encoder and LIF counts); as XLA compiles it by default a few
    LIF spikes flip, which the test counts and bounds at 1e-3 of the spikes,
    with the readout within the spike scale 0.05.
  * The same plain version against the JAX XLA scan with bf16 states and
    the closed-form encoder (``heads.rpn_head_snn_apply(..., state_dtype=
    None, fast_encoder=True)``): the LIF spike counts are equal either way;
    the readout, whose LI integrator the scan runs in bf16 at every step
    where the kernel sums the spikes in f32, within 0.02 (spike scale).
  * The LIF step alone, spike train by spike train, against the JAX
    ``lif_feed_forward_step`` on bf16 states in a jitted scan: equal.
  * The box head's tail with bf16 states (``heads.box_tail_scan``) against
    the JAX ``_fastrcnn_snn_from_cur6`` with ``state_dtype=bf16`` on the
    same bf16 currents: fc6 spike counts equal; fc7 counts within 1% (the
    fc7 products, summed in another order, can round one bf16 ulp apart);
    logits within 0.05 on rows with equal counts. And the whole box head
    (K3's plain version, then that tail) against the JAX head on its kernel
    route under ``pltpu.force_tpu_interpret_mode()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from snn_automotive_object_detection_tpu.models import heads as jheads
from snn_automotive_object_detection_tpu.snn import functional as jsnnf
from snn_automotive_object_detection_tpu.snn import pallas_rpn as jrpn
from snn_automotive_object_detection_tpu_torch.models import heads as theads
from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)


T = 8
SHAPE = (2, 10, 18, 256)
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(0)
    params = jheads.init_rpn_head_snn(jax.random.PRNGKey(0), 256, 3)
    for k, s in (("shared_conv", 6.0), ("conv_cls", 6.0), ("conv_bbox", 2.0)):
        params[k]["w"] = params[k]["w"] * s
    feat = rng.uniform(0, 2.0, SHAPE).astype(np.float32)
    tp = from_numpy_tree(jax.tree.map(np.asarray, params), device="cpu")
    w_out = torch.cat([tp["conv_cls"]["w"], tp["conv_bbox"]["w"]], -1).reshape(256, 15)
    port = cuda_rpn.rpn_level_plain(torch.from_numpy(feat).to(torch.bfloat16),
                                    tp["shared_conv"]["w"], w_out, T, bf16_states=True)
    return params, feat, [a.numpy() for a in port]


def _compiled(fn, x, options):
    lowered = jax.jit(fn).lower(x)
    return lowered.compile(compiler_options=options) if options else lowered.compile()


def _counts(rate):
    return np.rint(np.asarray(rate, np.float64) * (T * np.prod(SHAPE[1:])))


@pytest.mark.parametrize("excess", [False, True])
def test_k1_bf16_states_plain_matches_pallas_interpret(level, excess):
    params, feat, (out, enc, lif) = level
    w9 = jnp.asarray(params["shared_conv"]["w"]).reshape(9, 256, 256)
    wout = jnp.concatenate([params["conv_cls"]["w"], params["conv_bbox"]["w"]],
                           -1).reshape(256, 15)

    def run(f):
        return jrpn._run_level(f, w9, jnp.pad(wout, ((0, 0), (0, 113))), T, 3, jnp.bfloat16,
                               True, collect_rates=True, lif_dtype=jnp.bfloat16)

    o, b, er, sr = _compiled(run, jnp.asarray(feat), None if excess else NO_EXCESS)(
        jnp.asarray(feat))
    want = np.concatenate([np.asarray(o), np.asarray(b)], -1)
    flips = int(np.abs(_counts(sr) - lif).sum())
    differ = int((out != want).sum())
    print(f"XLA excess precision {'on' if excess else 'off'}: LIF spikes {lif.tolist()} "
          f"(plain) vs {_counts(sr).tolist()} (JAX kernel), {flips} flipped (net); "
          f"{differ} of {want.size} readout elements differ, max "
          f"{np.abs(out - want).max():.3g}")
    np.testing.assert_array_equal(enc, _counts(er))
    if not excess:
        assert flips == 0 and differ == 0
    else:
        assert flips <= 1e-3 * lif.sum()
        np.testing.assert_allclose(out, want, atol=0.05)
    assert lif.sum() > 0.1 * T * np.prod(SHAPE)


@pytest.mark.parametrize("excess", [False, True])
def test_k1_bf16_states_plain_matches_xla_scan(level, excess):
    params, feat, (out, enc, lif) = level

    def scan(f):
        return jheads.rpn_head_snn_apply(params, [f], T, collect_rates=True,
                                         compute_dtype=jnp.bfloat16, fast_encoder=True,
                                         state_dtype=None)

    o, b, r = _compiled(scan, jnp.asarray(feat), None if excess else NO_EXCESS)(
        jnp.asarray(feat))
    want = np.concatenate([np.asarray(o[0]), np.asarray(b[0])], -1)
    flips = int(np.abs(_counts(r["shared"][0]) - lif).sum())
    print(f"XLA excess precision {'on' if excess else 'off'}: {flips} LIF spikes flipped "
          f"(net) against the scan; readout max diff {np.abs(out - want).max():.3g} at "
          f"max |readout| {np.abs(want).max():.3g}")
    assert flips == 0
    np.testing.assert_array_equal(enc, _counts(r["encoder"][0]))
    np.testing.assert_allclose(out, want, atol=0.02)


@pytest.mark.parametrize("excess", [False, True])
def test_lif_step_bf16_matches_jax(excess):
    rng = np.random.default_rng(3)
    cur = jnp.asarray(rng.normal(0.05, 0.3, (T, 4096)).astype(np.float32)).astype(jnp.bfloat16)

    def scan(c):
        def step(st, x):
            z, st = jsnnf.lif_feed_forward_step(x, st)
            return st, (z, st.v, st.i)
        zero = jnp.zeros(c.shape[1:], jnp.bfloat16)
        return jax.lax.scan(step, jsnnf.LIFState(zero, zero), c)[1]

    jz, jv, ji = (np.asarray(a, np.float32)
                  for a in _compiled(scan, cur, None if excess else NO_EXCESS)(cur))
    tcur = torch.from_numpy(np.asarray(cur.astype(jnp.float32))).to(torch.bfloat16)
    st = snnf.zeros_lif_state(tcur.shape[1:], torch.bfloat16)
    for t in range(T):
        z, st = snnf.lif_feed_forward_step(tcur[t], st)
        assert st.v.dtype == st.i.dtype == torch.bfloat16
        np.testing.assert_array_equal(z.float().numpy(), jz[t])
        np.testing.assert_array_equal(st.v.float().numpy(), jv[t])
        np.testing.assert_array_equal(st.i.float().numpy(), ji[t])
    assert jz.sum() > 100


@pytest.fixture(scope="module")
def box_head():
    params = jheads.init_fastrcnn_snn(jax.random.PRNGKey(4), 512, 128, 5)
    params["fc6"]["w"] = params["fc6"]["w"] * 2.0
    params["fc7"]["w"] = params["fc7"]["w"] * 3.0
    params["cls_score"]["w"] = params["cls_score"]["w"] * 10.0
    x = np.random.default_rng(5).uniform(0, 2.5, (48, 512)).astype(np.float32)
    return params, x


def _tail_check(got, want, what):
    cls, reg, c6, c7 = (np.asarray(a, np.float32) for a in got)
    wcls, wreg, w6, w7 = (np.asarray(a, np.float32) for a in want)
    flips7 = np.abs(c7 - w7).sum()
    clean = c7 == w7
    print(f"{what}: fc6 spikes {c6.sum():.0f} (JAX {w6.sum():.0f}), fc7 {c7.sum():.0f} "
          f"(JAX {w7.sum():.0f}), {flips7:.0f} flipped (net, per row); {clean.sum()} of "
          f"{len(clean)} rows with equal fc7 counts")
    np.testing.assert_array_equal(c6, w6)
    assert w7.sum() > 0 and flips7 <= 0.01 * w7.sum()
    for a, b in ((cls, wcls), (reg, wreg)):
        np.testing.assert_allclose(a[clean], b[clean], atol=0.05)


@pytest.mark.parametrize("excess", [False, True])
def test_bf16_state_tail_matches_jax(box_head, excess):
    params, x = box_head
    rng = np.random.default_rng(6)
    cur6 = jnp.asarray(rng.normal(0.1, 0.6, (T, 48, 128)).astype(np.float32)).astype(jnp.bfloat16)
    w = [params[k]["w"] for k in ("fc7", "cls_score", "bbox_pred")]

    def tail(c):
        cls, reg, rates = jheads._fastrcnn_snn_from_cur6(
            c, *w, T, True, jnp.bfloat16, enc_counts=jnp.zeros(48), d_in=1,
            state_dtype=jnp.bfloat16)
        return cls, reg, rates["fc6"] * T * 128, rates["fc7"] * T * 128

    want = _compiled(tail, cur6, None if excess else NO_EXCESS)(cur6)
    tcur = torch.from_numpy(np.asarray(cur6.astype(jnp.float32))).to(torch.bfloat16)
    got = theads.box_tail_scan(tcur, *[torch.tensor(np.asarray(a)) for a in w])
    _tail_check([a.numpy() for a in got], [np.rint(np.asarray(a)) if i > 1 else a
                                           for i, a in enumerate(want)],
                f"tail, XLA excess precision {'on' if excess else 'off'}")


def test_bf16_state_box_head_matches_jax_kernel_route(box_head):
    """K3's plain version then the bf16-state tail, as ``detector_apply``
    runs the box head with bf16 states, against the JAX head with its fc6
    kernel in interpret mode and its tail scan with bf16 states."""
    params, x = box_head
    names = ("fc6", "fc7", "cls_score", "bbox_pred")
    with pltpu.force_tpu_interpret_mode():
        cls, reg, rates = jheads.fastrcnn_snn_apply(
            params, jnp.asarray(x), T, collect_rates=True, compute_dtype=jnp.bfloat16,
            pallas_fc6=True, pallas_tail=True, state_dtype=None)
    tparams = {k: {"w": torch.tensor(np.asarray(params[k]["w"]))} for k in names}
    tcls, treg, trates = theads.fastrcnn_snn_apply(tparams, torch.from_numpy(x), T, True,
                                                   torch.bfloat16, torch.bfloat16)
    np.testing.assert_array_equal(trates["encoder"].numpy(), np.asarray(rates["encoder"]))
    _tail_check([tcls.numpy(), treg.numpy(), trates["fc6"].numpy() * T * 128,
                 trates["fc7"].numpy() * T * 128],
                [cls, reg, np.asarray(rates["fc6"]) * T * 128,
                 np.asarray(rates["fc7"]) * T * 128], "whole box head")
