"""Port vs JAX: the paired-image RPN head (plain version of kernel K8), the
pairing rule of the head, and the widened readout of K1 and K7.

  * ``rpn_level_x2_plain`` against ``rpn_level_plain``: bit for bit, spike
    sums too, for N = 2 and N = 4, bf16 planes with f32 states and f32
    planes, an even and an odd height. Pairing is a change of schedule.
  * The head with ``cuda_rpn.PAIR_IMAGES`` on against the JAX head with
    ``_X2_DEFAULT`` on in interpret mode (as tests/test_pallas_rpn.py's
    ``test_pallas_rpn_x2_bit_identical`` runs it; both switches are
    monkeypatched, nothing in either package changes): f32 planes to 1e-5
    absolute and relative (the same spikes, sums in another order), bf16
    planes with f32 states to 0.05 absolute (spike scale: a conv current
    one bf16 ulp apart can flip a LIF spike), the tolerances of
    tests/test_torch_rpn_head.py. Both sides are seen to take the paired
    route.
  * The rule: an odd batch, rate collection or the constant off take the
    per-image level; the launch's grid and cluster (``level_grid``): rows
    padded to whole clusters of two, the pair's two images in one cluster.
  * 75 readout channels (15 anchors per location, the MobileNet families'
    head): the plain versions of K1 and K7 against the JAX kernels
    ``_run_level`` and ``_run_level_bwd`` in interpret mode, f32: the
    readout to 1e-5, both gradients to 2e-5 of their largest element (the
    bounds of tests/test_torch_rpn_head.py and test_torch_train_heads.py at
    15 channels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import heads as jheads
from snn_automotive_object_detection_tpu.snn import pallas_rpn as jk
from snn_automotive_object_detection_tpu_torch.models import heads as theads
from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

SHAPES = [(10, 18), (5, 9)]
T = 8
MODES = {"bf16_f32_states": (torch.bfloat16, jnp.bfloat16, jnp.float32),
         "f32": (torch.float32, jnp.float32, None)}


def _setup(n, anchors=3, seed=0):
    rng = np.random.default_rng(seed)
    params = jheads.init_rpn_head_snn(jax.random.PRNGKey(11), 256, anchors)
    feats = [rng.uniform(0, 2.0, (n, h, w, 256)).astype(np.float32) for h, w in SHAPES]
    return params, from_numpy_tree(jax.tree.map(np.asarray, params), device="cpu"), feats


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", [2, 4])
def test_x2_plain_equals_plain_bit_for_bit(n, mode):
    dtype = MODES[mode][0]
    _, tparams, feats = _setup(n)
    w_out, _ = theads._fused_readout(tparams)
    for f in feats:
        x = torch.from_numpy(f).to(dtype)
        one = cuda_rpn.rpn_level_plain(x, tparams["shared_conv"]["w"], w_out, T, spike_sum=True)
        out, ssum = cuda_rpn.rpn_level_x2(x, tparams["shared_conv"]["w"], w_out, T,
                                          spike_sum=True)
        assert out.shape == one[0].shape and int(one[2].sum()) > 0
        assert torch.equal(out, one[0]) and torch.equal(ssum, one[3])
        assert torch.equal(cuda_rpn.rpn_level_x2_plain(
            x, tparams["shared_conv"]["w"], w_out, T), out)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", [2, 4])
def test_paired_head_matches_paired_pallas_interpret(monkeypatch, n, mode):
    tdtype, state_dtype, lif_dtype = MODES[mode]
    params, tparams, feats = _setup(n)
    calls = {"jax": 0, "port": 0}
    run_x2, level_x2 = jk._run_level_x2, cuda_rpn.rpn_level_x2

    def j_spy(*a, **kw):
        calls["jax"] += 1
        return run_x2(*a, **kw)

    def t_spy(*a, **kw):
        calls["port"] += 1
        return level_x2(*a, **kw)

    monkeypatch.setattr(jk, "_X2_DEFAULT", True)
    monkeypatch.setattr(jk, "_run_level_x2", j_spy)
    monkeypatch.setattr(cuda_rpn, "PAIR_IMAGES", True)
    monkeypatch.setattr(cuda_rpn, "rpn_level_x2", t_spy)
    o_k, b_k, r_k = jk.rpn_head_snn_pallas_apply(
        params, [jnp.asarray(f) for f in feats], T, state_dtype=state_dtype,
        interpret=True, lif_state_dtype=lif_dtype)
    o_t, b_t, r_t = theads.rpn_head_snn_apply(
        tparams, [torch.from_numpy(f) for f in feats], T, compute_dtype=tdtype)
    assert calls == {"jax": len(SHAPES), "port": len(SHAPES)}
    assert r_k is None and r_t is None
    tol = dict(atol=1e-5, rtol=1e-5) if mode == "f32" else dict(atol=0.05, rtol=0)
    for lvl in range(len(SHAPES)):
        for got, want in ((o_t[lvl], o_k[lvl]), (b_t[lvl], b_k[lvl])):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **tol)
        assert float(o_t[lvl].abs().max()) > 0


@pytest.mark.parametrize("n,rates,on,paired", [(2, False, True, True), (3, False, True, False),
                                               (2, True, True, False), (2, False, False, False)])
def test_pairing_rule(monkeypatch, n, rates, on, paired):
    _, tparams, feats = _setup(n)
    calls = {"x2": 0, "one": 0}
    level_x2, level = cuda_rpn.rpn_level_x2, cuda_rpn.rpn_level

    def spy(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(cuda_rpn, "PAIR_IMAGES", on)
    monkeypatch.setattr(cuda_rpn, "rpn_level_x2", spy("x2", level_x2))
    monkeypatch.setattr(cuda_rpn, "rpn_level", spy("one", level))
    assert cuda_rpn.x2_feasible((n, 5, 9, 256)) == (n % 2 == 0)
    obj, box, got_rates = theads.rpn_head_snn_apply(
        tparams, [torch.from_numpy(feats[1])], 4, collect_rates=rates)
    assert calls == ({"x2": 1, "one": 0} if paired else {"x2": 0, "one": 1})
    assert obj[0].shape == (n, 5, 9, 3) and box[0].shape == (n, 5, 9, 12)
    assert (got_rates is not None) == rates
    if n % 2:
        with pytest.raises(ValueError):
            cuda_rpn.rpn_level_x2_plain(torch.from_numpy(feats[1]),
                                        tparams["shared_conv"]["w"], torch.zeros(256, 15), 4)


@pytest.mark.parametrize("shape,pair,grid,cluster,feasible", [
    ((2, 5, 45, 256), True, (3, 6, 2), (1, 2, 2), True),
    ((2, 5, 45, 256), False, (3, 6, 2), (1, 2, 1), True),
    ((4, 12, 16, 256), True, (1, 12, 4), (1, 2, 2), True),
    ((3, 1, 7, 256), True, (1, 2, 3), (1, 2, 2), False),
    ((2, 65535, 16, 256), True, (1, 65536, 2), (1, 2, 2), False),
    ((2, 4, 4, 128), True, (1, 4, 2), (1, 2, 2), False)])
def test_level_grid_pads_rows_and_pairs_images(shape, pair, grid, cluster, feasible):
    """K1's and K8's launch: a block per 16 pixels of a row, rows padded to
    an even count (a cluster is two rows), K8's cluster also the two images
    of a pair, so its batch must be even; the kernels take 256 channels."""
    assert cuda_rpn.level_grid(shape, pair) == (grid, cluster)
    if pair:
        assert cuda_rpn.x2_feasible(shape) == feasible


def test_constant_is_a_python_bool_and_the_module_reads_no_environment():
    import inspect

    assert isinstance(cuda_rpn.PAIR_IMAGES, bool)
    assert "environ" not in inspect.getsource(cuda_rpn)


# ---- 75 readout channels

A_WIDE = 15
SHAPE_WIDE = (6, 10)


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(3)
    params = jheads.init_rpn_head_snn(jax.random.PRNGKey(5), 256, A_WIDE)
    feat = rng.uniform(0, 2.0, (2, *SHAPE_WIDE, 256)).astype(np.float32)
    cot = rng.normal(size=(2, *SHAPE_WIDE, 5 * A_WIDE)).astype(np.float32)
    return params, from_numpy_tree(jax.tree.map(np.asarray, params), device="cpu"), feat, cot


def test_wide_readout_forward_matches_pallas_interpret(wide):
    params, tparams, feat, _ = wide
    o_k, b_k, _ = jk.rpn_head_snn_pallas_apply(
        params, [jnp.asarray(feat)], T, state_dtype=jnp.float32, interpret=True)
    o_t, b_t, _ = theads.rpn_head_snn_apply(tparams, [torch.from_numpy(feat)], T,
                                            compute_dtype=torch.float32)
    assert o_t[0].shape == (2, *SHAPE_WIDE, A_WIDE) and b_t[0].shape == (2, *SHAPE_WIDE, 60)
    np.testing.assert_allclose(o_t[0].numpy(), np.asarray(o_k[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(b_t[0].numpy(), np.asarray(b_k[0]), atol=1e-5, rtol=1e-5)
    assert float(b_t[0].abs().max()) > 0


def test_wide_readout_backward_matches_pallas_interpret(wide):
    params, tparams, feat, cot = wide
    n_out = 5 * A_WIDE
    w9 = params["shared_conv"]["w"].reshape(9, 256, 256)
    wout = jnp.concatenate([params["conv_cls"]["w"], params["conv_bbox"]["w"]],
                           -1).reshape(256, n_out)
    wout = jnp.pad(wout, ((0, 0), (0, 128 - n_out)))
    want9, want_out = jk._run_level_bwd(
        jnp.asarray(feat), w9, wout, jnp.asarray(cot[..., :A_WIDE]),
        jnp.asarray(cot[..., A_WIDE:]), T, jnp.float32, True, lif_dtype=None)
    want9, want_out = np.asarray(want9), np.asarray(want_out)[:, :n_out]
    w_out, a = theads._fused_readout(tparams)
    assert a == A_WIDE and w_out.shape == (256, n_out)
    dw, dwo = cuda_rpn.rpn_level_bwd(torch.from_numpy(feat), tparams["shared_conv"]["w"],
                                     w_out, torch.from_numpy(cot), T)
    assert dw.shape == (3, 3, 256, 256) and dwo.shape == (256, n_out)
    for got, want in ((dw.reshape(9, 256, 256).numpy(), want9), (dwo.numpy(), want_out)):
        top = np.abs(want).max()
        assert top > 0 and np.abs(got - want).max() <= 2e-5 * top


def test_kernels_take_up_to_128_readout_channels():
    assert cuda_rpn.MAX_OUT == 128
    x = torch.zeros((2, 2, 3, 256), dtype=torch.bfloat16)
    out, _, _ = cuda_rpn.rpn_level(x, torch.zeros(3, 3, 256, 256), torch.zeros(256, 128), 2)
    assert out.shape == (2, 2, 3, 128)
