"""Port vs JAX: the fused FPN level (K5's plain version) against the Pallas
kernel ``ops/pallas_fpn.py`` in interpret mode, on the CPU.

Same numpy-seeded bf16 inputs and weights on both sides. Both round the
same f32 product sums to bf16 at the same places, so they differ only where
a sum taken in another order lands on the other side of a bf16 rounding
boundary. Each test prints how many elements differ at all and how many
leave one bf16 ulp of the value (2^-7 |want| + 1e-4), and holds every
element to ``kernel_checks.chain_excess``: the flipped product sum is off
by one ulp of ITS magnitude, and the bf16 adds after it (bias, upsample)
can cancel most of that magnitude, so the bound counts the addends too;
and at most 1% of the elements may differ at all, since a rounding made at
another place in the chain would flip far more. Both hold where the two
sides get the same inputs, so each level is compared on the JAX side's own
coarser merged map, and P on the JAX side's own merged map. Down the whole
top-down pass a flipped merged element reaches 4 pixels of every finer
level and 2304 outputs of each 3x3, so ``fpn_apply`` as a whole is held to
the bound of the JAX package's own test of its kernel (3e-2 absolute and
relative, tests/test_pallas_fpn.py) with at most 5% of the elements
differing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.ops.pallas_fpn import (
    fpn_level_pallas,
    fpn_pallas_apply,
)
from snn_automotive_object_detection_tpu_torch.ops import cuda_fpn
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

CINS = (256, 512, 1024, 2048)


def _bf(a):
    """numpy f32 -> the nearest bf16 values, as f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _params(rng, cins=CINS):
    inner = [{"w": _bf(rng.normal(0, 0.02, (1, 1, c, 256)).astype(np.float32)),
              "b": _bf(rng.normal(0, 0.02, 256).astype(np.float32))} for c in cins]
    layer = [{"w": _bf(rng.normal(0, 0.02, (3, 3, 256, 256)).astype(np.float32)),
              "b": _bf(rng.normal(0, 0.02, 256).astype(np.float32))} for _ in cins]
    return {"inner": inner, "layer": layer}


def _maps(rng, shapes, cins=CINS, n=2):
    return [_bf(rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32))
            for (h, w), c in zip(shapes, cins)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _tree(p):
    return {k: [{kk: _t(vv) for kk, vv in lvl.items()} for lvl in v] for k, v in p.items()}


def _j(a):
    return jnp.asarray(a)


def _report(name, got, want, roundings, addends, max_differing=kc.MAX_DIFFERING):
    got, want = got.float(), want.float()
    diff = kc.differing(got, want)
    one_ulp = int(((got - want).abs() > kc.BF16_REL * want.abs() + kc.ATOL).sum())
    worst = kc.chain_excess(got, want, roundings, addends)
    print(f"{name}: {diff} of {want.numel()} elements differ, {one_ulp} by more "
          f"than one bf16 ulp of the value; {worst:.3g} of the chain bound")
    assert got.shape == want.shape
    assert worst <= 1
    assert diff <= max_differing * want.numel()


def _level_on_shared_inputs(name, c, m_next, inner, layer):
    """One level on both sides from the same inputs; P from the JAX side's
    merged map. Returns the JAX side's (P, merged)."""
    n, h, w, _ = c.shape
    want_p, want_m = fpn_level_pallas(
        _j(c).astype(jnp.bfloat16),
        None if m_next is None else _j(m_next).astype(jnp.bfloat16),
        _j(inner["w"]), _j(inner["b"]), _j(layer["w"]), _j(layer["b"]),
        store_merged=True, interpret=True)
    want_p, want_m = np.asarray(want_p, np.float32), np.asarray(want_m, np.float32)
    args = (_t(c, torch.bfloat16),
            None if m_next is None else _t(m_next, torch.bfloat16),
            _t(inner["w"]), _t(inner["b"]), _t(layer["w"]), _t(layer["b"]))
    got_p, got_m = cuda_fpn.fpn_level(*args, store_merged=True)
    assert got_p.dtype == got_m.dtype == torch.bfloat16
    addends = [_t(inner["b"])]
    if m_next is not None:
        up = _t(m_next).repeat_interleave(2, 1).repeat_interleave(2, 2)[:, :h, :w]
        addends += [up, up]
    _report(f"merged {name}", got_m, _t(want_m), 2 if m_next is None else 3, addends)
    _report(f"P {name}", cuda_fpn.outer_plain(_t(want_m, torch.bfloat16), _t(layer["w"]),
                                               _t(layer["b"])),
            _t(want_p), 2, (_t(layer["b"]),))
    # The finest level's variant stores no merged map and gives the same P;
    # P from the port's own merged map differs by the flips counted above.
    only_p, none = cuda_fpn.fpn_level(*args, store_merged=False)
    assert none is None and torch.equal(only_p, got_p)
    np.testing.assert_allclose(got_p.float().numpy(), want_p, atol=3e-2, rtol=3e-2)
    return want_p, want_m


def test_top_level_matches_pallas(rng):
    """No upsample: lateral + bias, then the 3x3, on a 6x12 C5."""
    p = _params(rng)
    c5 = _maps(rng, [(6, 12)], [2048])[0]
    _level_on_shared_inputs("C5", c5, None, p["inner"][3], p["layer"][3])


@pytest.mark.parametrize("hw", [(12, 24), (13, 25)])
def test_level_with_upsample_matches_pallas(rng, hw):
    """One level below a given merged map, even and odd size."""
    p = _params(rng)
    h, w = hw
    c4 = _maps(rng, [hw], [1024])[0]
    m5 = _bf(rng.normal(0, 0.5, (2, (h + 1) // 2, (w + 1) // 2, 256)).astype(np.float32))
    _level_on_shared_inputs("C4", c4, m5, p["inner"][2], p["layer"][2])


@pytest.mark.parametrize("shapes", [
    [(24, 48), (12, 24), (6, 12), (3, 6)],     # exact 2x pyramid
    [(25, 50), (13, 25), (7, 13), (4, 7)],     # odd sizes (ceil halving)
])
def test_fpn_apply_matches_pallas(rng, shapes):
    """The whole top-down pass, widths 256/512/1024/2048, five levels out:
    level by level on the JAX side's merged maps, then as a whole."""
    p = _params(rng)
    cs = _maps(rng, shapes)
    m_next = None
    for i in (3, 2, 1, 0):
        _, m_next = _level_on_shared_inputs(f"C{i + 2}", cs[i], m_next,
                                            p["inner"][i], p["layer"][i])
    want = fpn_pallas_apply([_j(c).astype(jnp.bfloat16) for c in cs],
                            {k: [{kk: _j(vv) for kk, vv in lvl.items()} for lvl in v]
                             for k, v in p.items()})
    cb.reset_counts()
    got = cuda_fpn.fpn_apply([_t(c, torch.bfloat16) for c in cs], _tree(p))
    assert cb.PLAIN_CUDA_CALLS[cuda_fpn.NAME] == 0 and cb.LAUNCHES[cuda_fpn.NAME] == 0
    assert len(got) == len(want) == 5
    for lvl in range(5):
        g, w_ = got[lvl].float(), _t(want[lvl])
        diff = kc.differing(g, w_)
        print(f"fpn_apply level {lvl}: {diff} of {w_.numel()} elements differ, "
              f"max |diff| {float((g - w_).abs().max()):.3g}")
        assert g.shape == w_.shape
        np.testing.assert_allclose(g.numpy(), w_.numpy(), atol=3e-2, rtol=3e-2)
        assert diff <= 0.05 * w_.numel()
    assert torch.equal(got[4], got[3][:, ::2, ::2])


def test_shapes_are_checked():
    c = torch.zeros((1, 5, 7, 256), dtype=torch.bfloat16)
    w1, b = torch.zeros((1, 1, 256, 256)), torch.zeros(256)
    w3 = torch.zeros((3, 3, 256, 256))
    with pytest.raises(ValueError, match="coarser merged map"):
        cuda_fpn.fpn_level(c, torch.zeros((1, 2, 3, 256), dtype=torch.bfloat16),
                           w1, b, w3, b, store_merged=False)
