"""Port vs JAX: optimizers, schedules, the trainable/frozen split and the
weight bridge's way back.

``build_optimizer`` (``torch.optim.AdamW`` / ``SGD``) against the optax
transformations of the JAX package over three updates on the same numpy
gradients: parameters to 1e-6 relative plus 1e-6 absolute (the two write
the same update formula with other groupings of its products; with steps
of 0.05 on parameters of order 1 that is a few float32 ulps, 3e-7 measured).
``build_schedule`` at every count of three epochs, exact to 1e-7 relative
(powers of gamma). ``split_trainable`` / ``merge_params``: the same keys in
the same partition as the JAX package's, for every flag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
from snn_automotive_object_detection_tpu.models.factory import init_params as j_init
from snn_automotive_object_detection_tpu.train import optim as j_optim
from snn_automotive_object_detection_tpu_torch.train import optim as t_optim
from snn_automotive_object_detection_tpu_torch.utils.weights import (
    flatten_tree,
    from_numpy_tree,
    to_numpy_tree,
    tree_leaves,
)

SCHEDULES = [
    dict(),
    dict(milestones=(1, 2), gamma=0.5),
    dict(step_size=1, gamma=0.1),
    dict(constant_factor=0.3),
    dict(milestones=(2,), gamma=0.5, constant_factor=0.25),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_build_schedule(kw):
    steps_per_epoch = 4
    js = j_optim.build_schedule(0.01, steps_per_epoch, **kw)
    ts = t_optim.build_schedule(0.01, steps_per_epoch, **kw)
    assert callable(js) == callable(ts)
    for count in range(3 * steps_per_epoch + 1):
        want = float(js(count)) if callable(js) else js
        got = ts(count) if callable(ts) else ts
        assert got == pytest.approx(want, rel=1e-7), count


def _tree(rng):
    return {"a": {"w": rng.normal(size=(5, 7)).astype(np.float32)},
            "b": [{"w": rng.normal(size=(3,)).astype(np.float32)},
                  {"w": rng.normal(size=(2, 2, 4)).astype(np.float32)}]}


@pytest.mark.parametrize("name", ["AdamW", "SGD"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_build_optimizer_three_updates(name, scheduled):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    kw = dict(milestones=(1,), gamma=0.5) if scheduled else {}
    jlr = j_optim.build_schedule(0.05, 2, **kw)
    tlr = t_optim.build_schedule(0.05, 2, **kw)

    jopt = j_optim.build_optimizer(name, jlr, momentum=0.9, weight_decay=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jp)
    tp = from_numpy_tree(params, device="cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_()
    topt, sched = t_optim.build_optimizer(tp, name, tlr, momentum=0.9, weight_decay=1e-2)
    assert (sched is not None) == scheduled
    for g in grads:
        updates, state = jopt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for leaf, gl in zip(tree_leaves(tp), tree_leaves(from_numpy_tree(g, device="cpu"))):
            leaf.grad = gl
        topt.step()
        if sched is not None:
            sched.step()
        got, want = flatten_tree(to_numpy_tree(tp)), flatten_tree(jax.tree.map(np.asarray, jp))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_build_optimizer_rejects_unknown_names():
    tp = from_numpy_tree(_tree(np.random.default_rng(0)), device="cpu")
    with pytest.raises(ValueError):
        t_optim.build_optimizer(tp, "Adagrad")


@pytest.fixture(scope="module")
def param_trees():
    params = jax.tree.map(np.asarray, j_init(JConfig(num_classes=3), jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda a: np.zeros((1,), np.float32), params)   # keys only
    return shapes


@pytest.mark.parametrize("flags", [
    dict(),
    dict(freeze_fpn=True),
    dict(freeze_rpn=True, freeze_detector=True),
    dict(train_backbone=True),
    dict(trainable_backbone_layers=2),
    dict(trainable_backbone_layers=5, freeze_fpn=True),
    dict(trainable_backbone_layers=4, freeze_rpn=True),
])
def test_split_trainable_partitions_as_jax(param_trees, flags):
    jt, jf = j_optim.split_trainable(param_trees, **flags)
    tparams = from_numpy_tree(param_trees, device="cpu")
    tt, tf = t_optim.split_trainable(tparams, **flags)
    assert sorted(flatten_tree(tt)) == sorted(flatten_tree(jt))
    assert sorted(flatten_tree(tf)) == sorted(flatten_tree(jf))
    assert all(leaf.requires_grad for leaf in tree_leaves(tt))
    assert not any(leaf.requires_grad for leaf in tree_leaves(tf))
    merged = t_optim.merge_params(tt, tf)
    want = flatten_tree(tparams)
    got = flatten_tree(merged)
    assert sorted(got) == sorted(want) == sorted(flatten_tree(j_optim.merge_params(jt, jf)))
    assert all(got[k] is want[k] for k in want)       # the same tensors, not copies


def test_to_numpy_tree_round_trip_and_gradients():
    tree = _tree(np.random.default_rng(1))
    tp = from_numpy_tree(tree, device="cpu")
    back = flatten_tree(to_numpy_tree(tp))
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(back[k], v)
    tp["a"]["w"].requires_grad_()
    (tp["a"]["w"] * 2.0).sum().backward()
    grads = to_numpy_tree(tp, grads=True)
    np.testing.assert_array_equal(grads["a"]["w"], np.full((5, 7), 2.0, np.float32))
    np.testing.assert_array_equal(grads["b"][0]["w"], np.zeros(3, np.float32))
