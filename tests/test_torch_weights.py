"""The weight bridge (utils/weights.py) and the port's parameter tree.

Exact: the bridge copies float32 leaves, and the port's own
``init_params`` must build the same tree (same leaves, same shapes) as the
JAX package's, so that checkpoints and tests can move between them.
"""

import jax
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
from snn_automotive_object_detection_tpu.models.factory import init_params as j_init
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
from snn_automotive_object_detection_tpu_torch.models.factory import init_params
from snn_automotive_object_detection_tpu_torch.utils.weights import (
    flatten_tree,
    from_numpy_tree,
)


def test_bridge_round_trips_every_leaf():
    jtree = jax.tree.map(np.asarray, j_init(JConfig(num_classes=9),
                                            jax.random.PRNGKey(0)))
    ttree = from_numpy_tree(jtree, device="cpu")
    jflat, tflat = flatten_tree(jtree), flatten_tree(ttree)
    assert set(jflat) == set(tflat)
    assert len(jflat) == len(jax.tree.leaves(jtree))
    for k, v in jflat.items():
        assert isinstance(tflat[k], torch.Tensor) and tflat[k].dtype == torch.float32
        np.testing.assert_array_equal(tflat[k].numpy(), v, err_msg=k)

    # The port's own init builds the identical tree, leaf for leaf.
    own = flatten_tree(init_params(DetectorConfig(num_classes=9),
                                   torch.Generator().manual_seed(0), device="cpu"))
    assert set(own) == set(jflat)
    for k, v in jflat.items():
        assert tuple(own[k].shape) == v.shape, k


def test_init_distributions_match_jax():
    """Seeded init draws the JAX init's distributions: He-normal backbone
    convs, N(0, 0.01) RPN head, U(+-1/sqrt(fan_in)) box head."""
    cfg = DetectorConfig(num_classes=9)
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    w = p["backbone"]["layer3"][0]["conv2"]["w"]
    np.testing.assert_allclose(float(w.std()), np.sqrt(2.0 / (9 * 256)), rtol=0.02)
    np.testing.assert_allclose(float(p["rpn_head"]["shared_conv"]["w"].std()), 0.01,
                               rtol=0.02)
    fc6 = p["box_head"]["fc6"]["w"]
    bound = 1.0 / np.sqrt(256 * 7 * 7)
    assert float(fc6.abs().max()) <= bound
    np.testing.assert_allclose(float(fc6.std()), bound / np.sqrt(3.0), rtol=0.02)
    assert float(p["backbone"]["fpn"]["inner"][0]["b"].abs().sum()) == 0.0
    # Same seed, same weights.
    q = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(q["box_head"]["fc7"]["w"], p["box_head"]["fc7"]["w"])


def test_default_device_is_the_card(monkeypatch):
    """``device=None`` means the CUDA device: without one, ``init_params``,
    ``init_resnet50_fpn`` and ``from_numpy_tree`` raise and say how to ask
    for the CPU; ``device="cpu"`` gives CPU tensors; a CPU generator with a
    CUDA device is refused, not drawn from on the CPU."""
    from snn_automotive_object_detection_tpu_torch.models import factory

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DetectorConfig(num_classes=3)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.init_resnet50_fpn(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy_tree({"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="generator lives on cpu"):
        factory.draw_device(g, torch.device("cuda", 0))
    tree = flatten_tree(init_params(cfg, g, device="cpu"))
    assert all(t.device.type == "cpu" for t in tree.values())
    assert from_numpy_tree([np.ones(2, np.float32)], device="cpu")[0].device.type == "cpu"
