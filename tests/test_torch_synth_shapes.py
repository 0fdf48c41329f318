"""The port's synthetic shape set and bench-weight trainer
(``snn_automotive_object_detection_tpu_torch/tools``), on the CPU.

  * tests/test_synth_shapes.py's properties on the port's batches: images
    in [0, 1], labels 1..5 on valid rows and 0 elsewhere, at least two
    objects an image, bright pixels only inside ground-truth boxes and
    every box holding a fifth of its shape; other seeds, other images.
  * :func:`paint` on the JAX package's own draws (its ``synth_image``'s
    key splits, remade here) gives the JAX image within 1e-6 and its boxes
    within 1e-6 relative (XLA may fuse a product and a sum into one
    rounding), labels and validity exactly.
  * ``make_bench_weights`` for 2 steps at a 64 x 128 bucket (RPN budgets
    200 in training and 100 in evaluation, 64 RoIs an image), held-out
    evaluation on 2 images: finite losses (it raises otherwise), 12 finite
    stats, the ``.partial`` file gone after the final save, and the same
    detections from the weights read back from its ``.pth``, whose
    ``--eval-only --load`` gives the same stats.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from snn_automotive_object_detection_tpu_torch.tools import make_bench_weights as mbw
from snn_automotive_object_detection_tpu_torch.tools import synth_shapes as ts
from snn_automotive_object_detection_tpu_torch.train.steps import make_eval_step
from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_weights_lenient,
)
from tools.synth_shapes import NUM_SHAPE_CLASSES, synth_image
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)


def test_synth_batch_properties():
    b = ts.synth_batch(torch.Generator().manual_seed(3), 2, 128, 256, max_boxes=6)
    img, boxes = b["images"].numpy(), b["targets"]["boxes"].numpy()
    labels, valid = b["targets"]["labels"].numpy(), b["targets"]["valid"].numpy()
    assert img.shape == (2, 128, 256, 3) and img.dtype == np.float32
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert ((labels >= 1) & (labels <= NUM_SHAPE_CLASSES))[valid].all()
    assert (labels[~valid] == 0).all() and valid.sum(axis=1).min() >= 2
    assert b["image_sizes"].tolist() == [[128, 256]] * 2
    for i in range(2):
        bright = img[i].max(-1) > 0.3
        ys, xs = np.nonzero(bright)
        inside = np.zeros(len(ys), bool)
        for g in range(6):
            if not valid[i, g]:
                continue
            x0, y0, x1, y1 = boxes[i, g]
            assert x1 > x0 and y1 > y0
            inside |= ((xs + 0.5 >= x0) & (xs + 0.5 < x1) & (ys + 0.5 >= y0) & (ys + 0.5 < y1))
            xi0, yi0, xi1, yi1 = boxes[i, g].astype(int)
            assert bright[yi0:yi1, xi0:xi1].mean() > 0.2
        assert (~inside).sum() == 0


def test_synth_batches_differ_per_seed():
    a, b = (ts.synth_batch(torch.Generator().manual_seed(s), 1, 64, 128, max_boxes=4)
            for s in (0, 1))
    assert not torch.equal(a["images"], b["images"])


def _jax_draws(key, h, w, g):
    """``synth_image``'s draws from ``key``, split as it splits it, in
    :func:`draw_params`' layout for one image."""
    ks = jax.random.split(key, 8)
    u = jax.random.uniform
    draws = {
        "n": jax.random.randint(ks[0], (), 2, g + 1)[None],
        "cls": jax.random.randint(ks[1], (g,), 1, NUM_SHAPE_CLASSES + 1),
        "long": jnp.exp(u(ks[2], (g,), minval=jnp.log(40.0), maxval=jnp.log(440.0))),
        "aspect": jnp.exp(u(ks[3], (g,), minval=jnp.log(0.5), maxval=jnp.log(2.0))),
        "ux": u(ks[4], (g,)), "uy": u(ks[5], (g,)),
        "bright": u(ks[6], (g, 1), minval=0.55, maxval=1.0),
        "noise": u(ks[7], (h, w, 3), minval=0.0, maxval=0.22),
    }
    out = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    out = {k: v if k == "n" else v[None] for k, v in out.items()}
    out["n"], out["cls"] = out["n"].long(), out["cls"].long()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_paint_on_the_jax_draws_gives_the_jax_image(seed):
    h, w, g = 128, 256, 8
    key = jax.random.PRNGKey(seed)
    img, boxes, labels, valid = (np.asarray(a) for a in jax.jit(
        lambda k: synth_image(k, h, w, g))(key))
    t_img, t_boxes, t_labels, t_valid = ts.paint(_jax_draws(key, h, w, g), h, w)
    np.testing.assert_allclose(t_img[0].numpy(), img, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_boxes[0].numpy(), boxes, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(t_labels[0].numpy(), labels)
    np.testing.assert_array_equal(t_valid[0].numpy(), valid)
    assert valid.sum() >= 2


def test_make_bench_weights_two_steps_on_the_cpu(tmp_path):
    # The flagship's heads at the small bucket, with a tenth of its RPN and
    # RoI budgets: the box head runs on 200 rows a batch, not 2000.
    flagship = mbw.bench_config()
    config = mbw.bench_config(
        min_size=64, max_size=128,
        rpn=dataclasses.replace(flagship.rpn, pre_nms_top_n_train=200, post_nms_top_n_train=200,
                                pre_nms_top_n_test=100, post_nms_top_n_test=100),
        roi=dataclasses.replace(flagship.roi, batch_size_per_image=64))
    out = tmp_path / "w.pth"
    argv = ["--out", str(out), "--steps", "2", "--eval-images", "2", "--save-every", "1",
            "--device", "cpu"]
    stats, cls_ap, params = mbw.main(mbw.get_args_parser().parse_args(argv), config)
    assert stats.shape == (12,) and np.isfinite(stats).all()
    assert sorted(cls_ap) == list(range(1, NUM_SHAPE_CLASSES + 1))
    assert out.exists() and not (tmp_path / "w.pth.partial").exists()

    loaded = load_weights_lenient(
        mbw.init_params(config, torch.Generator().manual_seed(7), device="cpu"),
        load_checkpoint(str(out))["params"])
    batch = ts.synth_batch(torch.Generator().manual_seed(mbw.HELDOUT_SEED), 2, 64, 128)
    del batch["targets"]
    step = make_eval_step(config)
    a, b = step(params, batch), step(loaded, batch)
    assert sorted(a) == sorted(b)
    for k in ("boxes", "scores", "labels", "valid", "proposals", "objectness"):
        assert torch.equal(a[k], b[k]), k

    again, _, _ = mbw.main(mbw.get_args_parser().parse_args(
        argv + ["--eval-only", "--load", str(out)]), config)
    np.testing.assert_array_equal(again, stats)
