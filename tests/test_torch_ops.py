"""Port vs JAX: box ops, anchors, NMS, top-k selection with ties.

Tolerances: keep sets, selected indices, orders and anchors are exact.
Box arithmetic without transcendentals (IoU, clip, masks) is bit-exact;
box decoding uses exp, whose float32 result may differ by an ulp between
the two libraries, so decoded boxes compare to 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models.rpn import select_pre_nms as j_select
from snn_automotive_object_detection_tpu.ops import anchors as janc
from snn_automotive_object_detection_tpu.ops import boxes as jbox
from snn_automotive_object_detection_tpu.ops import nms as jnms
from snn_automotive_object_detection_tpu_torch.models.rpn import select_pre_nms
from snn_automotive_object_detection_tpu_torch.ops import anchors as tanc
from snn_automotive_object_detection_tpu_torch.ops import boxes as tbox
from snn_automotive_object_detection_tpu_torch.ops import nms as tnms
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)


def _boxes(rng, n, spread=200.0, size=(10, 80)):
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_ops_match(rng):
    a, b = _boxes(rng, 50), _boxes(rng, 40)
    np.testing.assert_array_equal(
        tbox.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jbox.box_iou(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        tbox.clip_boxes_to_image(torch.from_numpy(a), 120, 150).numpy(),
        np.asarray(jbox.clip_boxes_to_image(jnp.asarray(a), (120, 150))))
    np.testing.assert_array_equal(
        tbox.small_box_mask(torch.from_numpy(a), 40.0).numpy(),
        np.asarray(jbox.small_box_mask(jnp.asarray(a), 40.0)))
    d = rng.normal(0, 1.5, (50, 12)).astype(np.float32)
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = tbox.decode_boxes(torch.from_numpy(d), torch.from_numpy(a)[:, None]
                                .expand(50, 1, 4).reshape(50, 4), w).numpy()
        want = np.asarray(jbox.decode_boxes(jnp.asarray(d), jnp.asarray(a), w))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_anchors_match():
    shapes = [(32, 64), (16, 32), (8, 16), (4, 8), (2, 4)]
    for got, want in zip(tanc.generate_anchors(shapes, (128, 256)),
                         janc.generate_anchors(shapes, (128, 256))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("groups,presorted,block", [
    (False, False, None), (True, False, None), (False, True, None),
    (True, False, 64), (False, False, 1000)])
def test_nms_keep_sets_exact(rng, groups, presorted, block):
    b, n = 3, 600
    boxes = np.stack([_boxes(rng, n, spread=300.0) for _ in range(b)])
    # Quantised scores: plenty of exact ties.
    scores = np.round(rng.uniform(0, 1, (b, n)), 2).astype(np.float32)
    if presorted:
        scores = -np.sort(-scores, axis=1)
    valid = rng.uniform(size=(b, n)) > 0.1
    grp = rng.integers(0, 4, (b, n)) if groups else None
    got_k, got_o = tnms.nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
        0.5, None if grp is None else torch.from_numpy(grp), block, presorted)
    for i in range(b):
        want_k, want_o = jnms.nms_mask(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]),
            0.5, None if grp is None else jnp.asarray(grp[i]), block, presorted)
        np.testing.assert_array_equal(got_k[i].numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(got_o[i].numpy(), np.asarray(want_o))
        assert 0 < got_k[i].sum() < valid[i].sum()


def test_nms_in_block_chain_matches_reference():
    """a -> b -> c -> d overlap chain in one block: the reference's
    fixpoint keeps a, c and d (greedy NMS would drop d); the port must
    return the same keep set."""
    boxes = np.asarray([[0, 0, 10, 10], [3, 0, 13, 10], [6, 0, 16, 10],
                        [9, 0, 19, 10]], np.float32)
    scores = np.asarray([4, 3, 2, 1], np.float32)
    want, _ = jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.ones(4, bool), 0.3)
    got, _ = tnms.nms_mask(torch.from_numpy(boxes)[None],
                           torch.from_numpy(scores)[None],
                           torch.ones(1, 4, dtype=torch.bool), 0.3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert got[0].tolist() == [True, False, True, True]


def test_fixpoint_one_round_equals_reference_loop(rng):
    """The port settles the in-block fixpoint in one round; the reference
    iterates until nothing changes. The suppressed sets must be equal."""
    for b, density in ((8, 0.5), (64, 0.1), (256, 0.02), (256, 0.2)):
        sup = (rng.uniform(size=(b, b)) < density) & np.triu(np.ones((b, b), bool), 1)
        want = np.asarray(jnms._self_suppress_fixpoint(jnp.asarray(sup)))
        got = tnms._self_suppress_fixpoint(torch.from_numpy(sup)[None])[0]
        np.testing.assert_array_equal(got.numpy(), want)


def test_pruned_nms_select_and_topk_exact(rng):
    b, n, k = 4, 500, 64
    boxes = np.stack([_boxes(rng, n, spread=150.0) for _ in range(b)])
    scores = np.round(rng.uniform(0, 1, (b, n)), 2).astype(np.float32)
    valid = np.zeros((b, n), bool)
    for i in range(b):
        valid[i, rng.choice(n, 50, replace=False)] = True
    tb, ts, tv = (torch.from_numpy(x) for x in (boxes, scores, valid))
    got = tnms.nms_mask_pruned(tb, ts, tv, 0.5, k)
    keep_full, order = tnms.nms_mask(tb, ts, tv, 0.5)
    np.testing.assert_array_equal(got.numpy(), keep_full.numpy())
    sel_idx, sel_valid = tnms.select_kept_in_order(order, keep_full)
    top_idx, top_valid = tnms.topk_after_nms(ts, keep_full, 80)
    for i in range(b):
        want = jnms.nms_mask_pruned(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                    jnp.asarray(valid[i]), 0.5, k)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        j_keep, j_order = jnms.nms_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                        jnp.asarray(valid[i]), 0.5)
        wi, wv = jnms.select_kept_in_order(j_order, j_keep)
        np.testing.assert_array_equal(sel_idx[i].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(sel_valid[i].numpy(), np.asarray(wv))
        ti, tvv = jnms.topk_after_nms(jnp.asarray(scores[i]), j_keep, 80)
        nv = int(np.asarray(tvv).sum())
        np.testing.assert_array_equal(top_valid[i].numpy(), np.asarray(tvv))
        np.testing.assert_array_equal(top_idx[i, :nv].numpy(), np.asarray(ti)[:nv])


def test_select_pre_nms_ties_lowest_index_first(rng):
    """bf16-rounded logits tie often; selection and order must match the
    reference's lowest-index-first top-k, including its blocked top-k on
    levels of 2 x 16384 anchors and more."""
    counts = [40000, 3000, 600]
    obj = rng.normal(0, 1, (2, sum(counts))).astype(np.float32)
    obj = np.asarray(jnp.asarray(obj).astype(jnp.bfloat16).astype(jnp.float32))
    want_v, want_i = j_select(jnp.asarray(obj), counts, 1000)
    got_v, got_i = select_pre_nms(torch.tensor(obj), counts, 1000)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert len(np.unique(np.asarray(want_v)[0])) < want_v.shape[1]  # ties occur
