"""Port vs JAX: the factory's other heads and routes, on the CPU.

  * The ANN heads (``rpn_head_ann_apply``, ``two_mlp_head_apply``,
    ``fastrcnn_predictor_apply``) on the JAX init's weights with nonzero
    biases: float32 within 1e-5 (relative and absolute; the same products
    summed in another order), bf16 within 1e-2 relative plus 1e-2 (one
    bf16 rounding of the products, taken in another order, before the f32
    bias).
  * The ANN postprocess: ``_per_class_nms`` keep masks equal,
    ``postprocess_detections_ann`` (per-class boxes and one box) and
    ``roi_heads_forward(open_set=False)`` equal in labels and validity,
    scores within 1e-6, boxes within 1e-4, in float32.
  * ``detector_apply`` evaluation of the three mixed routes (rpn_snn,
    detector_snn) = (False, True), (True, False), (False, False), in
    float32 at a 64 x 128 bucket with T = 4, on the JAX backbone's own
    features (from a shared backbone the match is exact; the two libraries'
    convolutions differ by ulps before it): every output the JAX package
    gives, at tests/test_torch_detector_e2e.py's tolerances (scores 1e-4
    relative / 1e-5, boxes 1e-3 / 5e-2, labels and validity exact, rates
    1e-6), and no output it does not give. Where an ANN RPN head feeds the
    spiking box head, its own float32 convolutions move the proposals by
    ulps, which flips a few encoder spikes: that route's detections are
    held as that test holds the whole detector (see ``_hold``).
  * The same with bf16 neuron states (``snn_state_dtype=None``) on the
    port's kernel route (K1's bf16-state instance, K2, K3 and the bf16-state
    tail, as their plain versions) against the JAX package on its own
    kernel route (Pallas kernels in interpret mode), on the same bf16
    features: the RPN head's objectness and rates equal bit for bit; the
    RoIAligns sum in another order, so a pooled value can round to the
    other bf16 neighbour and flip an encoder spike (one RoI of 40 here), and
    the box head's outputs are held by the borderline rule of ``_hold``.
  * One training step of the ANN detector in float32 with the JAX
    sampler's draws: the four losses within 1e-5 relative, the gradients of
    the RPN head, the box head and ``box_predictor`` within 1e-4 of their
    largest element; ``split_trainable`` trains ``box_predictor`` and the
    step moves it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from snn_automotive_object_detection_tpu.models import detector as j_detector
from snn_automotive_object_detection_tpu.models import heads as j_heads
from snn_automotive_object_detection_tpu.models import resnet_fpn as j_resnet
from snn_automotive_object_detection_tpu.models import roi_heads as j_roi
from snn_automotive_object_detection_tpu.models import transform as j_transform
from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
from snn_automotive_object_detection_tpu.models.factory import init_params as j_init
from snn_automotive_object_detection_tpu.models.rpn import RPNConfig as JRPN
from snn_automotive_object_detection_tpu.train import optim as j_optim
from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
from snn_automotive_object_detection_tpu_torch.models import heads as t_heads
from snn_automotive_object_detection_tpu_torch.models import roi_heads as t_roi
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.train import optim as t_optim
from snn_automotive_object_detection_tpu_torch.train import steps as t_steps
from snn_automotive_object_detection_tpu_torch.utils.weights import (
    flatten_tree,
    from_numpy_tree,
    to_numpy_tree,
    tree_leaves,
)

from tests.test_torch_train_losses import roi_draws, rpn_draws
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)


IMG, N, T = (64, 128), 2, 4
MEAN, STD = (0.2869, 0.3251, 0.2839), (0.1870, 0.1902, 0.1872)
RPN_KW = dict(pre_nms_top_n_test=60, post_nms_top_n_test=20, pre_nms_top_n_train=60,
              post_nms_top_n_train=30, batch_size_per_image=64)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---- heads

@pytest.fixture(scope="module")
def ann_params():
    rng = np.random.default_rng(0)
    rpn = _np(j_heads.init_rpn_head_ann(jax.random.PRNGKey(1), 256, 3))
    mlp = _np(j_heads.init_two_mlp_head(jax.random.PRNGKey(2), 512, 64))
    pred = _np(j_heads.init_fastrcnn_predictor(jax.random.PRNGKey(3), 64, 5))
    for leaf in rpn.values():
        leaf["b"] = rng.normal(0, 0.1, leaf["b"].shape).astype(np.float32)
    return rpn, mlp, pred


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ann_heads_match(ann_params, dtype):
    rpn, mlp, pred = ann_params
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(4)
    feats = [rng.normal(0, 1, (2, h, w, 256)).astype(np.float32) for h, w in ((6, 10), (3, 5))]
    jo, jb, jr = j_heads.rpn_head_ann_apply(rpn, [jnp.asarray(f) for f in feats], jd)
    to, tb, tr = t_heads.rpn_head_ann_apply(from_numpy_tree(rpn, "cpu"),
                                            [torch.from_numpy(f) for f in feats], td)
    assert jr is None and tr is None
    for a, b in zip(to + tb, list(jo) + list(jb)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    x = rng.uniform(0, 1, (30, 512)).astype(np.float32)
    jrep = j_heads.two_mlp_head_apply(mlp, jnp.asarray(x), jd)
    trep = t_heads.two_mlp_head_apply(from_numpy_tree(mlp, "cpu"), torch.from_numpy(x), td)
    np.testing.assert_allclose(trep.numpy(), np.asarray(jrep), **tol)
    jc, jr = j_heads.fastrcnn_predictor_apply(pred, jrep)
    tc, tr = t_heads.fastrcnn_predictor_apply(from_numpy_tree(pred, "cpu"), _t(jrep))
    assert tc.shape == (30, 5) and tr.shape == (30, 20)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)


# ---- postprocess

def _roi_inputs(n_reg_per_class=True, seed=5, p=40, c=5):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(10, 110, (N, p, 2))
    half = rng.uniform(4, 20, (N, p, 2))
    props = np.concatenate([ctr - half, ctr + half], -1).astype(np.float32)
    logits = rng.normal(0, 1.5, (N, p, c)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (N, p, 4 * c if n_reg_per_class else 4)).astype(np.float32)
    valid = rng.uniform(0, 1, (N, p)) > 0.1
    sizes = np.asarray([[64, 128], [60, 100]], np.int32)
    return logits, deltas, props, valid, sizes


def test_per_class_nms_matches():
    logits, deltas, props, valid, sizes = _roi_inputs()
    rng = np.random.default_rng(6)
    boxes = np.repeat(props[:, :, None], 4, axis=2) + rng.normal(0, 3, (N, 40, 4, 4))
    boxes = boxes.astype(np.float32)
    scores = rng.uniform(0, 1, (N, 40, 4)).astype(np.float32)
    vmask = rng.uniform(0, 1, (N, 40, 4)) > 0.3
    got = t_roi._per_class_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                               torch.from_numpy(vmask), 0.45)
    for i in range(N):
        want = j_roi._per_class_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                    jnp.asarray(vmask[i]), 0.45)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(vmask.sum())


@pytest.mark.parametrize("one_box", [False, True])
def test_postprocess_detections_ann_matches(one_box):
    logits, deltas, props, valid, sizes = _roi_inputs(not one_box)
    kw = dict(score_thresh=0.1, nms_thresh=0.45, detections_per_img=100)
    cfg, jcfg = t_roi.RoIConfig(**kw), j_roi.RoIConfig(**kw)
    got = t_roi.postprocess_detections_ann(*(torch.from_numpy(a) for a in
                                             (logits, deltas, props, valid, sizes)), cfg)
    for i in range(N):
        want = j_roi.postprocess_detections_ann(*(jnp.asarray(a[i]) for a in
                                                  (logits, deltas, props, valid, sizes)), jcfg)
        np.testing.assert_array_equal(got["valid"][i].numpy(), np.asarray(want["valid"]))
        np.testing.assert_array_equal(got["labels"][i].numpy(), np.asarray(want["labels"]))
        np.testing.assert_allclose(got["scores"][i].numpy(), np.asarray(want["scores"]),
                                   atol=1e-6)
        np.testing.assert_allclose(got["boxes"][i].numpy(), np.asarray(want["boxes"]),
                                   atol=1e-4)
    assert 5 < int(got["valid"].sum()) < N * 100


def test_roi_heads_forward_ann_matches():
    rng = np.random.default_rng(7)
    mlp = _np(j_heads.init_two_mlp_head(jax.random.PRNGKey(8), 32 * 49, 32))
    pred = _np(j_heads.init_fastrcnn_predictor(jax.random.PRNGKey(9), 32, 5))
    feats = [rng.normal(0, 1, (N, 64 // s, 128 // s, 32)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    _, _, props, valid, sizes = _roi_inputs(seed=10)
    jcfg, cfg = j_roi.RoIConfig(score_thresh=0.1), t_roi.RoIConfig(score_thresh=0.1)

    def j_head(flat):
        rep = j_heads.two_mlp_head_apply(mlp, flat, jnp.float32)
        return (*j_heads.fastrcnn_predictor_apply(pred, rep), None)

    tm, tp = from_numpy_tree(mlp, "cpu"), from_numpy_tree(pred, "cpu")

    def t_head(flat):
        rep = t_heads.two_mlp_head_apply(tm, flat, torch.float32)
        return (*t_heads.fastrcnn_predictor_apply(tp, rep), None)

    want = jax.jit(lambda f, pr, v, sz: j_roi.roi_heads_forward(
        j_head, f, pr, v, sz, IMG, jcfg, False, open_set=False)[0])(
        [jnp.asarray(f) for f in feats], jnp.asarray(props), jnp.asarray(valid),
        jnp.asarray(sizes))
    got, losses = t_roi.roi_heads_forward(t_head, [torch.from_numpy(f) for f in feats],
                                          torch.from_numpy(props), torch.from_numpy(valid),
                                          torch.from_numpy(sizes), IMG, cfg, open_set=False)
    assert losses == {} and sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3)
    assert int(got["valid"].sum()) > 5


# ---- the detector's routes on shared backbone features

def _params(jcfg):
    """The JAX init's tree for the config as numpy, scaled so that the
    spiking heads fire (as tests/test_torch_detector_e2e.py scales them)."""
    p = _np(j_init(jcfg, jax.random.PRNGKey(0)))
    for layer in p["backbone"]["fpn"]["layer"]:
        layer["w"] *= 8.0
    if jcfg.rpn_snn:
        p["rpn_head"]["shared_conv"]["w"] *= 6.0
        p["rpn_head"]["conv_cls"]["w"] *= 6.0
    else:   # the ANN head's deltas small against the scaled features
        p["rpn_head"]["cls_logits"]["w"] *= 20.0
        p["rpn_head"]["bbox_pred"]["w"] *= 0.02
    if jcfg.detector_snn:
        for k, s in (("fc6", 2.0), ("fc7", 2.0), ("cls_score", 60.0)):
            p["box_head"][k]["w"] *= s
    return p


def _configs(rpn_snn, det_snn, dtype, states=jnp.float32):
    from snn_automotive_object_detection_tpu.models.roi_heads import RoIConfig as JRoI
    from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig

    # The ANN operating point; the spiking one's NMS with a score threshold
    # that four steps of random weights reach.
    roi = dict(score_thresh=0.25 if det_snn else 0.1, nms_thresh=0.5 if det_snn else 0.45,
               detections_per_img=30, batch_size_per_image=32)
    common = dict(num_classes=5, t_rpn=T, t_det=T, min_size=IMG[0], max_size=IMG[1],
                  image_mean=MEAN, image_std=STD, rpn_snn=rpn_snn, detector_snn=det_snn)
    jcfg = JConfig(rpn=JRPN(**RPN_KW), roi=JRoI(**roi), compute_dtype=dtype,
                   snn_state_dtype=states, **common)
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, None: None}
    tcfg = DetectorConfig(rpn=RPNConfig(**RPN_KW), roi=RoIConfig(**roi), compute_dtype=tdt[dtype],
                          snn_state_dtype=tdt[states], **common)
    return jcfg, tcfg


def _batch():
    rng = np.random.default_rng(8)
    images = rng.uniform(0, 1, (N, *IMG, 3)).astype(np.float32)
    ctr = rng.uniform(0.25, 0.75, (N, 3, 2)) * np.array([IMG[1], IMG[0]])
    half = rng.uniform(6, 20, (N, 3, 2))
    return {"images": images, "image_sizes": np.asarray([IMG] * N, np.int32),
            "original_sizes": np.asarray([[128, 256]] * N, np.int32),
            "targets": {"boxes": np.concatenate([ctr - half, ctr + half], -1).astype(np.float32),
                        "labels": rng.integers(1, 5, (N, 3)),
                        "valid": np.array([[True, True, True], [True, True, False]])}}


_FEATURES = {}


def _features(p, dtype):
    """The JAX backbone's features of the batch, computed once per dtype:
    every config here draws the same backbone (the JAX init splits its key
    the same way whatever the heads)."""
    if dtype not in _FEATURES:
        jp = jax.tree.map(jnp.asarray, p["backbone"])
        _FEATURES[dtype] = jax.jit(lambda x: j_resnet.resnet50_fpn_apply(
            jp, j_transform.normalize_images(x, MEAN, STD), dtype))(
            jnp.asarray(_batch()["images"]))
    return _FEATURES[dtype]


def _eval_both(rpn_snn, det_snn, dtype=jnp.float32, states=jnp.float32):
    jcfg, tcfg = _configs(rpn_snn, det_snn, dtype, states)
    p = _params(jcfg)
    feats = _features(p, dtype)
    batch = _batch()
    del batch["targets"]
    jp = jax.tree.map(jnp.asarray, p)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_detector, "resnet50_fpn_apply", lambda *a, **k: list(feats))
        run = jax.jit(lambda p_, b_: j_detector.detector_apply(p_, b_, jcfg, training=False,
                                                                collect_rates=True)[0])
        if dtype == jnp.bfloat16:   # the JAX package's kernel route, in interpret mode
            mp.setattr(jax, "default_backend", lambda: "tpu")
            with pltpu.force_tpu_interpret_mode():
                jdet = run(jp, jax.tree.map(jnp.asarray, batch))
        else:
            jdet = run(jp, jax.tree.map(jnp.asarray, batch))
    tfeats = [torch.from_numpy(np.asarray(f.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16) for f in feats]
    target = "resnet50_fpn_apply" if dtype == jnp.float32 else "resnet50_fpn_apply_from_p1"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_detector, target, lambda *a, **k: tfeats)
        tdet, _ = t_detector.detector_apply(from_numpy_tree(p, "cpu"),
                                            {k: torch.from_numpy(v) for k, v in batch.items()},
                                            tcfg, collect_rates=True)
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), jdet), \
        jax.tree.map(lambda t: t.float().numpy(), tdet)


ROUTES = [(False, True), (True, False), (False, False)]


@pytest.fixture(scope="module")
def routes():
    return {r: _eval_both(*r) for r in ROUTES}


@pytest.fixture(scope="module")
def states16():
    return _eval_both(True, True, jnp.bfloat16, None)


def _matched(jdet, tdet, i):
    """Detections of image i on both sides with the same label, score within
    1e-4 and box within 5e-2 (+1e-3 relative), each used once: (matched,
    JAX's count, the port's count)."""
    want = [jdet[k][i][jdet["valid"][i]] for k in ("boxes", "scores", "labels")]
    got = [tdet[k][i][tdet["valid"][i].astype(bool)] for k in ("boxes", "scores", "labels")]
    used = np.zeros(len(got[1]), bool)
    hits = 0
    for box, score, label in zip(*want):
        ok = ((got[2] == label) & ~used & (np.abs(got[1] - score) <= 1e-4 + 1e-4 * score)
              & (np.abs(got[0] - box) <= 5e-2 + 1e-3 * np.abs(box)).all(axis=1))
        if ok.any():
            used[np.argmax(ok)] = True
            hits += 1
    return hits, len(want[1]), len(got[1])


def _hold(jdet, tdet, borderline=False):
    """Every output the JAX package gives, and no other, at the tolerances
    of tests/test_torch_detector_e2e.py. With ``borderline`` the box head's
    inputs differ by float32 ulps (an ANN RPN head's own convolutions, summed
    in another order, move proposals by 1e-2 pixels), which the spiking box
    head's encoder thresholds turn into a few flipped spikes: its outputs
    are then held as that test holds the whole detector: over the images,
    detection counts within 10% and at least 90% of the detections matched
    either way, at most 5% of the pre-NMS class
    scores and boxes and 15% of the RoIs' spike rates outside tolerance."""
    assert sorted(k for k, v in jdet.items() if v is not None) == sorted(
        k for k, v in tdet.items() if v is not None)
    np.testing.assert_allclose(tdet["objectness"], jdet["objectness"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdet["proposals"], jdet["proposals"], rtol=1e-3, atol=5e-2)
    if jdet.get("rpn_rates") is not None:
        for k, v in jdet["rpn_rates"].items():
            np.testing.assert_allclose(tdet["rpn_rates"][k], v, atol=1e-6, err_msg=k)
    if borderline:
        hits = [_matched(jdet, tdet, i) for i in range(N)]
        print(f"detections matched (port, JAX): {hits}")
        hit, n_want, n_got = (sum(h[j] for h in hits) for j in range(3))
        assert n_want > 0 and abs(n_got - n_want) <= 0.1 * n_want
        assert hit >= 0.9 * max(n_want, n_got)
        for k, rtol, atol in (("all_scores", 1e-4, 1e-5), ("all_boxes", 1e-3, 5e-2)):
            bad = int((np.abs(tdet[k] - jdet[k]) > atol + rtol * np.abs(jdet[k])).sum())
            print(f"{k}: {bad} of {jdet[k].size} outside tolerance")
            assert bad <= 0.05 * jdet[k].size
        for k, v in jdet["det_rates"].items():
            bad = int((np.abs(tdet["det_rates"][k] - v) > 1e-3).sum())
            print(f"det_rates/{k}: {bad} of {v.size} RoIs outside 1e-3")
            assert bad <= 0.15 * v.size
        return
    np.testing.assert_array_equal(tdet["valid"], jdet["valid"])
    np.testing.assert_array_equal(tdet["labels"], jdet["labels"])
    np.testing.assert_allclose(tdet["scores"], jdet["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdet["boxes"], jdet["boxes"], rtol=1e-3, atol=5e-2)
    if "all_boxes" in jdet:
        np.testing.assert_allclose(tdet["all_scores"], jdet["all_scores"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tdet["all_boxes"], jdet["all_boxes"], rtol=1e-3, atol=5e-2)
    if jdet.get("det_rates") is not None:
        for k, v in jdet["det_rates"].items():
            np.testing.assert_allclose(tdet["det_rates"][k], v, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("route", ROUTES)
def test_mixed_route_matches_on_shared_features(routes, route):
    jdet, tdet = routes[route]
    _hold(jdet, tdet, borderline=route == (False, True))
    n_fg = int((jdet["valid"] & (jdet["labels"] > 0)).sum())
    print(f"(rpn_snn, detector_snn) = {route}: {n_fg} FG detections, max objectness "
          f"{jdet['objectness'].max():.3f}")
    assert ("all_boxes" in tdet) == route[1]
    assert (tdet.get("rpn_rates") is None) == (not route[0])
    assert n_fg > 0
    if not route[1]:
        assert tdet["boxes"].shape == (N, 30, 4)


def test_bf16_states_route_matches_the_jax_kernel_route(states16):
    jdet, tdet = states16
    np.testing.assert_array_equal(tdet["objectness"], jdet["objectness"])
    _hold(jdet, tdet, borderline=True)
    print({g: {k: float(v.mean()) for k, v in jdet[g].items()}
           for g in ("rpn_rates", "det_rates")})
    assert jdet["rpn_rates"]["shared"].mean() > 0.05 and jdet["det_rates"]["fc6"].mean() > 0.05


# ---- one ANN training step

def test_ann_training_step_matches(monkeypatch):
    jcfg, tcfg = _configs(False, False, jnp.float32)
    p = _params(jcfg)
    feats = _features(p, jnp.float32)
    batch = _batch()
    jp = jax.tree.map(jnp.asarray, p)
    jt, jf = j_optim.split_trainable(jp)
    assert "box_predictor" in jt
    key = jax.random.PRNGKey(11)

    def loss_fn(trainable):
        _, losses = j_detector.detector_apply(j_optim.merge_params(trainable, jf),
                                              jax.tree.map(jnp.asarray, batch), jcfg,
                                              training=True, rng=key)
        return sum(losses.values()), losses

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_detector, "resnet50_fpn_apply", lambda *a, **k: list(feats))
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jt)
    key_rpn, key_roi = jax.random.split(key)
    n_anchors = sum((IMG[0] // s) * (IMG[1] // s) * 3 for s in (4, 8, 16, 32, 64))
    draws = {"rpn": tuple(torch.from_numpy(d) for d in rpn_draws(key_rpn, N, n_anchors)),
             "roi": tuple(torch.from_numpy(d) for d in roi_draws(
                 key_roi, N, RPN_KW["post_nms_top_n_train"] + 3))}
    tfeats = [torch.from_numpy(np.array(f)) for f in feats]
    tt, tf = t_optim.split_trainable(from_numpy_tree(p, "cpu"))
    assert "box_predictor" in tt and "box_predictor" not in tf
    before = [leaf.clone() for leaf in tree_leaves(tt["box_predictor"])]
    opt, sched = t_optim.build_optimizer(tt, "SGD", 0.01, momentum=0.9, weight_decay=1e-4)
    tbatch = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v)) for k, v in batch.items()}
    monkeypatch.setattr(t_detector, "resnet50_fpn_apply", lambda *a: tfeats)
    tlosses = t_steps.make_train_step(tcfg, opt, sched)(tt, tf, tbatch, None, draws)
    for k, v in jlosses.items():
        print(f"{k}: port {float(tlosses[k]):.7f} jax {float(v):.7f}")
        assert float(tlosses[k]) == pytest.approx(float(v), rel=1e-5), k
    tgrads = to_numpy_tree(tt, grads=True)
    for group in ("rpn_head", "box_head", "box_predictor"):
        got, want = flatten_tree(tgrads[group]), flatten_tree(jax.tree.map(np.asarray,
                                                                           jgrads[group]))
        assert sorted(got) == sorted(want)
        for k in want:
            top = np.abs(want[k]).max()
            assert top > 0 and np.abs(got[k] - want[k]).max() <= 1e-4 * top, (group, k)
    after = tree_leaves(tt["box_predictor"])
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
