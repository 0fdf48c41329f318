"""Port vs JAX at the shapes the JAX package runs beyond a batch of two in
the landscape bucket: a batch of one and of three (odd) in the 64 x 128
bucket, a batch of two in the transposed (portrait) 128 x 64 bucket as the
loader plans it for a mixed-orientation set, and the 320 MobileNet preset's
RPN budgets and thresholds.

Setup of tests/test_torch_detector_e2e.py at a smaller bucket: T_rpn =
T_det = 6, 5 classes, float32 on both sides (the reference's scans, the
gather RoIAlign), weights scaled so that every spiking layer fires. The
weights are the port's ``init_params`` draws (the JAX init's
distributions, ``utils/weights.py`` carries them across), scaled as
``_scale`` scales the JAX tree. The JAX side runs its whole
``detector_apply`` eval under one ``jax.jit`` per shape, its backbone's
levels among the outputs.

  * From the JAX backbone's levels on, at each shape, every output of the
    port agrees element by element at tests/test_torch_detector_e2e.py's
    shared-feature tolerances (labels and validity exact; scores 1e-4
    relative + 1e-5; boxes 1e-3 + 5e-2; spike rates 1e-6), with no outlier.
  * Per image, a batch of three gives each image's batch-of-one outputs from
    the same levels, in float32 (the scans) and in bf16 (the kernels' plain
    versions), by the same rule; the elements that differ at all are
    printed. On the CPU they are not bit-equal: PyTorch's CPU convolutions
    and products sum in another order for another batch size, which moves
    a few readouts by an ulp (the card's kernels work image by image and
    are held bit for bit in ``chip_smoke.py``'s ``shapes`` phase).
  * The loader's plan for two portrait and two landscape images: batches of
    one orientation each, in the transposed bucket for the portrait pair;
    the port's anchors for that bucket are the JAX package's; the whole
    portrait detector (each side's own backbone, whose float32
    convolutions differ by ulps) against JAX by the borderline rule of
    test_torch_detector_e2e.py (FG counts within 10%, at least 90% of each
    side's detections matched, at most 5% of pre-NMS scores and
    coordinates outside tolerance, RPN rates within 1e-3); and the graph
    keys of the evaluation's graphed functions (``utils/graphs.py``): one
    per function for both buckets over the loader's batches.
  * The 320 preset (``mobilenet_320_preset``: RPN 150 / 150, score
    threshold 0.05) equals the JAX ``create_model``'s and, at a 128 x 256
    MobileNet bucket where both budgets and the threshold bind (a further
    gain of 8 on the objectness readout puts some selected anchors under
    0.05), gives the JAX outputs from shared levels by the same rule.
"""

import copy
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import factory as j_factory
from snn_automotive_object_detection_tpu.models import mobilenet_fpn as j_mobilenet
from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
from snn_automotive_object_detection_tpu.models.roi_heads import RoIConfig as JRoI
from snn_automotive_object_detection_tpu.models.rpn import RPNConfig as JRPN
from snn_automotive_object_detection_tpu.ops import anchors as j_anchors
from snn_automotive_object_detection_tpu_torch.data.loader import DetectionLoader, to_device_batch
from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
from snn_automotive_object_detection_tpu_torch.models import factory as t_factory
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils import graphs as graphs_mod
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree, to_numpy_tree
from tests.test_torch_detector_e2e import (
    MEAN, STD, T_STEPS, _fg, _jax_eval, _matches, _mismatches, _scale)
from tests.test_torch_mobilenet import FPN_GAIN, FastEncoderConfig
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

IMG = (64, 128)
PORTRAIT = (IMG[1], IMG[0])
MOBILE_IMG = (128, 256)
RPN_CLS_GAIN = 8.0
COMMON = dict(num_classes=5, t_rpn=T_STEPS, t_det=T_STEPS, image_mean=MEAN, image_std=STD)
RPN_KW = dict(pre_nms_top_n_test=100, post_nms_top_n_test=50)
ROI_KW = dict(detections_per_img=100)
OUTPUTS = ("boxes", "scores", "labels", "valid", "proposals", "objectness", "all_scores",
           "all_boxes")


def _configs():
    common = dict(min_size=IMG[0], max_size=IMG[1], **COMMON)
    return (JConfig(rpn=JRPN(**RPN_KW), roi=JRoI(**ROI_KW), compute_dtype=jnp.float32, **common),
            t_factory.DetectorConfig(rpn=RPNConfig(**RPN_KW), roi=RoIConfig(**ROI_KW),
                                     compute_dtype=torch.float32, **common))


@functools.lru_cache(maxsize=None)
def _params(backbone="resnet50_fpn"):
    """The port's seeded draws as a numpy tree, scaled so that every spiking
    layer fires (MobileNet's small last maps take test_torch_mobilenet.py's
    further gain on the FPN outputs)."""
    cfg = t_factory.DetectorConfig(backbone=backbone, **COMMON)
    p = _scale(to_numpy_tree(t_factory.init_params(cfg, torch.Generator().manual_seed(0),
                                                   device="cpu")))
    if backbone != "resnet50_fpn":
        for layer in p["backbone"]["fpn"]["layer"]:
            layer["w"] *= FPN_GAIN
    return p


def _images(n, hw, seed=7):
    return np.random.default_rng(seed).uniform(0, 1, (n, *hw, 3)).astype(np.float32)


def _batch(images):
    n, h, w, _ = images.shape
    return {"images": images, "image_sizes": np.asarray([(h, w)] * n, np.int32),
            "original_sizes": np.asarray([(2 * h, 2 * w)] * n, np.int32)}


def _jax(params, batch, jcfg, module=None, name="resnet50_fpn_apply"):
    """The JAX eval under one jit: (outputs as numpy, the backbone's levels)."""
    det = jax.tree.map(np.asarray, _jax_eval(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch), jcfg, module,
        name))
    return det, det.pop("features")


def _port(params, batch, tcfg, feats=None, backbone="resnet50_fpn_apply"):
    """The port's eval with rates on ``batch``; with ``feats`` (numpy or
    torch levels) in place of its backbone's output."""
    tparams = from_numpy_tree(params, device="cpu")
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
              if k in ("images", "image_sizes", "original_sizes")}
    with pytest.MonkeyPatch.context() as mp:
        if feats is not None:
            levels = [f if torch.is_tensor(f) else torch.from_numpy(np.array(f)) for f in feats]
            mp.setattr(t_detector, backbone, lambda *args, **kw: levels)
        out, _ = t_detector.detector_apply(tparams, tbatch, tcfg, collect_rates=True)
    return jax.tree.map(lambda t: t.float().numpy() if t.is_floating_point() else t.numpy(), out)


# Outputs of one row per proposal or anchor, with their tolerances.
ROW_TOLS = {"objectness": (1e-4, 1e-5), "all_scores": (1e-4, 1e-5), "proposals": (1e-3, 5e-2),
            "all_boxes": (1e-3, 5e-2)}
OFF_SHARE = 0.01        # of such an output's elements outside its tolerance
MATCHED_SHARE = 0.95    # of each side's detections matched on the other side
RATE_OFF_SHARE = 0.02   # of the RoIs' rates off by more than 1e-6


def _hold(got, want, n, what):
    """``got`` against ``want`` (n images) at test_torch_detector_e2e.py's
    shared-feature tolerances, with the borderline flips counted and
    bounded. A spike flipped in one RoI moves its class scores and can add
    or drop a detection, which shifts the rows after it: detections are
    therefore matched (label, score and box within tolerance, each used
    once), at least ``MATCHED_SHARE`` of each side's; in the outputs of one
    row per proposal or anchor at most ``OFF_SHARE`` of the elements
    outside tolerance; at most ``RATE_OFF_SHARE`` of the RoIs' rates off by
    more than 1e-6, and every rate within 1e-3. Prints every count."""
    counts = {}
    for k, (rtol, atol) in ROW_TOLS.items():
        assert got[k].shape == want[k].shape, k
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        counts[k] = int((np.abs(g - w) > atol + rtol * np.abs(w)).sum())
        assert counts[k] <= OFF_SHARE * w.size, (what, k, counts[k], w.size)
    for k in ("boxes", "scores", "labels", "valid"):
        assert got[k].shape == want[k].shape, k
    fg_w, fg_g, hit_w, hit_g = [], [], 0, 0
    for i in range(n):
        wi, gi = _fg(want, i), _fg(got, i)
        fg_w.append(len(wi[1]))
        fg_g.append(len(gi[1]))
        hit_w, hit_g = hit_w + _matches(wi, gi), hit_g + _matches(gi, wi)
    for group in ("rpn_rates", "det_rates"):
        for k, v in want[group].items():
            d = np.abs(got[group][k] - v)
            counts[f"{group}/{k}"] = int((d > 1e-6).sum())
            assert d.max() <= 1e-3, (what, group, k, float(d.max()))
            if group == "det_rates":
                assert counts[f"{group}/{k}"] <= RATE_OFF_SHARE * v.size, (what, group, k)
    print(f"{what}: elements outside tolerance {counts}; FG detections per image port "
          f"{fg_g}, JAX {fg_w}, matched {hit_g} / {hit_w}; mean RPN LIF rate "
          f"{float(want['rpn_rates']['shared'].mean()):.4f}, box head fc7 "
          f"{float(want['det_rates']['fc7'].mean()):.4f}")
    assert min(fg_w) >= 1
    assert hit_w >= MATCHED_SHARE * sum(fg_w) and hit_g >= MATCHED_SHARE * sum(fg_g)
    assert want["rpn_rates"]["shared"].max() > 0.05 and want["det_rates"]["fc7"].mean() > 0.02


# ---------------------------------------------------------------- landscape


@pytest.fixture(scope="module")
def landscape():
    """JAX's outputs and levels at batch 1 and 3 of the 64 x 128 bucket (the
    batch of one is the first image of the three)."""
    jcfg, tcfg = _configs()
    images = _images(3, IMG)
    runs = {n: _jax(_params(), _batch(images[:n]), jcfg) for n in (1, 3)}
    return dict(images=images, runs=runs, tcfg=tcfg)


@pytest.mark.parametrize("n", [1, 3])
def test_heads_on_shared_levels_match_jax(landscape, n):
    want, feats = landscape["runs"][n]
    cb.reset_counts()
    got = _port(_params(), _batch(landscape["images"][:n]), landscape["tcfg"], feats)
    assert all(v == 0 for v in cb.LAUNCHES.values())
    assert got["rpn_rates"]["shared"].shape == (5, n)
    _hold(got, want, n, f"batch {n}, shared levels")


def _image(out, i, n):
    """Image i's part of an n-image output dict, as a one-image output."""
    part = {k: out[k][i:i + 1] for k in OUTPUTS}
    part["rpn_rates"] = {k: v[:, i:i + 1] for k, v in out["rpn_rates"].items()}
    part["det_rates"] = {k: v.reshape(n, -1)[i] for k, v in out["det_rates"].items()}
    return part


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_batch_of_three_gives_each_image_its_batch_of_one_outputs(landscape, dtype):
    _, feats = landscape["runs"][3]
    levels = [torch.from_numpy(np.array(f)).to(dtype) for f in feats]
    tcfg = dataclasses.replace(landscape["tcfg"], compute_dtype=dtype)
    # bf16 takes the fused stem and FPN: the levels replace their output.
    backbone = "resnet50_fpn_apply" if dtype == torch.float32 else "resnet50_fpn_apply_from_p1"
    images = landscape["images"]
    three = _port(_params(), _batch(images), tcfg, levels, backbone)
    for i in range(3):
        one = _port(_params(), _batch(images[i:i + 1]), tcfg, [f[i:i + 1] for f in levels],
                    backbone)
        got = _image(three, i, 3)
        differ = {k: int((got[k] != one[k]).sum()) for k in OUTPUTS}
        print(f"image {i}: elements that differ from its batch of one {differ}")
        _hold(got, one, 1, f"image {i} of 3 against its batch of 1")
    assert int((three["valid"] & (three["labels"] > 0)).sum()) >= 3


# ----------------------------------------------------------------- portrait


class MixedOrientation:
    """Two portrait (256 x 128) and two landscape (128 x 256) seeded uint8
    images, alternating, with the size metadata the loader plans by."""

    def __init__(self):
        rng = np.random.default_rng(3)
        self.images = [rng.integers(0, 256, (256, 128, 3) if i % 2 == 0 else (128, 256, 3),
                                    dtype=np.uint8) for i in range(4)]

    def __len__(self):
        return len(self.images)

    def get_height_and_width(self, i):
        return self.images[i].shape[:2]

    def __getitem__(self, i):
        return self.images[i], {"image_id": i}


@pytest.fixture(scope="module")
def portrait():
    loader = DetectionLoader(MixedOrientation(), batch_size=2, bucket=IMG, min_size=IMG[0],
                             max_size=IMG[1], with_targets=False, num_workers=2)
    batches = list(loader)
    jcfg, tcfg = _configs()
    tall = [b for b in batches if b["images"].shape[1:3] == PORTRAIT]
    assert len(tall) == 1
    want, feats = _jax(_params(), tall[0], jcfg)
    return dict(batches=batches, batch=tall[0], want=want, feats=feats, tcfg=tcfg)


def test_loader_plans_one_orientation_a_batch(portrait):
    shapes = sorted(b["images"].shape for b in portrait["batches"])
    assert shapes == [(2, *IMG, 3), (2, *PORTRAIT, 3)]
    for b in portrait["batches"]:
        ids = b["image_ids"].tolist()
        assert {i % 2 for i in ids} == ({0} if b["images"].shape[1] > b["images"].shape[2]
                                        else {1}), ids
        assert (b["image_sizes"] == b["images"].shape[1:3]).all()


def test_anchors_follow_the_batch_bucket(portrait):
    """The detector builds its anchors from the image tensor's shape: the
    portrait levels' anchors are the JAX package's for that bucket, and
    both buckets' outputs keep their proposals inside their own images."""
    tcfg = portrait["tcfg"]
    spec = tcfg.anchor_spec
    shapes = tuple((PORTRAIT[0] // s, PORTRAIT[1] // s) for s in tcfg.fpn_strides)
    got, counts = t_detector._anchors(shapes, PORTRAIT, spec, torch.device("cpu"))
    want = np.concatenate([np.asarray(a) for a in j_anchors.generate_anchors(
        list(shapes), PORTRAIT, j_factory.DetectorConfig().anchor_spec)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert counts == tuple(h * w * 3 for h, w in shapes)
    for b in portrait["batches"]:
        out = _port(_params(), to_device_batch(b, "cpu"), tcfg)
        h, w = b["original_sizes"][0]
        assert out["proposals"].shape[1] == sum(min(100, c) for c in counts)
        boxes = out["boxes"]
        assert (boxes >= 0).all() and (boxes[..., 0::2] <= w).all() and (boxes[..., 1::2] <= h).all()
        assert np.isfinite(out["scores"]).all() and out["valid"].any()


def test_graph_keys_do_not_vary_from_batch_to_batch(portrait, monkeypatch):
    """The graph keys (``utils/graphs.graph_key``) the evaluation's graphed
    functions look up over the loader's batches, each twice: one per
    function for both buckets, since the portrait bucket's levels hold as
    many anchors as the landscape one's; a key that took a batch's values
    would add one per batch. A call from inside another graphed function
    joins that one's graph on the card and looks up no key of its own, so
    it is left out here too."""
    from snn_automotive_object_detection_tpu_torch.models import roi_heads, rpn
    from snn_automotive_object_detection_tpu_torch.ops import nms

    bodies = {f.__wrapped__.__code__ for f in (
        rpn.filter_proposals, nms.nms_mask, nms._pruned_keep, roi_heads._postproc_groups,
        roi_heads._postproc_outputs)}
    keys = {}
    real = graphs_mod.graph_key

    def recorded(fn, args, kwargs):
        key, tensors = real(fn, args, kwargs)
        frame = sys._getframe(1)
        while frame is not None and frame.f_code not in bodies:
            frame = frame.f_back
        if frame is None:
            keys.setdefault(fn.__name__, set()).add(key)
        return key, tensors

    monkeypatch.setattr(graphs_mod, "graph_key", recorded)
    for b in portrait["batches"] * 2:
        _port(_params(), b, portrait["tcfg"])
    print(f"distinct keys per graphed function: { {k: len(v) for k, v in keys.items()} }")
    assert {"filter_proposals", "nms_mask", "_postproc_groups", "_postproc_outputs"} <= set(keys)
    assert all(len(v) == 1 for v in keys.values())


def test_portrait_heads_on_shared_levels_match_jax(portrait):
    got = _port(_params(), portrait["batch"], portrait["tcfg"], portrait["feats"])
    _hold(got, portrait["want"], 2, "portrait, shared levels")


def test_portrait_detector_matches_jax(portrait):
    """Each side's own backbone in the portrait bucket."""
    want, got = portrait["want"], _port(_params(), portrait["batch"], portrait["tcfg"])
    n_w = n_g = hit_w = hit_g = 0
    for i in range(2):
        wi, gi = _fg(want, i), _fg(got, i)
        hw, hg = _matches(wi, gi), _matches(gi, wi)
        n_w, n_g, hit_w, hit_g = n_w + len(wi[1]), n_g + len(gi[1]), hit_w + hw, hit_g + hg
    bad_s = _mismatches(np.sort(got["objectness"], -1), np.sort(want["objectness"], -1),
                        1e-4, 1e-5)
    n = want["objectness"].size
    print(f"portrait: {n_g} port vs {n_w} JAX FG detections, matched {hit_g} / {hit_w}; "
          f"{bad_s} of {n} pre-NMS scores outside tolerance")
    assert n_w >= 2 and abs(n_g - n_w) <= 0.1 * n_w
    assert hit_w >= 0.9 * n_w and hit_g >= 0.9 * n_g and bad_s <= 0.05 * n
    np.testing.assert_allclose(got["rpn_rates"]["shared"], want["rpn_rates"]["shared"],
                               atol=1e-3)


# ------------------------------------------------------------ the 320 preset


def test_320_preset_budgets_match_jax_on_shared_levels(monkeypatch):
    monkeypatch.setattr(j_factory, "init_params", lambda *args, **kw: None)
    made, _ = j_factory.create_model("cityscapes", 5, True, True,
                                     backbone="mobilenet_v3_large_320_fpn")
    preset = t_factory.mobilenet_320_preset()
    assert dataclasses.asdict(preset["rpn"]) == dataclasses.asdict(made.rpn)
    assert (preset["min_size"], preset["max_size"]) == made.bucket == (320, 640)
    small = dict(min_size=MOBILE_IMG[0], max_size=MOBILE_IMG[1], **COMMON)
    fields = {f.name: getattr(made, f.name) for f in dataclasses.fields(made)}
    jcfg = FastEncoderConfig(**{**fields, **small, "compute_dtype": jnp.float32,
                                "roi": JRoI(**ROI_KW)})
    tcfg = t_factory.DetectorConfig(**{**preset, **small}, roi=RoIConfig(**ROI_KW),
                                    compute_dtype=torch.float32)
    # A further gain on the objectness readout spreads the scores so that
    # the preset's 0.05 threshold drops some of the selected anchors.
    params = copy.deepcopy(_params(preset["backbone"]))
    params["rpn_head"]["conv_cls"]["w"] *= RPN_CLS_GAIN
    batch = _batch(_images(2, MOBILE_IMG, seed=9))
    want, feats = _jax(params, batch, jcfg, j_mobilenet, "mobilenet_v3_fpn_apply")
    got = _port(params, batch, tcfg, feats, "mobilenet_v3_fpn_apply")
    # Both budgets bind: 150 of each stride-32 level's 480 anchors, the
    # pool level's 120, then 150 proposals an image into the box head.
    assert want["objectness"].shape == (2, 150 + 150 + 120)
    assert want["all_scores"].shape == (2, 150, 5)
    low = int((want["objectness"] < made.rpn.score_thresh).sum())
    print(f"pre-NMS scores under the preset's 0.05 threshold: {low} of {want['objectness'].size}")
    assert low > 0
    _hold(got, want, 2, "320 preset, shared levels")
