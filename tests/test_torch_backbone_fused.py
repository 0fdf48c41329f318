"""Port vs JAX: the fused backbone route as a whole, bf16, on the CPU.

JAX side: ``stem_pallas_apply`` (interpret mode) ->
``resnet50_fpn_apply_from_p1(fpn_pallas=True)``, the route its detector
takes by default on its chip. Port side: ``stem_apply`` ->
``resnet50_fpn_apply_from_p1`` on CPU tensors (the kernels' plain
versions). One bottleneck per stage, so 25 bf16 convolutions lie between
the image and the levels (stem, 4 x 4 body, 4 lateral, 4 output), at
64 x 256 with the published widths.

The stems agree but for 1 element of 131072. From then on each convolution
is summed in another order by XLA and by oneDNN, a sum near a bf16 rounding
boundary lands on the other side now and then, and every later layer sees
that ulp as an input difference: the two sides drift apart by ulps of the
VALUES' TYPICAL magnitude, not of each element's own. So the bound is
stated in bf16 ulps (2^-7) of the level's largest value: measured 0.64 to
0.88 of them, held at 4; the relative L2 error per level is measured at
0.35% to 0.40% and held at 1%. The share of elements outside one
ulp of their own value (2^-7 |want| + 1e-4) is printed.

The second test runs ``detector_apply`` with ``compute_dtype=bfloat16`` on
the CPU: the dtype picks the fused route (plain versions, since the tensors
lie on the CPU), and the outputs are well formed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.models import resnet_fpn as j_resnet
from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
from snn_automotive_object_detection_tpu.models.factory import init_params as j_init
from snn_automotive_object_detection_tpu.ops import pallas_stem as j_stem
from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
from snn_automotive_object_detection_tpu_torch.models import resnet_fpn as t_resnet
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.ops import cuda_fpn, cuda_stem
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc
from snn_automotive_object_detection_tpu_torch.utils.weights import from_numpy_tree
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

MEAN, STD = (0.2869, 0.3251, 0.2839), (0.1870, 0.1902, 0.1872)
IMG = (64, 256)
MAX_ULPS_OF_LEVEL_MAX = 4.0
MAX_REL_L2 = 0.01


def _small_params():
    """The JAX init's tree with one bottleneck per stage and frozen-BN
    statistics away from the identity."""
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda a: np.array(a, np.float32),
                     j_init(JConfig(num_classes=3), jax.random.PRNGKey(0)))
    for stage in range(1, 5):
        p["backbone"][f"layer{stage}"] = p["backbone"][f"layer{stage}"][:1]

    def bn(tree):
        if isinstance(tree, dict):
            if "bn" in tree:
                c = tree["bn"]["scale"].shape[0]
                tree["bn"]["scale"] = rng.uniform(0.75, 1.3, c).astype(np.float32)
                tree["bn"]["bias"] = rng.normal(0, 0.05, c).astype(np.float32)
            for v in tree.values():
                bn(v)
        elif isinstance(tree, list):
            for v in tree:
                bn(v)

    bn(p["backbone"])
    for lvl in p["backbone"]["fpn"]["inner"] + p["backbone"]["fpn"]["layer"]:
        lvl["b"] = rng.normal(0, 0.05, lvl["b"].shape).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def params():
    return _small_params()


def test_fused_backbone_matches_jax(params):
    x = np.random.default_rng(1).uniform(0, 1, (2, *IMG, 3)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params["backbone"])
    p1 = j_stem.stem_pallas_apply(jp["stem"], j_stem.planarize_image(jnp.asarray(x), MEAN),
                                  MEAN, STD, interpret=True)
    want = [np.asarray(f, np.float32)
            for f in j_resnet.resnet50_fpn_apply_from_p1(jp, p1, fpn_pallas=True)]

    tp = from_numpy_tree(params["backbone"], device="cpu")
    cb.reset_counts()
    q1 = cuda_stem.stem_apply(tp["stem"], torch.from_numpy(x), MEAN, STD)
    got = t_resnet.resnet50_fpn_apply_from_p1(tp, q1)
    assert not any(cb.LAUNCHES.values()) and not any(cb.PLAIN_CUDA_CALLS.values())
    stem_diff = int((q1.float().numpy() != np.asarray(p1, np.float32)).sum())
    print(f"stem: {stem_diff} of {q1.numel()} elements differ")
    assert stem_diff <= kc.MAX_DIFFERING * q1.numel()

    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        g = g.float().numpy()
        d = np.abs(g - w)
        top = np.abs(w).max()
        ulps = d.max() / (kc.BF16_REL * top)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        outside = (d > kc.BF16_REL * np.abs(w) + kc.ATOL).mean()
        print(f"level {lvl} {w.shape}: max |diff| {d.max():.4g} = {ulps:.2f} bf16 ulps of "
              f"the largest value {top:.4g}; relative L2 {rel:.4%}; "
              f"{outside:.2%} of the elements outside one ulp of their own value, "
              f"{(g != w).mean():.2%} differ at all")
        assert ulps <= MAX_ULPS_OF_LEVEL_MAX
        assert rel <= MAX_REL_L2


def test_bf16_detector_takes_the_fused_route_on_cpu(params):
    cfg = DetectorConfig(
        num_classes=3, t_rpn=2, t_det=2, min_size=IMG[0], max_size=IMG[1],
        image_mean=MEAN, image_std=STD,
        rpn=RPNConfig(pre_nms_top_n_test=40, post_nms_top_n_test=20),
        roi=RoIConfig(detections_per_img=10), compute_dtype=torch.bfloat16)
    tparams = from_numpy_tree(params, device="cpu")
    n = 2
    batch = {"images": torch.from_numpy(
                 np.random.default_rng(2).uniform(0, 1, (n, *IMG, 3)).astype(np.float32)),
             "image_sizes": torch.tensor([IMG] * n),
             "original_sizes": torch.tensor([[128, 512]] * n)}
    calls = {"stem": 0, "fpn_level": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            assert args[0].device.type == "cpu"
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_stem, "_folded_plain", counted("stem", cuda_stem._folded_plain))
        mp.setattr(cuda_fpn, "fpn_level_plain",
                   counted("fpn_level", cuda_fpn.fpn_level_plain))
        mp.setattr(t_detector, "resnet50_fpn_apply",
                   lambda *a: pytest.fail("bf16 took the unfused chain"))
        cb.reset_counts()
        out, _ = t_detector.detector_apply(tparams, batch, cfg, collect_rates=True)
    assert calls == {"stem": 1, "fpn_level": 4}
    assert not any(cb.LAUNCHES.values()) and not any(cb.PLAIN_CUDA_CALLS.values())
    p, d, c = 20, 10, 3
    s = sum(min(40, (IMG[0] // st) * (IMG[1] // st) * 3) for st in (4, 8, 16, 32, 64))
    shapes = {"boxes": (n, d + p, 4), "scores": (n, d + p), "labels": (n, d + p),
              "valid": (n, d + p), "proposals": (n, s, 4), "objectness": (n, s),
              "all_scores": (n, p, c), "all_boxes": (n, p, c, 4)}
    for k, shp in shapes.items():
        assert tuple(out[k].shape) == shp, k
        if out[k].is_floating_point():
            assert torch.isfinite(out[k]).all(), k
    assert float(out["scores"].min()) >= 0 and float(out["scores"].max()) <= 1
    assert int(out["labels"].max()) < c
    for group in ("rpn_rates", "det_rates"):
        for k, v in out[group].items():
            assert torch.isfinite(v).all() and float(v.min()) >= 0 and float(v.max()) <= 1

    # float32 keeps the unfused chain: no fused stage is reached.
    cfg32 = DetectorConfig(**{**cfg.__dict__, "compute_dtype": torch.float32})
    calls.update(stem=0, fpn_level=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_stem, "_folded_plain", counted("stem", cuda_stem._folded_plain))
        mp.setattr(cuda_fpn, "fpn_level_plain",
                   counted("fpn_level", cuda_fpn.fpn_level_plain))
        t_detector.detector_apply(tparams, batch, cfg32)
    assert calls == {"stem": 0, "fpn_level": 0}
