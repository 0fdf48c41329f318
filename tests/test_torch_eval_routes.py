"""The evaluation route of the port, picked by the compute dtype, on the CPU.

With ``compute_dtype=torch.float32`` ``detector_apply(training=False)``
runs the reference's scans (``heads.rpn_head_snn_scan_apply``,
``heads.fastrcnn_snn_scan_apply``) and the gather RoIAlign, as the JAX
package gates its kernels on bf16: none of the kernels' wrappers is
called, on either device. With bf16 it calls the kernels' wrappers (their
plain versions here). The kernels' weight layouts (taps transposed for the
TMA loads of K1 and K5) are checked against the plain versions' weights.
A tiny bucket (64 x 128, T = 2) keeps this module to a few seconds.
"""

import pytest
import torch

from snn_automotive_object_detection_tpu_torch.models import detector, heads, roi_heads
from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig, init_params
from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
from snn_automotive_object_detection_tpu_torch.ops import cuda_fpn
from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

N = 2


def _config(dtype):
    return DetectorConfig(num_classes=3, t_rpn=2, t_det=2, min_size=64, max_size=128,
                          rpn=RPNConfig(pre_nms_top_n_test=40, post_nms_top_n_test=16),
                          compute_dtype=dtype)


@pytest.fixture(scope="module")
def params():
    return init_params(_config(torch.float32), torch.Generator().manual_seed(0), device="cpu")


def _batch():
    g = torch.Generator().manual_seed(1)
    return {"images": torch.rand((N, 64, 128, 3), generator=g),
            "image_sizes": torch.tensor([[64, 128]] * N),
            "original_sizes": torch.tensor([[128, 256]] * N)}


# The kernels' wrappers as the heads and the RoI heads call them.
WRAPPERS = [(cuda_rpn, "rpn_level"), (cuda_rpn, "rpn_level_x2"), (heads, "encoder_fc6"),
            (heads, "box_tail"), (roi_heads, "roi_align")]


def _count_wrappers(monkeypatch):
    calls = {name: 0 for _, name in WRAPPERS}
    for mod, name in WRAPPERS:
        def counted(*args, _f=getattr(mod, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*args, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("collect_rates", [True, False])
def test_float32_eval_takes_the_scans(monkeypatch, params, collect_rates):
    calls = _count_wrappers(monkeypatch)
    scans = {"rpn": 0, "box": 0}
    for key, name in (("rpn", "rpn_head_snn_scan_apply"), ("box", "fastrcnn_snn_scan_apply")):
        def counted(*args, _f=getattr(heads, name), _k=key, **kw):
            scans[_k] += 1
            return _f(*args, **kw)
        monkeypatch.setattr(heads, name, counted)
    cfg = _config(torch.float32)
    out, losses = detector.detector_apply(params, _batch(), cfg, collect_rates=collect_rates)
    assert all(v == 0 for v in calls.values()), calls
    assert scans == {"rpn": 1, "box": 1} and losses == {}
    p = cfg.rpn.post_nms_top_n_test
    assert out["boxes"].shape[0] == N and out["boxes"].shape[1] > p
    assert out["all_scores"].shape == (N, p, 3) and out["all_boxes"].shape == (N, p, 3, 4)
    for k in ("boxes", "scores", "proposals", "objectness", "all_scores", "all_boxes"):
        assert out[k].dtype == torch.float32 and bool(torch.isfinite(out[k]).all()), k
    assert ("rpn_rates" in out) == collect_rates
    if collect_rates:
        assert out["rpn_rates"]["shared"].shape == (5, N)


def test_bf16_eval_takes_the_kernels(monkeypatch, params):
    calls = _count_wrappers(monkeypatch)
    monkeypatch.setattr(cuda_rpn, "PAIR_IMAGES", False)
    out, _ = detector.detector_apply(params, _batch(), _config(torch.bfloat16),
                                     collect_rates=True)
    assert calls == {"rpn_level": 5, "rpn_level_x2": 0, "encoder_fc6": 1, "box_tail": 1,
                     "roi_align": 1}
    assert bool(torch.isfinite(out["objectness"]).all())


def test_kernel_weight_layouts():
    """K1 and K8 take each tap [output, input]; K5 the lateral weights and
    each tap of the output conv the same way."""
    g = torch.Generator().manual_seed(2)
    w = torch.randn((3, 3, 256, 256), generator=g)
    taps_t = cuda_rpn._taps_t(w)
    assert taps_t.shape == (9, 256, 256) and taps_t.dtype == torch.bfloat16
    assert taps_t.is_contiguous()
    for k in range(9):
        assert torch.equal(taps_t[k], w[k // 3, k % 3].t().to(torch.bfloat16))
    wlat, blat = torch.randn((1, 1, 512, 256), generator=g), torch.randn(256, generator=g)
    bout = torch.randn(256, generator=g)
    wlat_t, blat_k, w9_t, bout_k = cuda_fpn.kernel_weights(wlat, blat, w, bout)
    assert wlat_t.shape == (256, 512) and wlat_t.is_contiguous()
    assert torch.equal(wlat_t, wlat[0, 0].t().to(torch.bfloat16))
    assert torch.equal(w9_t, taps_t)
    assert torch.equal(blat_k, blat.to(torch.bfloat16))
    assert torch.equal(bout_k, bout.to(torch.bfloat16))
