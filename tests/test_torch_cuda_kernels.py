"""The four hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small and ragged shapes (the flagship shapes are
chip_smoke.py's): pixel rows that end inside a 32-pixel segment, RoI rows
that end inside a row tile, boxes on and past the image border.

Every test here needs a CUDA device and is marked ``cuda``; without one it
skips. The module imports no JAX, so it also runs where JAX is not
installed (tests/conftest.py does import it; pass ``--noconftest`` there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances, on identical bf16 inputs:
  * encoder spike counts: exact (integer functions of the input);
  * LIF spikes: K1 neurons whose spike train differs (their LI-weighted
    spike sums differ) and K4 per-row |count differences| at most 0.1% of
    the LIF spikes, since sums in another order can put a current one bf16
    ulp apart and move a membrane across the threshold;
  * K1 readout and K4 logits: every element within 2^-7 |want| + 1e-4
    (utils/kernel_checks.py: one bf16 ulp of the value, since both sides
    round the same f32 sums of spikes once to bf16), and every K1 readout
    element a bf16 value;
  * K2: 1e-5 absolute on N(0, 1) features (the same f32 operations on the
    same bf16 values; measured bit-equal on an H100);
  * K3: 1e-3 absolute (sums of 0/1 x bf16 weights in another order).
"""

import pytest
import torch

from snn_automotive_object_detection_tpu_torch.ops import cuda_roi_align as k2
from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6 as k3
from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1
from snn_automotive_object_detection_tpu_torch.snn import cuda_tail as k4
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

pytestmark = pytest.mark.cuda
BF = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The plain versions round each bf16 product once, from f32.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda:0")


@pytest.mark.parametrize("h,w,t", [(3, 45, 8), (2, 7, 4), (5, 64, 12)])
def test_rpn_head_kernel_matches_plain(dev, h, w, t):
    g = torch.Generator(device=dev).manual_seed(h * w + t)
    feat = (torch.rand((2, h, w, 256), generator=g, device=dev) * 2).to(BF)
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.02
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.05
    before = cb.LAUNCHES[k1.NAME]
    out, enc, lif, ssum = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k1.NAME] == before + 1
    p_out, p_enc, p_lif, p_ssum = k1.rpn_level_plain(feat, w_shared, w_out, t,
                                                     spike_sum=True)
    assert out.shape == (2, h, w, 15) and ssum.shape == (2, h, w, 256)
    assert torch.equal(enc, p_enc)
    assert int(p_lif.sum()) > 0
    assert int((ssum != p_ssum).sum()) <= 1e-3 * int(p_lif.sum())
    assert kc.bf16_valued(out)
    assert kc.excess(out, p_out) <= 1


def test_roi_align_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    size = (128, 192)
    feats = [torch.randn((2, a, b, 256), generator=g, device=dev).to(BF)
             for a, b in ((32, 48), (16, 24), (8, 12), (4, 6))]
    ctr = torch.rand((2, 37, 2), generator=g, device=dev) * torch.tensor(
        [192.0, 128.0], device=dev)
    wh = torch.rand((2, 37, 2), generator=g, device=dev) * 120 + 1
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    boxes[0, 0] = torch.tensor([0.0, 0.0, 192.0, 128.0])     # whole image
    boxes[0, 1] = torch.tensor([-20.0, -20.0, 5.0, 5.0])     # partly outside
    boxes[0, 2] = torch.tensor([50.0, 50.0, 50.5, 50.5])     # below 1 pixel
    boxes[1, 0] = torch.tensor([189.0, 125.0, 201.0, 137.0])  # past the far border
    boxes[1, 1] = torch.tensor([2.0, 60.0, 190.0, 62.0])     # sliver
    boxes = boxes.contiguous()
    out = k2.roi_align(feats, boxes, size)
    want = k2.plain(feats, boxes, size)
    assert out.shape == (2, 37, 7, 7, 256)
    assert float((out - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("r,t", [(150, 12), (32, 4), (7, 1)])
def test_encoder_fc6_kernel_matches_plain(dev, r, t):
    g = torch.Generator(device=dev).manual_seed(r + t)
    x = (torch.rand((r, 512), generator=g, device=dev) * 2.5).to(BF)
    w6 = ((torch.rand((512, 128), generator=g, device=dev) * 2 - 1) / 22.0).to(BF)
    cur6, cnt = k3.encoder_fc6(x, w6, t)
    want, want_cnt = k3.encoder_fc6_plain(x, w6, t)
    assert cur6.shape == (t, r, 128)
    assert torch.equal(cnt, want_cnt) and int(cnt.sum()) > 0
    assert float((cur6 - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("r,t", [(203, 12), (8, 10), (3, 8)])
def test_box_tail_kernel_matches_plain(dev, r, t):
    g = torch.Generator(device=dev).manual_seed(r * t)
    cur6 = (torch.randn((t, r, 1024), generator=g, device=dev) * 0.15).to(BF)
    w7 = (torch.rand((1024, 1024), generator=g, device=dev) * 2 - 1) / 32.0
    wc = (torch.rand((1024, 9), generator=g, device=dev) * 2 - 1) / 32.0
    wb = (torch.rand((1024, 36), generator=g, device=dev) * 2 - 1) / 32.0
    cls, box, c6, c7 = k4.box_tail(cur6, w7, wc, wb)
    p_cls, p_box, p6, p7 = k4.box_tail_plain(cur6, w7, wc, wb)
    assert cls.shape == (r, 9) and box.shape == (r, 36)
    assert torch.equal(c6, p6) and int(p7.sum()) > 0
    assert int((c7 - p7).abs().sum()) <= 1e-3 * int(p7.sum()) + 1
    assert kc.excess(cls, p_cls) <= 1
    assert kc.excess(box, p_box) <= 1


def test_kernels_refuse_other_dtypes(dev):
    feat = torch.zeros((1, 2, 2, 256), device=dev)
    with pytest.raises(TypeError):
        k1.rpn_level(feat, torch.zeros((3, 3, 256, 256), device=dev),
                     torch.zeros((256, 15), device=dev), 4)
    with pytest.raises(TypeError):
        k3.encoder_fc6(torch.zeros((4, 64), device=dev), torch.zeros((64, 64), device=dev), 4)
