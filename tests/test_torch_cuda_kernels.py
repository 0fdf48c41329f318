"""The nine hand-written CUDA kernels (the nine TPU kernels' counterparts)
against their plain PyTorch versions, on the card, at small and ragged
shapes (the flagship FPN too; the other
flagship shapes are chip_smoke.py's): pixel rows that end inside a 16- or
32-pixel segment, RoI rows
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
    element a bf16 value; where a K1 spike flipped, against the plain
    product of the kernel's own spike sums. The same for the training
    forward;
  * K2: 1e-5 absolute on N(0, 1) features (the same f32 operations on the
    same bf16 values, the level mapper's too; measured bit-equal on an
    H100), boxes on the mapper's level borders included;
  * K3: 1e-3 absolute (sums of 0/1 x bf16 weights in another order); its
    training instance: codes equal to the plain version's (for every bf16
    value too), currents within one bf16 ulp + 1e-4 (both sides round f32
    sums of the same spikes once);
  * the fc6 weight gradient from those codes: within 1e-4 of its largest
    element (f32 sums of the same exact products in another order), the
    same bits on a second run;
  * K5 merged map and P, K6: ``kernel_checks.chain_excess``: a product sum
    taken in another order may round one bf16 ulp apart, by 2^-7 of its own
    magnitude, which the bf16 adds after it (bias, upsample) can largely
    cancel, so the bound is 2^-7 (roundings |want| + |addends|) + 1e-4; and
    at most 1% of the elements may differ at all (a rounding made at
    another place would flip far more). P is held against the plain 3x3 on
    the kernel's own merged map, so that both sides get the same inputs.
  * K7 (the RPN head's backward, from K1's saved tensors): both weight
    gradients within 5e-4 of the gradient's largest element
    (``kernel_checks.grad_excess``: the same spikes and the same reverse
    sweep on both sides, the plain version summing in f64 and the kernel on
    the tensor cores) against the replaying plain version, the sweep's
    spike sums equal to K1's neuron by neuron, and the same bits on a
    second run. Where K1 and its plain version differ in a LIF spike
    (allowed as above), ``dw_out``, which is linear in the spike sums, is
    held against the plain product of K1's own sums. Against its plain
    version on K1's own saved tensors (the same dc planes) within 1e-4.
  * K8 (the paired RPN head, K1's kernel with a pair of images in one
    cluster): its readout and spike sums equal to K1's bit for bit (the
    same sums in the same order), and held to its plain version as K1 is.
  * The bf16-state instances (K1's evaluation and training instances, K7's
    and K8's): as the f32-state ones, against their bf16-state plain
    versions; on weights of the 2^-10 grid (conv sums exact in any order)
    the currents and spikes are the plain version's bits.
  * K9 (the fused box head): spike by spike
    (``kernel_checks.box_head_fused_report``): its fc6 spike trains against
    the plain version's and its fc7 trains against the plain tail's on its
    own fc6 spikes, flipped (row, neuron, step) bits at most 0.1% of the
    spikes plus one (sums in another order can move a membrane at the
    threshold across it); every row whose fc7 trains agree within 1e-3
    (1 + |want|) of that tail (the same spikes, f32 sums of spikes times
    bf16 weights in another order), all rows within 0.25 (1 + |want|) of
    the whole plain head (a flipped spike moves a logit by a weight times
    an LI coefficient); the counts the popcounts of the kernel's codes; the
    entry point's logits, deltas and rates exactly the held launch's.
"""

import pytest
import torch

from snn_automotive_object_detection_tpu_torch.ops import cuda_fpn as k5
from snn_automotive_object_detection_tpu_torch.ops import cuda_roi_align as k2
from snn_automotive_object_detection_tpu_torch.ops import cuda_stem as k6
from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6 as k3
from snn_automotive_object_detection_tpu_torch.snn import cuda_kernels as k9
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


def _hold_rpn_eval(got, want, w_out):
    """K1's (readout, encoder counts, LIF counts, spike sums) against the
    plain version's: encoder counts exact, neurons with a flipped LIF spike
    at most 0.1% of those that spiked, the readout within one bf16 ulp +
    1e-4 of the plain readout, or, where a spike flipped, of the plain
    product of the kernel's own spike sums (the readout is linear in
    them)."""
    out, enc, _, ssum = got
    p_out, p_enc, p_lif, p_ssum = want
    assert torch.equal(enc, p_enc)
    spiked = int((p_ssum != 0).sum())
    flips = int((ssum != p_ssum).sum())
    assert spiked > 0 and flips <= 1e-3 * spiked
    if flips:
        p_out = torch.matmul(ssum, w_out.to(BF).float()).to(BF).float()
    assert kc.bf16_valued(out) and kc.excess(out, p_out) <= 1


# Widths that end inside a 16-pixel tile, one and two images, T from 1 to
# 32 (one and four chunks of 8 steps, a chunk that ends in the first
# warpgroup's steps), 15, 75 and 128 readout channels.
@pytest.mark.parametrize("n,h,w,t,n_out", [(2, 3, 45, 8, 15), (2, 2, 7, 4, 15),
                                           (1, 5, 64, 12, 15), (1, 3, 21, 1, 75),
                                           (2, 2, 33, 32, 128), (1, 4, 17, 8, 75),
                                           (2, 3, 50, 12, 128),
                                           # P2 of the portrait bucket, of a batch of 8
                                           (2, 384, 192, 8, 15), (8, 192, 384, 8, 15)])
def test_rpn_head_kernel_matches_plain(dev, n, h, w, t, n_out):
    g = torch.Generator(device=dev).manual_seed(n * h * w + t + n_out)
    feat = (torch.rand((n, h, w, 256), generator=g, device=dev) * 2).to(BF)
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.02
    w_out = torch.randn((256, n_out), generator=g, device=dev) * 0.05
    before = cb.LAUNCHES[k1.NAME]
    got = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True)
    no_sum = k1.rpn_level(feat, w_shared, w_out, t)
    trained = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True, save=True)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k1.NAME] == before + 3
    assert got[0].shape == (n, h, w, n_out) and got[3].shape == (n, h, w, 256)
    # Without the spike-sum output: the same readout and counts; the
    # training instance: the same outputs, and what it saves.
    assert all(torch.equal(a, b) for a, b in zip(got[:3], no_sum))
    assert all(torch.equal(a, b) for a, b in zip(got, trained[:4]))
    saved = trained[4]
    assert saved.cur.shape == (n, h, w, t, 256) and torch.equal(saved.ssum, got[3])
    want = k1.rpn_level_plain(feat, w_shared, w_out, t, spike_sum=True, save=True)
    assert torch.equal(saved.per, want[4].per)
    assert kc.excess(saved.cur.float(), want[4].cur.float()) <= 1
    assert kc.differing(saved.cur, want[4].cur) <= kc.MAX_DIFFERING * saved.cur.numel()
    want = want[:4]
    assert t == 1 or int(want[2].sum()) > 0
    if t > 1:
        _hold_rpn_eval(got, want, w_out)
    else:   # one step: no LIF neuron has spiked yet
        assert torch.equal(got[1], want[1]) and int(got[2].sum()) == 0
        assert torch.equal(got[0], want[0]) and float(got[3].abs().max()) == 0


# K1's instance for bf16 neuron states: random weights (flipped spikes
# counted as for K1), and weights on the 2^-10 grid, whose conv sums are
# exact in any order, so that the currents are the plain version's bits and
# no spike may flip.
@pytest.mark.parametrize("n,h,w,t,n_out,grid", [(2, 3, 45, 8, 15, False), (2, 3, 45, 8, 15, True),
                                                (1, 5, 64, 12, 75, True),
                                                (2, 2, 33, 32, 128, True)])
def test_rpn_head_s16_kernel_matches_plain(dev, n, h, w, t, n_out, grid):
    g = torch.Generator(device=dev).manual_seed(n * h * w + t + n_out)
    feat = (torch.rand((n, h, w, 256), generator=g, device=dev) * 2).to(BF)
    if grid:
        w_shared = torch.randint(-10, 11, (3, 3, 256, 256), generator=g,
                                 device=dev).float() * 2.0 ** -10
    else:
        w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.02
    w_out = torch.randn((256, n_out), generator=g, device=dev) * 0.05
    before = dict(cb.LAUNCHES)
    got = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True, bf16_states=True)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k1.S16_NAME] == before[k1.S16_NAME] + 1
    assert cb.LAUNCHES[k1.NAME] == before[k1.NAME]
    want = k1.rpn_level_plain(feat, w_shared, w_out, t, spike_sum=True, bf16_states=True)
    assert int(want[2].sum()) > 0
    if grid:
        assert torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])
    _hold_rpn_eval(got, want, w_out)
    # bf16 states give other spikes than f32 states on the same inputs.
    f32 = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True)
    assert not torch.equal(f32[3], got[3])
    # The training instance with bf16 states: the evaluation instance's bits,
    # the plain version's periods, and on grid weights its currents.
    before = dict(cb.LAUNCHES)
    *trained, saved = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True, save=True,
                                   bf16_states=True)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k1.S16_SAVE_NAME] == before[k1.S16_SAVE_NAME] + 1
    assert cb.LAUNCHES[k1.S16_NAME] == before[k1.S16_NAME]
    assert all(torch.equal(a, b) for a, b in zip(trained, got))
    p_saved = k1.rpn_level_plain(feat, w_shared, w_out, t, save=True, bf16_states=True)[3]
    assert torch.equal(saved.per, p_saved.per)
    if grid:
        assert torch.equal(saved.cur, p_saved.cur)


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


def _roi_boxes(g, dev, n, r, size, lo, hi):
    h, w = size
    ctr = torch.rand((n, r, 2), generator=g, device=dev) * torch.tensor(
        [float(w), float(h)], device=dev)
    wh = torch.rand((n, r, 2), generator=g, device=dev) * (hi - lo) + lo
    return torch.cat([ctr - wh / 2, ctr + wh / 2], -1)


def _hold_roi_align(feats, boxes, size):
    """K2 against its plain version: 1e-5 absolute; prints how many
    elements differ at all."""
    before = cb.LAUNCHES[k2.NAME]
    out = k2.roi_align(feats, boxes, size)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k2.NAME] == before + 1
    want = k2.plain(feats, boxes, size)
    assert out.shape == want.shape and out.dtype == torch.float32
    err = float((out - want).abs().max())
    print(f"K2: max |diff| {err:.3g}, {int((out != want).sum())} of {want.numel()} "
          f"elements differ")
    assert err <= 1e-5 and bool(torch.isfinite(out).all())


# Boxes on the level mapper's borders (sqrt(area) 112, 224 and 448, the
# float32 below, and the neighbouring widths between which the mapper on
# this device moves a level), two levels of one stride (the MobileNet
# route: every box on the first), one RoI and 1000 RoIs per image.
@pytest.mark.parametrize("case", ["level_borders", "same_stride", "one_roi", "r1000",
                                  "portrait", "batch8"])
def test_roi_align_kernel_cases(dev, case):
    """``portrait``: 2 x 1000 boxes over the levels of the 1536 x 768
    bucket; ``batch8``: 8 x 1000 boxes over the flagship's levels."""
    from snn_automotive_object_detection_tpu_torch.ops.roi_align import assign_fpn_levels

    g = torch.Generator(device=dev).manual_seed(len(case))
    size = {"portrait": (1536, 768), "batch8": (768, 1536)}.get(case, (512, 1024))
    shapes = [(size[0] // s, size[1] // s) for s in (4, 8, 16, 32)]
    if case == "same_stride":
        shapes = [(16, 32), (16, 32)]
    n = 8 if case == "batch8" else 2
    feats = [torch.randn((n, a, b, 256), generator=g, device=dev).to(BF) for a, b in shapes]
    r = {"one_roi": 1, "r1000": 1000, "portrait": 1000, "batch8": 1000}.get(case, 40)
    boxes = _roi_boxes(g, dev, n, r, size, 2.0, 500.0)
    if case == "level_borders":
        border = kc.level_border_boxes(lambda b: assign_fpn_levels(b, 4), dev)
        boxes[0, :border.shape[0]] = border
        boxes[1, :border.shape[0]] = border + 37.0
    _hold_roi_align(feats, boxes.contiguous(), size)


def test_roi_align_kernel_refuses_channels_not_a_multiple_of_8(dev):
    feats = [torch.zeros((1, 8, 16, 258), device=dev, dtype=BF)]
    boxes = torch.zeros((1, 3, 4), device=dev)
    boxes[..., 2:] = 16.0
    with pytest.raises(ValueError, match="multiple of 8"):
        k2.roi_align(feats, boxes, (32, 64))


# K3 and K4 run 16 RoI rows per block and pair consecutive row tiles in a
# cluster: R at a tile's edges (1, 15, 16, 17), odd counts of row tiles (1,
# 3 and 125 tiles: the last cluster's partner is a padded tile), T from 1 to
# 16 (one to four m-tiles of 4 steps, T = 10 ending inside one), one and
# two column tiles, and the flagship D = 12544; T = 20 and 32 take two code
# planes and two GEMM passes (T = 17: one step in the second).
@pytest.mark.parametrize("r,d,rep,t", [(150, 512, 128, 12), (32, 512, 128, 4), (7, 512, 128, 1),
                                       (1, 512, 128, 1), (15, 512, 256, 4),
                                       (16, 512, 128, 10), (17, 512, 256, 12),
                                       (48, 512, 128, 16), (2000, 512, 128, 12),
                                       (40, 12544, 1024, 12), (150, 512, 128, 20),
                                       (17, 512, 256, 32), (40, 12544, 1024, 32),
                                       (8000, 12544, 1024, 12)])   # a batch of 8
def test_encoder_fc6_kernel_matches_plain(dev, r, d, rep, t):
    g = torch.Generator(device=dev).manual_seed(r + t + d)
    x = (torch.rand((r, d), generator=g, device=dev) * 2.5).to(BF)
    w6 = ((torch.rand((d, rep), generator=g, device=dev) * 2 - 1) / d ** 0.5).to(BF)
    cur6, cnt = k3.encoder_fc6(x, w6, t)
    want, want_cnt = k3.encoder_fc6_plain(x, w6, t)
    assert cur6.shape == (t, r, rep)
    assert torch.equal(cnt, want_cnt) and int(cnt.sum()) > 0
    assert float((cur6 - want).abs().max()) <= 1e-3


# K3's training instance: ragged rows, two column tiles, one and two code
# planes (T = 20: steps 16-19 in the second), the flagship width; the value
# 2.5, where the carried encoder and the threshold count part, in every row.
@pytest.mark.parametrize("r,d,rep,t", [(150, 512, 128, 12), (17, 512, 256, 20), (7, 512, 128, 1),
                                       (40, 12544, 1024, 12), (40, 12544, 1024, 32)])
def test_encoder_fc6_train_kernel_matches_plain(dev, r, d, rep, t):
    g = torch.Generator(device=dev).manual_seed(r + t + d)
    x = (torch.rand((r, d), generator=g, device=dev) * 3).to(BF)
    x[:, 0] = 2.5
    w6 = ((torch.rand((d, rep), generator=g, device=dev) * 2 - 1) / d ** 0.5).to(BF)
    before = cb.LAUNCHES[k3.NAME]
    cur6, codes = k3.encoder_fc6_train(x, w6, t)
    want, want_codes = k3.encoder_fc6_train_plain(x, w6, t)
    assert cb.LAUNCHES[k3.NAME] == before + 1
    assert cur6.dtype == BF and cur6.shape == (t, r, rep)
    assert torch.equal(codes, want_codes)
    # Both sides round f32 sums of the same spikes once to bf16.
    assert kc.excess(cur6.float(), want.float()) <= 1


@pytest.mark.parametrize("t", [8, 12, 20, 32])
def test_encoder_train_codes_for_every_bf16_value(dev, t):
    """The training instance's code pass on all 32,640 finite non-negative
    bf16 values, laid out as 255 rows of 128: its plain version's codes."""
    x = torch.arange(0x7F80, dtype=torch.int32).to(torch.int16).view(BF).reshape(255, 128)
    x = x.to(dev)
    w6 = torch.full((128, 128), 2.0 ** -10, device=dev, dtype=BF)
    _, codes = k3.encoder_fc6_train(x, w6, t)
    assert torch.equal(codes, k3.encoder_codes_train_plain(x, t))


# The weight gradient of fc6 from the training instance's codes: the
# flagship width at 40 and 8192 RoIs (a batch of 16), one and two code
# planes; ragged: RoIs that end inside a 64-RoI stage, features that end
# inside a 128-feature tile (576), a column tile half past rep (384).
@pytest.mark.parametrize("r,d,rep,t", [(40, 12544, 1024, 8), (40, 12544, 1024, 12),
                                       (40, 12544, 1024, 20), (8192, 12544, 1024, 8),
                                       (8192, 12544, 1024, 12), (8192, 12544, 1024, 20),
                                       (33, 576, 384, 12), (100, 512, 128, 17)])
def test_encoder_fc6_wgrad_kernel_matches_plain(dev, r, d, rep, t):
    g = torch.Generator(device=dev).manual_seed(r + t + d)
    x = (torch.rand((r, d), generator=g, device=dev) * 3).to(BF)
    w6 = torch.zeros((d, rep), device=dev, dtype=BF)
    _, codes = k3.encoder_fc6_train(x, w6, t)
    dcur6 = (torch.randn((t, r, rep), generator=g, device=dev) * 1e-3).to(BF)
    before = cb.LAUNCHES[k3.WGRAD_NAME]
    dw = k3.encoder_fc6_wgrad(codes, dcur6, t)
    again = k3.encoder_fc6_wgrad(codes, dcur6, t)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k3.WGRAD_NAME] == before + 2
    want = k3.encoder_fc6_wgrad_plain(codes, dcur6, t)
    assert dw.shape == (d, rep) and float(want.abs().max()) > 0
    # f32 sums of the same exact products in another order.
    assert kc.grad_excess(dw, want, rel=1e-4) <= 1
    assert torch.equal(dw, again)


def test_encoder_fc6_train_backward_is_the_kernel(dev):
    """``EncoderFc6Train`` under autograd on the card: the training
    instance forward, the weight-gradient kernel's bits backward, no
    gradient for x, no plain version."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = (torch.rand((300, 12544), generator=g, device=dev) * 3).to(BF)
    w6 = (torch.randn((12544, 1024), generator=g, device=dev) * 0.01).requires_grad_()
    cot = torch.randn((12, 300, 1024), generator=g, device=dev).to(BF)
    cb.reset_counts()
    cur6 = k3.EncoderFc6Train.apply(x, w6, 12)
    (codes,) = cur6.grad_fn.saved_tensors     # freed by the backward
    cur6.backward(cot)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k3.NAME] == 1 and cb.LAUNCHES[k3.WGRAD_NAME] == 1
    assert all(v == 0 for v in cb.PLAIN_CUDA_CALLS.values())
    assert torch.equal(cur6, k3.encoder_fc6_train(x, w6.detach(), 12)[0])
    assert torch.equal(w6.grad, k3.encoder_fc6_wgrad(codes, cot, 12))
    assert x.grad is None


# The same row tiles and steps for K4, and a readout of 16 classes (80
# columns, two n64 column tiles). LIF7 cannot spike before step 2 (each
# layer takes its input one step late), so T = 1 has no fc7 spike; below 8
# steps the fc6 currents are larger so that both layers spike.
@pytest.mark.parametrize("r,t,n_cls", [(203, 12, 9), (8, 10, 9), (3, 8, 9), (1, 1, 9),
                                       (15, 4, 9), (16, 10, 9), (17, 12, 9), (48, 16, 9),
                                       (2000, 12, 9), (33, 12, 16), (203, 20, 9),
                                       (17, 32, 9), (2000, 32, 9), (33, 17, 16),
                                       (8000, 12, 9)])   # a batch of 8
def test_box_tail_kernel_matches_plain(dev, r, t, n_cls):
    g = torch.Generator(device=dev).manual_seed(r * t + n_cls)
    scale = 0.15 if t >= 8 else 2.0
    cur6 = (torch.randn((t, r, 1024), generator=g, device=dev) * scale).to(BF)
    w7 = (torch.rand((1024, 1024), generator=g, device=dev) * 2 - 1) / 32.0
    wc = (torch.rand((1024, n_cls), generator=g, device=dev) * 2 - 1) / 32.0
    wb = (torch.rand((1024, 4 * n_cls), generator=g, device=dev) * 2 - 1) / 32.0
    cls, box, c6, c7 = k4.box_tail(cur6, w7, wc, wb)
    p_cls, p_box, p6, p7 = k4.box_tail_plain(cur6, w7, wc, wb)
    assert cls.shape == (r, n_cls) and box.shape == (r, 4 * n_cls)
    assert torch.equal(c6, p6) and (int(p7.sum()) > 0 or t < 3)
    assert int((c7 - p7).abs().sum()) <= 1e-3 * int(p7.sum()) + 1
    assert kc.excess(cls, p_cls) <= 1
    assert kc.excess(box, p_box) <= 1


@pytest.mark.parametrize("n,shapes,cins", [
    (1, [(25, 50), (13, 25), (7, 13), (4, 7)], (256, 512, 1024, 2048)),   # odd pyramid
    (3, [(9, 17), (5, 9), (3, 5), (2, 3)], (256, 512, 1024, 2048)),       # ragged tiles
    (2, [(24, 48), (12, 24), (6, 12), (3, 6)], (256, 512, 1024, 2048)),   # exact pyramid
    (1, [(17, 33), (9, 17), (5, 9), (3, 5)], (32, 64, 96, 160)),   # Cin below the ring's depth
    (2, [(192, 384), (96, 192), (48, 96), (24, 48)], (256, 512, 1024, 2048)),   # flagship
    # the portrait bucket (C5 24 wide: a ragged 16-column tile), a batch of 8
    (2, [(384, 192), (192, 96), (96, 48), (48, 24)], (256, 512, 1024, 2048)),
    (8, [(192, 384), (96, 192), (48, 96), (24, 48)], (256, 512, 1024, 2048)),
])
def test_fpn_level_kernel_matches_plain(dev, n, shapes, cins):
    """Each level through the entry point (the tile the level's shape
    picks) and with both tiles, 8 x 16 and 4 x 16 pixels per block."""
    g = torch.Generator(device=dev).manual_seed(n + shapes[0][0])
    merged = None
    for i in (3, 2, 1, 0):
        h, w = shapes[i]
        c = torch.randn((n, h, w, cins[i]), generator=g, device=dev).to(BF)
        wlat = torch.randn((1, 1, cins[i], 256), generator=g, device=dev) / cins[i] ** 0.5
        blat = torch.randn(256, generator=g, device=dev) * 0.1
        wout = torch.randn((3, 3, 256, 256), generator=g, device=dev) / 48.0
        bout = torch.randn(256, generator=g, device=dev) * 0.1
        before = cb.LAUNCHES[k5.NAME]
        got_p, got_m = k5.fpn_level(c, merged, wlat, blat, wout, bout, store_merged=True)
        torch.cuda.synchronize()
        assert cb.LAUNCHES[k5.NAME] == before + 1
        want_m = k5.lateral_plain(c, merged, wlat, blat)
        addends = [blat.to(BF)]
        if merged is not None:
            up = merged.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, :h, :w]
            addends += [up, up]
        weights = k5.kernel_weights(wlat, blat, wout, bout)
        runs = [(got_p, got_m)] + [k5._launch(c, merged, *weights, True, rows) for rows in (8, 4)]
        for run_p, run_m in runs:
            assert run_m.shape == run_p.shape == (n, h, w, 256) and run_p.dtype == BF
            assert kc.chain_excess(run_m, want_m, 2 if merged is None else 3, addends) <= 1
            want_p = k5.outer_plain(run_m, wout, bout)
            assert kc.chain_excess(run_p, want_p, 2, (bout.to(BF),)) <= 1
            assert kc.differing(run_m, want_m) <= kc.MAX_DIFFERING * want_m.numel()
            assert kc.differing(run_p, want_p) <= kc.MAX_DIFFERING * want_p.numel()
        only_p, none = k5.fpn_level(c, merged, wlat, blat, wout, bout, store_merged=False)
        assert none is None and torch.equal(only_p, got_p)
        merged = want_m


@pytest.mark.parametrize("n,h,w", [(1, 68, 132), (3, 36, 76), (2, 64, 256), (1, 4, 4),
                                   (3, 100, 200), (2, 768, 1536), (2, 1536, 768),
                                   (8, 768, 1536)])
def test_stem_kernel_matches_plain(dev, n, h, w):
    """H and W multiples of 4 but not of 8 or 256; bucket-padding zeros;
    last tiles of 8 x 16 pooled pixels cut in both directions (68 x 132,
    100 x 200), three images, and the flagship bucket."""
    g = torch.Generator(device=dev).manual_seed(h + w)
    mean, std = (0.2869, 0.3251, 0.2839), (0.1870, 0.1902, 0.1872)
    images = torch.rand((n, h, w, 3), generator=g, device=dev)
    images[:, h * 3 // 4:] = 0.0
    stem = {"w": torch.randn((7, 7, 3, 64), generator=g, device=dev) * 0.025,
            "bn": {"scale": torch.rand(64, generator=g, device=dev) + 0.5,
                   "bias": torch.randn(64, generator=g, device=dev) * 0.2}}
    before = cb.LAUNCHES[k6.NAME]
    got = k6.stem_apply(stem, images, mean, std)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k6.NAME] == before + 1
    want = k6.stem_plain(stem, images, mean, std)
    _, bias = k6.fold_stem_weights(stem["w"], stem["bn"]["scale"], stem["bn"]["bias"],
                                   mean, std)
    assert got.shape == (n, h // 4, w // 4, 64) and got.dtype == BF
    assert float(want.float().max()) > 0
    assert kc.chain_excess(got, want, 2, (bias,)) <= 1
    assert kc.differing(got, want) <= kc.MAX_DIFFERING * want.numel()


@pytest.mark.parametrize("n,h,w", [(1, 68, 132), (2, 768, 1536)])
def test_stem_check_instance_matches_plain(dev, n, h, w):
    """K6's check instance, which loads each window only at its own tile:
    the same results as the plain version, which it gives only if every
    block waits for each window on its barrier."""
    g = torch.Generator(device=dev).manual_seed(h + w + 1)
    mean, std = (0.2869, 0.3251, 0.2839), (0.1870, 0.1902, 0.1872)
    images = torch.rand((n, h, w, 3), generator=g, device=dev)
    stem = {"w": torch.randn((7, 7, 3, 64), generator=g, device=dev) * 0.025,
            "bn": {"scale": torch.rand(64, generator=g, device=dev) + 0.5,
                   "bias": torch.randn(64, generator=g, device=dev) * 0.2}}
    wf, bias = k6.fold_stem_weights(stem["w"], stem["bn"]["scale"], stem["bn"]["bias"],
                                    mean, std)
    got = k6._launch(images, k6.kernel_weights(wf), bias.contiguous(), mean, late=True)
    want = k6._folded_plain(images, wf, bias, mean)
    assert float(want.float().max()) > 0
    assert kc.chain_excess(got, want, 2, (bias,)) <= 1
    assert kc.differing(got, want) <= kc.MAX_DIFFERING * want.numel()


def _hold_rpn_bwd(got, again, want, fwd_ssum, cot, own, replay=True):
    """K7's (dw, dw_out, the sweep's spike sums) against the replaying plain
    version's ``want`` (with ``replay``) and, tighter, against its plain
    version on K1's own saved tensors ``own``; ``again`` is a second run."""
    dw, dwo, ssum = got
    p_dw, p_dwo, p_ssum = want
    assert torch.equal(ssum, fwd_ssum)
    flips = int((fwd_ssum != p_ssum).sum())
    assert flips <= 1e-3 * int((p_ssum != 0).sum())
    if flips:   # dwout is linear in the spike sums: hold it to K1's own
        p_dwo = k1.dwout_plain(fwd_ssum, cot)
    if replay:
        assert kc.grad_excess(dw, p_dw) <= 1 and kc.grad_excess(dwo, p_dwo) <= 1
    assert kc.grad_excess(dw, own[0], rel=1e-4) <= 1
    assert kc.grad_excess(dwo, own[1], rel=1e-4) <= 1
    assert torch.equal(dw, again[0]) and torch.equal(dwo, again[1])


# Odd heights and widths, one image, T = 1 and T = 12 (16 steps per pixel
# in the weight gradient, four pixels a stage), T = 20 (32 steps, two
# pixels), a level smaller than a stage's 8 pixels, rows that end inside a
# stage, more stages than splits.
@pytest.mark.parametrize("n,h,w,t", [(1, 5, 7, 1), (1, 13, 37, 5), (2, 3, 45, 8),
                                     (1, 9, 70, 12), (2, 24, 48, 8), (1, 4, 11, 20)])
def test_rpn_head_bwd_kernel_matches_plain(dev, n, h, w, t):
    g = torch.Generator(device=dev).manual_seed(n * h * w + t)
    # Over [0, 3): every period 1 .. T + 1 occurs, so dc of every step
    # reaches dw9 (period 1, a spike at step 0, needs x > 2.5).
    feat = (torch.rand((n, h, w, 256), generator=g, device=dev) * 3).to(BF)
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.02
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.05
    cot = torch.randn((n, h, w, 15), generator=g, device=dev)
    before = cb.LAUNCHES[k1.NAME], cb.LAUNCHES[k1.BWD_NAME]
    dw, dwo, ssum = k1.rpn_level_bwd(feat, w_shared, w_out, cot, t, spike_sum=True)
    again = k1.rpn_level_bwd(feat, w_shared, w_out, cot, t)
    torch.cuda.synchronize()
    assert (cb.LAUNCHES[k1.NAME], cb.LAUNCHES[k1.BWD_NAME]) == (before[0] + 2, before[1] + 2)
    assert dw.shape == (3, 3, 256, 256) and dwo.shape == (256, 15)
    *_, fwd_ssum, saved = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True, save=True)
    own = k1.rpn_level_bwd_from_saved_plain(saved, w_out, cot, t)
    # K7 writes dc over the saved currents.
    k1.rpn_level_bwd_from_saved(saved, w_out, cot, t)
    assert not torch.equal(saved.cur, k1.rpn_level(feat, w_shared, w_out, t, save=True)[3].cur) \
        or t == 1
    want = k1.rpn_level_bwd_plain(feat, w_shared, w_out, cot, t, spike_sum=True)
    assert t == 1 or float(ssum.max()) > 0
    _hold_rpn_bwd((dw, dwo, ssum), again, want, fwd_ssum, cot, own)
    # With one step no LIF neuron has spiked yet: both gradients are zero.
    assert t == 1 or (float(want[1].abs().max()) > 0 and float(want[0].abs().max()) > 0)


def test_rpn_level_train_backward_is_the_kernel(dev):
    """``RpnLevelTrain`` under autograd: K1's values (its training instance)
    forward, K7's gradients backward (the three weights' gradients against
    the plain version, the fused readout's split into ``conv_cls`` and
    ``conv_bbox``), none for the features, no plain version on the card,
    and a second backward refused (K7 wrote over the saved currents)."""
    from snn_automotive_object_detection_tpu_torch.models import heads

    g = torch.Generator(device=dev).manual_seed(3)
    feats = [(torch.rand((2, h, w, 256), generator=g, device=dev) * 2).requires_grad_()
             for h, w in ((9, 33), (4, 17))]
    params = {"shared_conv": {"w": torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.02},
              "conv_cls": {"w": torch.randn((1, 1, 256, 3), generator=g, device=dev) * 0.05},
              "conv_bbox": {"w": torch.randn((1, 1, 256, 12), generator=g, device=dev) * 0.05}}
    for v in params.values():
        v["w"].requires_grad_()
    cots = [torch.randn((2, f.shape[1], f.shape[2], 15), generator=g, device=dev) for f in feats]
    cb.reset_counts()
    obj, box, _ = heads.rpn_head_snn_train_apply(params, feats, 8)
    loss = sum((torch.cat([o, b], -1) * c).sum() for o, b, c in zip(obj, box, cots))
    loss.backward(retain_graph=True)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k1.NAME] == 2 and cb.LAUNCHES[k1.BWD_NAME] == 2
    assert all(v == 0 for v in cb.PLAIN_CUDA_CALLS.values())
    assert all(f.grad is None for f in feats)
    with pytest.raises(RuntimeError):
        loss.backward()
    w_out, _ = heads._fused_readout(params)
    want_dw, want_dwo = 0.0, 0.0
    for f, o, b, c in zip(feats, obj, box, cots):
        plain = k1.rpn_level_plain(f.detach().to(BF), params["shared_conv"]["w"].detach(),
                                   w_out.detach(), 8)[0]
        assert kc.excess(torch.cat([o, b], -1).detach(), plain) <= 1
        dw, dwo = k1.rpn_level_bwd_plain(f.detach().to(BF), params["shared_conv"]["w"].detach(),
                                         w_out.detach(), c, 8)
        want_dw, want_dwo = want_dw + dw, want_dwo + dwo
    assert kc.grad_excess(params["shared_conv"]["w"].grad, want_dw) <= 1
    assert kc.grad_excess(params["conv_cls"]["w"].grad.reshape(256, 3), want_dwo[:, :3]) <= 1
    assert kc.grad_excess(params["conv_bbox"]["w"].grad.reshape(256, 12), want_dwo[:, 3:]) <= 1


# K7's bf16-state instance on what K1's bf16-state training instance saved:
# the shapes of the f32-state test above. Against its plain version on K1's
# own saved tensors everywhere; against the replaying plain version only on
# grid weights (2^-10 grid: conv sums exact in any order, so the currents
# and spikes are the replay's bits): elsewhere the replay's conv sums in
# another order, and a current one bf16 ulp apart moves the bf16 states of
# every later step by an ulp (with f32 states by 2^-16 of it), which moves
# the stored membranes and the surrogate's slope (1.49 of the bound at
# [1, 9, 70, 256], T = 12, on an H100).
@pytest.mark.parametrize("n,h,w,t,grid", [(1, 5, 7, 1, False), (1, 13, 37, 5, True),
                                          (2, 3, 45, 8, False), (2, 3, 45, 8, True),
                                          (1, 9, 70, 12, False), (1, 4, 11, 20, True)])
def test_rpn_head_bwd_s16_kernel_matches_plain(dev, n, h, w, t, grid):
    g = torch.Generator(device=dev).manual_seed(n * h * w + t + 16)
    feat = (torch.rand((n, h, w, 256), generator=g, device=dev) * 3).to(BF)
    if grid:
        w_shared = torch.randint(-10, 11, (3, 3, 256, 256), generator=g,
                                 device=dev).float() * 2.0 ** -10
    else:
        w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.02
    w_out = torch.randn((256, 15), generator=g, device=dev) * 0.05
    cot = torch.randn((n, h, w, 15), generator=g, device=dev)
    names = (k1.NAME, k1.BWD_NAME, k1.S16_SAVE_NAME, k1.BWD_S16_NAME)
    before = [cb.LAUNCHES[k] for k in names]
    dw, dwo, ssum = k1.rpn_level_bwd(feat, w_shared, w_out, cot, t, spike_sum=True,
                                     bf16_states=True)
    again = k1.rpn_level_bwd(feat, w_shared, w_out, cot, t, bf16_states=True)
    torch.cuda.synchronize()
    assert [cb.LAUNCHES[k] - b for k, b in zip(names, before)] == [0, 0, 2, 2]
    *_, fwd_ssum, saved = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True, save=True,
                                       bf16_states=True)
    own = k1.rpn_level_bwd_from_saved_plain(saved, w_out, cot, t, bf16_states=True)
    want = k1.rpn_level_bwd_plain(feat, w_shared, w_out, cot, t, spike_sum=True,
                                  bf16_states=True)
    if grid:
        assert torch.equal(fwd_ssum, want[2])
    assert t == 1 or float(ssum.max()) > 0
    _hold_rpn_bwd((dw, dwo, ssum), again, want, fwd_ssum, cot, own, replay=grid)
    assert t == 1 or (float(want[1].abs().max()) > 0 and float(want[0].abs().max()) > 0)
    # bf16 states are another backward than f32 states on the same inputs.
    assert t == 1 or not torch.equal(dw, k1.rpn_level_bwd(feat, w_shared, w_out, cot, t)[0])


def test_rpn_level_train_bf16_states_backward_is_the_kernel(dev):
    """``rpn_head_snn_train_apply(..., bf16_states=True)`` under autograd:
    K1's bf16-state training instance forward, K7's bf16-state instance
    backward, the three weights' gradients against the replaying plain
    version with bf16 states (the conv weights on the 2^-10 grid, so that
    the replay's currents are K1's bits), no plain version on the card."""
    from snn_automotive_object_detection_tpu_torch.models import heads

    g = torch.Generator(device=dev).manual_seed(16)
    feats = [(torch.rand((2, h, w, 256), generator=g, device=dev) * 3) for h, w in ((9, 33),
                                                                                   (4, 17))]
    w_grid = torch.randint(-10, 11, (3, 3, 256, 256), generator=g, device=dev).float()
    params = {"shared_conv": {"w": w_grid * 2.0 ** -10},
              "conv_cls": {"w": torch.randn((1, 1, 256, 3), generator=g, device=dev) * 0.05},
              "conv_bbox": {"w": torch.randn((1, 1, 256, 12), generator=g, device=dev) * 0.05}}
    for v in params.values():
        v["w"].requires_grad_()
    cots = [torch.randn((2, f.shape[1], f.shape[2], 15), generator=g, device=dev) for f in feats]
    cb.reset_counts()
    obj, box, _ = heads.rpn_head_snn_train_apply(params, feats, 8, bf16_states=True)
    loss = sum((torch.cat([o, b], -1) * c).sum() for o, b, c in zip(obj, box, cots))
    loss.backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in cb.LAUNCHES.items() if v} == {k1.S16_SAVE_NAME: 2,
                                                          k1.BWD_S16_NAME: 2}
    assert all(v == 0 for v in cb.PLAIN_CUDA_CALLS.values())
    w_out, _ = heads._fused_readout(params)
    want_dw, want_dwo = 0.0, 0.0
    for f, o, b, c in zip(feats, obj, box, cots):
        x = f.to(BF)
        plain = k1.rpn_level_plain(x, params["shared_conv"]["w"].detach(), w_out.detach(), 8,
                                   spike_sum=True, bf16_states=True)
        kernel = k1.rpn_level(x, params["shared_conv"]["w"].detach(), w_out.detach(), 8,
                              spike_sum=True, bf16_states=True)
        assert torch.equal(torch.cat([o, b], -1).detach(), kernel[0])
        _hold_rpn_eval(kernel, plain, w_out.detach())
        dw, dwo = k1.rpn_level_bwd_plain(x, params["shared_conv"]["w"].detach(), w_out.detach(),
                                         c, 8, bf16_states=True)
        want_dw, want_dwo = want_dw + dw, want_dwo + dwo
    assert kc.grad_excess(params["shared_conv"]["w"].grad, want_dw) <= 1
    assert kc.grad_excess(params["conv_cls"]["w"].grad.reshape(256, 3), want_dwo[:, :3]) <= 1
    assert kc.grad_excess(params["conv_bbox"]["w"].grad.reshape(256, 12), want_dwo[:, 3:]) <= 1


# 75 and 128 readout channels (15 and 25 anchors per location), on rows that
# end inside a 32-pixel tile.
@pytest.mark.parametrize("n_out", [75, 128])
def test_rpn_head_kernels_wide_readout(dev, n_out):
    g = torch.Generator(device=dev).manual_seed(n_out)
    n, h, w, t = 2, 5, 45, 8
    feat = (torch.rand((n, h, w, 256), generator=g, device=dev) * 2).to(BF)
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.02
    w_out = torch.randn((256, n_out), generator=g, device=dev) * 0.05
    cot = torch.randn((n, h, w, n_out), generator=g, device=dev)
    want = k1.rpn_level_plain(feat, w_shared, w_out, t, spike_sum=True)
    _hold_rpn_eval(k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True), want, w_out)
    # K1's training instance, whose saved tensors K7 starts from.
    trained = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True, save=True)
    assert trained[0].shape == (n, h, w, n_out)
    _hold_rpn_eval(trained[:4], want, w_out)
    own = k1.rpn_level_bwd_from_saved_plain(trained[4], w_out, cot, t)
    dw, dwo, r_ssum = k1.rpn_level_bwd(feat, w_shared, w_out, cot, t, spike_sum=True)
    again = k1.rpn_level_bwd(feat, w_shared, w_out, cot, t)
    want_bwd = k1.rpn_level_bwd_plain(feat, w_shared, w_out, cot, t, spike_sum=True)
    assert dwo.shape == (256, n_out)
    assert float(want_bwd[1].abs().max()) > 0 and float(want_bwd[0].abs().max()) > 0
    _hold_rpn_bwd((dw, dwo, r_ssum), again, want_bwd, trained[3], cot, own)


# Odd heights and widths, widths that end inside a 16-pixel tile, one and
# two pairs, T = 4 and T = 12, 15 and 75 readout channels.
@pytest.mark.parametrize("n,h,w,t,n_out", [(2, 3, 45, 8, 15), (4, 5, 17, 4, 15),
                                           (2, 1, 7, 12, 75), (4, 9, 33, 12, 15)])
def test_rpn_head_x2_kernel_matches_rpn_head_and_plain(dev, n, h, w, t, n_out):
    """K8 against its plain version, and its readout and spike sums equal
    to K1's bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n * h * w + t)
    feat = (torch.rand((n, h, w, 256), generator=g, device=dev) * 2).to(BF)
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.02
    w_out = torch.randn((256, n_out), generator=g, device=dev) * 0.05
    before = cb.LAUNCHES[k1.X2_NAME], cb.LAUNCHES[k1.NAME]
    out, ssum = k1.rpn_level_x2(feat, w_shared, w_out, t, spike_sum=True)
    torch.cuda.synchronize()
    assert (cb.LAUNCHES[k1.X2_NAME], cb.LAUNCHES[k1.NAME]) == (before[0] + 1, before[1])
    assert out.shape == (n, h, w, n_out)
    assert torch.equal(k1.rpn_level_x2(feat, w_shared, w_out, t), out)
    p_out, p_ssum = k1.rpn_level_x2_plain(feat, w_shared, w_out, t, spike_sum=True)
    spiked = int((p_ssum != 0).sum())
    flips = int((ssum != p_ssum).sum())
    assert spiked > 0 and flips <= 1e-3 * spiked
    one = k1.rpn_level(feat, w_shared, w_out, t, spike_sum=True)
    assert torch.equal(out, one[0]) and torch.equal(ssum, one[3])
    if flips:
        p_out = torch.matmul(ssum, w_out.to(BF).float()).to(BF).float()
    assert kc.bf16_valued(out) and kc.excess(out, p_out) <= 1


# The five flagship levels (2 x 768 x 1536), MobileNet's three (strides 32,
# 32, 64; 75 readout channels) and a level with two pairs.
@pytest.mark.parametrize("levels,n,n_out", [
    ([(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)], 2, 15),
    ([(24, 48), (24, 48), (12, 24)], 2, 75),
    ([(48, 96)], 4, 15),
    ([(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)], 8, 15),    # a batch of 8
    ([(384, 192), (24, 12)], 2, 15)])                                    # portrait P2, P6
def test_rpn_head_x2_equals_rpn_head_bit_for_bit(dev, levels, n, n_out):
    g = torch.Generator(device=dev).manual_seed(len(levels) + n + n_out)
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, n_out), generator=g, device=dev) * 0.01
    for h, w in levels:
        feat = (torch.rand((n, h, w, 256), generator=g, device=dev) * 2).to(BF)
        out, ssum = k1.rpn_level_x2(feat, w_shared, w_out, 8, spike_sum=True)
        one = k1.rpn_level(feat, w_shared, w_out, 8, spike_sum=True)
        assert int((one[3] != 0).sum()) > 0
        assert torch.equal(out, one[0]) and torch.equal(ssum, one[3])


# K8's bf16-state instance: K1's bf16-state instance's bits, on the flagship
# levels, a ragged level and two pairs.
@pytest.mark.parametrize("levels,n,n_out", [
    ([(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)], 2, 15),
    ([(3, 45), (5, 17)], 4, 75)])
def test_rpn_head_x2_s16_equals_rpn_head_s16_bit_for_bit(dev, levels, n, n_out):
    g = torch.Generator(device=dev).manual_seed(len(levels) + n + n_out + 16)
    w_shared = torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01
    w_out = torch.randn((256, n_out), generator=g, device=dev) * 0.01
    for h, w in levels:
        feat = (torch.rand((n, h, w, 256), generator=g, device=dev) * 2).to(BF)
        before = cb.LAUNCHES[k1.X2_S16_NAME], cb.LAUNCHES[k1.X2_NAME]
        out, ssum = k1.rpn_level_x2(feat, w_shared, w_out, 8, spike_sum=True, bf16_states=True)
        torch.cuda.synchronize()
        assert (cb.LAUNCHES[k1.X2_S16_NAME], cb.LAUNCHES[k1.X2_NAME]) == (before[0] + 1,
                                                                          before[1])
        one = k1.rpn_level(feat, w_shared, w_out, 8, spike_sum=True, bf16_states=True)
        assert int((one[3] != 0).sum()) > 0
        assert torch.equal(out, one[0]) and torch.equal(ssum, one[3])
        p_out, p_ssum = k1.rpn_level_x2_plain(feat, w_shared, w_out, 8, spike_sum=True,
                                              bf16_states=True)
        _hold_rpn_eval((out, one[1], None, ssum), (p_out, one[1], None, p_ssum), w_out)


def test_bf16_state_training_step_launches(dev):
    """One training step with bf16 states at 64 x 128 (frozen backbone): per
    step the stem once, K1's and K7's bf16-state instances once per level,
    no other kernel and no plain version; finite losses, nonzero RPN
    gradients."""
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
    from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
    from snn_automotive_object_detection_tpu_torch.train import optim
    from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step

    cfg = DetectorConfig(num_classes=4, t_rpn=8, t_det=4, min_size=64, max_size=128,
                         snn_state_dtype=None,
                         rpn=RPNConfig(pre_nms_top_n_train=64, post_nms_top_n_train=32,
                                       batch_size_per_image=64),
                         roi=RoIConfig(batch_size_per_image=16))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    for k in ("shared_conv", "conv_cls"):
        params["rpn_head"][k]["w"].mul_(6.0)
    trainable, frozen = optim.split_trainable(params)
    opt, sched = optim.build_optimizer(trainable, "SGD", 0.01, momentum=0.9)
    g = torch.Generator(device=dev).manual_seed(4)
    batch = {"images": torch.rand((2, 64, 128, 3), generator=g, device=dev),
             "image_sizes": torch.tensor([[64, 128]] * 2, device=dev),
             "original_sizes": torch.tensor([[64, 128]] * 2, device=dev),
             "targets": {"boxes": torch.tensor([[[10.0, 8.0, 50.0, 40.0], [60.0, 20.0, 110.0,
                                                                          60.0]]] * 2,
                                               device=dev),
                         "labels": torch.tensor([[1, 2]] * 2, device=dev),
                         "valid": torch.tensor([[True, True]] * 2, device=dev)}}
    cb.reset_counts()
    losses = make_train_step(cfg, opt, sched)(trainable, frozen, batch, g)
    torch.cuda.synchronize()
    assert {k: v for k, v in cb.LAUNCHES.items() if v} == {"stem": 1, k1.S16_SAVE_NAME: 5,
                                                          k1.BWD_S16_NAME: 5}
    assert all(v == 0 for v in cb.PLAIN_CUDA_CALLS.values())
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    for k in ("shared_conv", "conv_cls", "conv_bbox"):
        gr = trainable["rpn_head"][k]["w"].grad
        assert bool(torch.isfinite(gr).all()) and bool((gr != 0).any()), k


def test_training_step_launches(dev):
    """One frozen-backbone training step with float32 states at 64 x 128:
    per step the stem once, K1's training instance and K7 once per level,
    K3's training instance and the fc6 weight-gradient kernel once, no other
    kernel and no plain version; finite losses, nonzero box-head
    gradients."""
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
    from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
    from snn_automotive_object_detection_tpu_torch.train import optim
    from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step

    cfg = DetectorConfig(num_classes=4, t_rpn=8, t_det=12, min_size=64, max_size=128,
                         rpn=RPNConfig(pre_nms_top_n_train=64, post_nms_top_n_train=32,
                                       batch_size_per_image=64),
                         roi=RoIConfig(batch_size_per_image=16))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    trainable, frozen = optim.split_trainable(params)
    opt, sched = optim.build_optimizer(trainable, "SGD", 0.01, momentum=0.9)
    g = torch.Generator(device=dev).manual_seed(4)
    batch = {"images": torch.rand((2, 64, 128, 3), generator=g, device=dev),
             "image_sizes": torch.tensor([[64, 128]] * 2, device=dev),
             "original_sizes": torch.tensor([[64, 128]] * 2, device=dev),
             "targets": {"boxes": torch.tensor([[[10.0, 8.0, 50.0, 40.0], [60.0, 20.0, 110.0,
                                                                          60.0]]] * 2,
                                               device=dev),
                         "labels": torch.tensor([[1, 2]] * 2, device=dev),
                         "valid": torch.tensor([[True, True]] * 2, device=dev)}}
    cb.reset_counts()
    losses = make_train_step(cfg, opt, sched)(trainable, frozen, batch, g)
    torch.cuda.synchronize()
    assert {k: v for k, v in cb.LAUNCHES.items() if v} == {
        "stem": 1, k1.NAME: 5, k1.BWD_NAME: 5, k3.NAME: 1, k3.WGRAD_NAME: 1}
    assert all(v == 0 for v in cb.PLAIN_CUDA_CALLS.values())
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    for k in ("fc6", "fc7", "cls_score", "bbox_pred"):
        gr = trainable["box_head"][k]["w"].grad
        assert bool(torch.isfinite(gr).all()), k
    assert bool((trainable["box_head"]["fc6"]["w"].grad != 0).any())


@pytest.mark.parametrize("overrides,want", [(dict(trainable_backbone_layers=3), {"stem": 1}),
                                             (dict(train_backbone=True), {})])
def test_joint_training_step_launches(dev, overrides, want):
    """One training step with trainable backbone stages at 64 x 128: the
    stem kernel once while the stem is frozen (N = 3) and no launch at all
    with N = 5, no plain version; every trainable leaf (the top stages, the
    FPN, the heads) moved, every frozen leaf bit-equal without a
    gradient."""
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
    from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
    from snn_automotive_object_detection_tpu_torch.train import optim
    from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step
    from snn_automotive_object_detection_tpu_torch.utils.weights import flatten_tree

    cfg = DetectorConfig(num_classes=4, t_rpn=4, t_det=4, min_size=64, max_size=128,
                         rpn=RPNConfig(pre_nms_top_n_train=64, post_nms_top_n_train=32,
                                       batch_size_per_image=64),
                         roi=RoIConfig(batch_size_per_image=16), **overrides)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    trainable, frozen = optim.split_trainable(
        params, train_backbone=cfg.train_backbone,
        trainable_backbone_layers=cfg.trainable_backbone_layers)
    opt, sched = optim.build_optimizer(trainable, "AdamW", 1e-4)
    g = torch.Generator(device=dev).manual_seed(4)
    batch = {"images": torch.rand((2, 64, 128, 3), generator=g, device=dev),
             "image_sizes": torch.tensor([[64, 128]] * 2, device=dev),
             "original_sizes": torch.tensor([[64, 128]] * 2, device=dev),
             "targets": {"boxes": torch.tensor([[[10.0, 8.0, 50.0, 40.0], [60.0, 20.0, 110.0,
                                                                          60.0]]] * 2,
                                               device=dev),
                         "labels": torch.tensor([[1, 2]] * 2, device=dev),
                         "valid": torch.tensor([[True, True]] * 2, device=dev)}}
    t_leaves, f_leaves = flatten_tree(trainable), flatten_tree(frozen)
    t_before = {k: v.detach().clone() for k, v in t_leaves.items()}
    f_before = {k: v.detach().clone() for k, v in f_leaves.items()}
    cb.reset_counts()
    losses = make_train_step(cfg, opt, sched)(trainable, frozen, batch, g)
    torch.cuda.synchronize()
    assert {k: v for k, v in cb.LAUNCHES.items() if v} == want
    assert all(v == 0 for v in cb.PLAIN_CUDA_CALLS.values())
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert [k for k, v in t_leaves.items() if torch.equal(v.detach(), t_before[k])] == []
    assert all(torch.equal(v, f_before[k]) and v.grad is None for k, v in f_leaves.items())
    assert ("stem" in trainable["backbone"]) == bool(cfg.train_backbone)


def test_rpn_head_x2_refuses_an_odd_batch(dev):
    feat = torch.zeros((3, 2, 2, 256), device=dev, dtype=BF)
    with pytest.raises(ValueError):
        k1.rpn_level_x2(feat, torch.zeros((3, 3, 256, 256), device=dev),
                        torch.zeros((256, 15), device=dev), 4)


def _hold_box_head_fused(x, w6, w7, wc, wb, t):
    """``kernel_checks.box_head_fused_hold``: K9 spike by spike against its
    plain version, the same bits on a second launch, the entry point's
    outputs the launch's. Returns the report."""
    rep = kc.box_head_fused_hold(x, w6, w7, wc, wb, t)
    print(kc.box_head_fused_line(rep))
    assert rep["shapes_ok"] and rep["entry_ok"] and rep["same"]
    assert rep["ok"]
    return rep


# Rows that end inside the 16-row tile and inside a cluster of two tiles,
# one row, fewer rows than a tile, more tiles than the card holds blocks,
# the flagship's 2000 rows of K = 12544; T = 4, 12 and 16, 20 and 32 in
# two passes per GEMM, 40 and 48 in three and 70 in five (the last plane
# partly filled); 45 and 64 readout columns (9 classes with 36 deltas, 16
# with 48).
@pytest.mark.parametrize("r,d,t,n_cls,n_reg", [
    (203, 512, 12, 9, 36), (32, 1024, 12, 9, 36), (4500, 64, 4, 9, 36),
    (1, 640, 4, 9, 36), (15, 1024, 12, 16, 48), (17, 64, 16, 9, 36),
    (2000, 12544, 12, 9, 36), (2000, 12544, 16, 16, 48), (203, 512, 20, 9, 36),
    (17, 64, 32, 16, 48), (2000, 12544, 32, 9, 36), (203, 512, 40, 9, 36),
    (2000, 12544, 48, 9, 36), (17, 64, 70, 16, 48)])
def test_box_head_fused_kernel_matches_plain(dev, r, d, t, n_cls, n_reg):
    g = torch.Generator(device=dev).manual_seed(r + d + t)
    x = torch.rand((r, d), generator=g, device=dev) * 2.5
    w6 = (torch.rand((d, 1024), generator=g, device=dev) * 2 - 1) * (5.0 / d ** 0.5)
    w7 = (torch.rand((1024, 1024), generator=g, device=dev) * 2 - 1) / 32.0
    wc = (torch.rand((1024, n_cls), generator=g, device=dev) * 2 - 1) / 32.0
    wb = (torch.rand((1024, n_reg), generator=g, device=dev) * 2 - 1) / 32.0
    before = cb.LAUNCHES[k9.NAME]
    got = k9.fastrcnn_snn_cuda(x, w6, w7, wc, wb, t)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k9.NAME] == before + 1
    want = k9.fastrcnn_snn_plain(x, w6, w7, wc, wb, t)
    for a, b, shp in zip(got, want, ((r, n_cls), (r, n_reg), (r,), (r,))):
        assert a.shape == b.shape == shp and a.dtype == torch.float32
    _hold_box_head_fused(x, w6, w7, wc, wb, t)
    assert float(want[0].abs().max()) > 0


def test_box_head_fused_replayed_failure_input(dev):
    """The input on which the old count-based check of K9 failed (one fc6
    spike of a row a step late, equal counts), drawn again from the pinned
    generator state (``kernel_checks.k9_failure_input``) and recognised by
    its plain fc6 spike count. The spike-by-spike check holds there."""
    x, w6, w7, wc, wb = kc.k9_failure_input(dev)
    rep = _hold_box_head_fused(x, w6, w7, wc, wb, 12)
    assert rep["n6"] == kc.K9_FAILURE_FC6_SPIKES and rep["rows"] == 2000


def test_launch_rules_are_the_c_sides(dev):
    """``cuda_rpn.level_grid`` and ``cuda_kernels.smem_bytes`` state what
    the C side launches: K1's and K8's grid and cluster on levels of odd
    and even rows and batches, K9's shared memory per block."""
    for shape in ((2, 5, 45, 256), (4, 12, 16, 256), (2, 192, 384, 256), (2, 1, 7, 256)):
        for pair in (False, True):
            assert k1.launch_dims_on_card(shape, pair) == k1.level_grid(shape, pair)
    assert k9.smem_on_card() == (k9.smem_bytes(128, 8, staging_in_ring=True),
                                 k9.smem_bytes(64, 8, staging_in_ring=True))


def test_box_head_fused_refuses_k_not_a_multiple_of_64(dev):
    with pytest.raises(ValueError):
        k9.fastrcnn_snn_cuda(torch.zeros((4, 96), device=dev), torch.zeros((96, 1024), device=dev),
                             torch.zeros((1024, 1024), device=dev),
                             torch.zeros((1024, 9), device=dev),
                             torch.zeros((1024, 36), device=dev), 4)


def test_kernels_refuse_other_dtypes(dev):
    feat = torch.zeros((1, 2, 2, 256), device=dev)
    with pytest.raises(TypeError):
        k1.rpn_level(feat, torch.zeros((3, 3, 256, 256), device=dev),
                     torch.zeros((256, 15), device=dev), 4)
    with pytest.raises(TypeError):
        k1.rpn_level_bwd(feat, torch.zeros((3, 3, 256, 256), device=dev),
                         torch.zeros((256, 15), device=dev),
                         torch.zeros((1, 2, 2, 15), device=dev), 4)
    with pytest.raises(TypeError):
        k1.rpn_level_x2(torch.zeros((2, 2, 2, 256), device=dev),
                        torch.zeros((3, 3, 256, 256), device=dev),
                        torch.zeros((256, 15), device=dev), 4)
    with pytest.raises(TypeError):
        k3.encoder_fc6(torch.zeros((4, 64), device=dev), torch.zeros((64, 64), device=dev), 4)
    # K3 and K4 take whole weight stages (64 deep, 128 wide) and T <= 32.
    for d, rep, t in ((96, 128, 4), (64, 64, 4), (64, 128, 33)):
        with pytest.raises(ValueError):
            k3.encoder_fc6(torch.zeros((4, d), device=dev, dtype=BF),
                           torch.zeros((d, rep), device=dev, dtype=BF), t)
    for rep, t in ((192, 4), (1024, 33)):
        with pytest.raises(ValueError):
            k4.box_tail(torch.zeros((t, 2, rep), device=dev, dtype=BF),
                        torch.zeros((rep, rep), device=dev), torch.zeros((rep, 9), device=dev),
                        torch.zeros((rep, 36), device=dev))
    with pytest.raises(ValueError):   # K9 takes T <= 254: period 255 means "never"
        k9.fastrcnn_snn_cuda(torch.zeros((4, 64), device=dev), torch.zeros((64, 1024), device=dev),
                             torch.zeros((1024, 1024), device=dev),
                             torch.zeros((1024, 9), device=dev),
                             torch.zeros((1024, 36), device=dev), 255)
    with pytest.raises(TypeError):
        k9.fastrcnn_snn_cuda(torch.zeros((4, 64), device=dev, dtype=torch.int32),
                             torch.zeros((64, 1024), device=dev),
                             torch.zeros((1024, 1024), device=dev),
                             torch.zeros((1024, 9), device=dev),
                             torch.zeros((1024, 36), device=dev), 4)
    with pytest.raises(TypeError):
        k5.fpn_level(torch.zeros((1, 4, 4, 256), device=dev), None,
                     torch.zeros((1, 1, 256, 256), device=dev), torch.zeros(256, device=dev),
                     torch.zeros((3, 3, 256, 256), device=dev), torch.zeros(256, device=dev),
                     store_merged=False)
    with pytest.raises(TypeError):
        k6.stem_apply({"w": torch.zeros((7, 7, 3, 64), device=dev),
                       "bn": {"scale": torch.ones(64, device=dev),
                              "bias": torch.zeros(64, device=dev)}},
                      torch.zeros((1, 8, 8, 3), device=dev, dtype=torch.float64),
                      (0.5, 0.5, 0.5), (0.2, 0.2, 0.2))


@pytest.mark.parametrize("t_det,box_kernels", [(20, 1), (32, 1), (40, 0)])
def test_bf16_eval_long_t_det_routes(dev, t_det, box_kernels):
    """bf16 evaluation at box-head steps past one code plane runs K3 and K4
    (two GEMM passes each) up to 32 steps, and the box head's scan above,
    as the reference's gate sends such a t_det to its XLA scan; the RPN
    head's kernel runs either way."""
    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig

    cfg = DetectorConfig(num_classes=3, t_rpn=3, t_det=t_det, min_size=64, max_size=128,
                         rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=20))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = {"images": torch.rand((2, 64, 128, 3), generator=torch.Generator(device=dev)
                                  .manual_seed(1), device=dev),
             "image_sizes": torch.tensor([[64, 128]] * 2, device=dev),
             "original_sizes": torch.tensor([[128, 256]] * 2, device=dev)}
    cb.reset_counts()
    out, _ = detector_apply(params, batch, cfg, collect_rates=True)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[k3.NAME] == cb.LAUNCHES[k4.NAME] == box_kernels, cb.LAUNCHES
    assert cb.LAUNCHES[k1.NAME] == 5
    assert all(v == 0 for v in cb.PLAIN_CUDA_CALLS.values()), cb.PLAIN_CUDA_CALLS
    assert bool(torch.isfinite(out["all_scores"]).all())
    assert out["det_rates"]["fc6"].shape == (2 * cfg.rpn.post_nms_top_n_test,)


def test_float32_eval_launches_no_kernel(dev):
    """float32 evaluation on the card takes the reference's scans and the
    gather RoIAlign: no kernel launches, no plain version of a kernel runs,
    and the outputs are finite and well formed."""
    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig

    cfg = DetectorConfig(num_classes=3, t_rpn=3, t_det=3, min_size=64, max_size=128,
                         rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=20),
                         compute_dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n = 2
    batch = {"images": torch.rand((n, 64, 128, 3), generator=torch.Generator(device=dev)
                                  .manual_seed(1), device=dev),
             "image_sizes": torch.tensor([[64, 128]] * n, device=dev),
             "original_sizes": torch.tensor([[128, 256]] * n, device=dev)}
    cb.reset_counts()
    out, losses = detector_apply(params, batch, cfg, collect_rates=True)
    torch.cuda.synchronize()
    assert all(v == 0 for v in cb.LAUNCHES.values()), cb.LAUNCHES
    assert all(v == 0 for v in cb.PLAIN_CUDA_CALLS.values()), cb.PLAIN_CUDA_CALLS
    assert losses == {}
    p = cfg.rpn.post_nms_top_n_test
    assert out["boxes"].shape[0] == n and out["boxes"].shape[1] > p
    assert out["all_scores"].shape == (n, p, 3) and out["all_boxes"].shape == (n, p, 3, 4)
    for k in ("boxes", "scores", "proposals", "objectness", "all_scores", "all_boxes"):
        assert out[k].dtype == torch.float32 and bool(torch.isfinite(out[k]).all()), k
    assert out["rpn_rates"]["shared"].shape == (5, n)
    assert bool((out["scores"] >= 0).all() and (out["scores"] <= 1).all())


@pytest.mark.parametrize("rpn_snn,det_snn,states", [(False, True, torch.float32),
                                                    (True, False, torch.float32),
                                                    (False, False, torch.float32),
                                                    (True, True, None)])
def test_eval_routes_launch_counts(dev, rpn_snn, det_snn, states):
    """bf16 evaluation on the factory's other heads and states: an ANN RPN
    head launches no K1, an ANN box head no K3 or K4 (K2 pools for either
    box head), bf16 states take K1's bf16-state instance on every level, K3
    and the box tail's scan; no plain version of a kernel runs."""
    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply
    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig, init_params)
    from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig

    cfg = DetectorConfig(num_classes=3, t_rpn=3, t_det=3, min_size=64, max_size=128,
                         rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=20),
                         rpn_snn=rpn_snn, detector_snn=det_snn, snn_state_dtype=states)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = {"images": torch.rand((2, 64, 128, 3), generator=torch.Generator(device=dev)
                                  .manual_seed(1), device=dev),
             "image_sizes": torch.tensor([[64, 128]] * 2, device=dev),
             "original_sizes": torch.tensor([[128, 256]] * 2, device=dev)}
    cb.reset_counts()
    out, _ = detector_apply(params, batch, cfg, collect_rates=True)
    torch.cuda.synchronize()
    want = {k: 0 for k in cb.KERNELS}
    want.update(stem=1, fpn_level=4, roi_align=1)
    if rpn_snn:
        want[k1.NAME if states else k1.S16_NAME] = 5
    if det_snn:
        want[k3.NAME] = 1
        want[k4.NAME] = 1 if states else 0
    assert dict(cb.LAUNCHES) == want
    assert all(v == 0 for v in cb.PLAIN_CUDA_CALLS.values()), cb.PLAIN_CUDA_CALLS
    assert bool(torch.isfinite(out["boxes"]).all() and torch.isfinite(out["objectness"]).all())
    assert ("all_boxes" in out) == det_snn
