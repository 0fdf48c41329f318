"""A plain float32 forward pass of the hybrid detector, stage by stage.

Semantics (the released operating point, arXiv 2312.07466, on torchvision
0.13's ``fasterrcnn_resnet50_fpn`` and ``fasterrcnn_mobilenet_v3_large_fpn``):

  * backbone: ResNet-50 (frozen BatchNorm, stride on the 3x3 conv) or
    MobileNetV3-Large, and an FPN with a max-pool level, on images
    normalised by the configuration's mean and std;
  * anchors: torchvision's ``AnchorGenerator`` grids in (y, x, anchor) order;
  * RPN head: per level and each of ``t_rpn`` steps, a constant-current LIF
    encoder, a 3x3 conv, a LIF layer, the fused 1x1 objectness and
    box-delta readout and a leaky integrator; the last LI membranes are the
    logits (norse 0.0.7 Euler steps, dt 1e-3);
  * proposals: per-level top ``pre_nms_top_n`` by objectness (ties lowest
    index first), decoding, clipping, small-box and score masks, per-level
    blocked-bitmask NMS at 0.7 (the reference's in-block fixpoint), the top
    ``post_nms_top_n``;
  * RoIAlign 7x7 (aligned=False, 2 x 2 samples) over the levels but the
    pool, by torchvision's level mapper;
  * box head: ``t_det`` steps of encoder, fc6, LIF, fc7, LIF and the class
    and box LI readouts;
  * the open-set postprocess: softmax, decoding with weights (10, 10, 5, 5),
    clipping, foreground classes thresholded and NMS'd per class, the
    background boxes that no foreground prediction claimed NMS'd and kept.

Every product is float32 with TF32 off (:func:`float32_matmuls`), and
so is every value and neuron state (:data:`FLOAT32`). :data:`CONTROL`
computes the same in the precision below the configurations' (bf16
compute, float32 states): values rounded to fp8 where a program stores its
compute dtype, and bf16 neuron states. It is the benchmark's control,
which must come out not correct.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
NEG_INF = torch.finfo(torch.float32).min
FP8_MAX = 448.0
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)

# MobileNetV3-Large: (kernel, expanded, out, use_se, use_hs, stride).
V3_LARGE = [
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]
MNV3_C4 = 12                  # torchvision returns features[13] = block 12
RESNET_BLOCKS = (3, 4, 6, 3)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Where values are rounded. ``compute``: None keeps every value
    float32; "fp8" rounds each value that a program would store in its
    compute dtype (the operands and outputs of every conv and linear, each
    elementwise result of the backbone, the RoI features) to float8 e4m3
    with a per-tensor scale (amax to 448). ``states``: the neuron states'
    dtype. ``cast``: a dtype the spiking heads take their weights and the
    RoI features in (rounded to it, then computed in float32), as a
    configuration of that compute dtype stores them; None keeps them."""
    compute: Optional[str] = None
    states: torch.dtype = torch.float32
    cast: Optional[torch.dtype] = None

    def cast_(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.cast is None else x.to(self.cast).float()

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute is None:
            return x
        amax = x.detach().abs().amax().float()
        scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
        return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


FLOAT32 = Precision()
CONTROL = Precision(compute="fp8", states=torch.bfloat16)


@contextlib.contextmanager
def float32_matmuls():
    """cuBLAS and cuDNN in full float32 (TF32 off) inside the block."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


# --------------------------------------------------------------------------
# Weights: the torchvision-layout state dict as it is, NCHW throughout.


def _bn_affine(sd, prefix):
    scale = sd[f"{prefix}.weight"].float() / torch.sqrt(sd[f"{prefix}.running_var"].float() + BN_EPS)
    bias = sd[f"{prefix}.bias"].float() - sd[f"{prefix}.running_mean"].float() * scale
    return scale.view(1, -1, 1, 1), bias.view(1, -1, 1, 1)


def conv(x, w, prec: Precision, stride=1, padding=None, groups=1, bias=None):
    """A conv whose operands and output are rounded to the compute
    precision, and its bias added and rounded after."""
    if padding is None:
        padding = (w.shape[2] // 2, w.shape[3] // 2)
    r = prec.round
    y = r(F.conv2d(r(x), r(w.float()), stride=stride, padding=padding, groups=groups))
    return y if bias is None else r(y + r(bias.float()).view(1, -1, 1, 1))


def _conv_bn(x, sd, wkey, bnkey, prec, stride=1, groups=1, padding=None):
    scale, bias = _bn_affine(sd, bnkey)
    r = prec.round
    return r(r(conv(x, sd[wkey], prec, stride, padding, groups) * r(scale)) + r(bias))


# --------------------------------------------------------------------------
# Backbones and FPN. Maps are NCHW float32.


def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """images [N, H, W, 3] in [0, 1] -> normalised NCHW."""
    m = torch.tensor(mean, dtype=torch.float32, device=images.device).view(1, 3, 1, 1)
    s = torch.tensor(std, dtype=torch.float32, device=images.device).view(1, 3, 1, 1)
    return (images.float().permute(0, 3, 1, 2) - m) / s


def resnet50_body(sd, x, prec) -> List[torch.Tensor]:
    b = "backbone.body."
    y = torch.relu(_conv_bn(x, sd, f"{b}conv1.weight", f"{b}bn1", prec, stride=2, padding=(3, 3)))
    y = F.max_pool2d(y, 3, 2, padding=1)
    cs = []
    for stage, n_blocks in enumerate(RESNET_BLOCKS, start=1):
        for blk in range(n_blocks):
            p = f"{b}layer{stage}.{blk}."
            s = 2 if (blk == 0 and stage > 1) else 1
            out = torch.relu(_conv_bn(y, sd, f"{p}conv1.weight", f"{p}bn1", prec))
            out = torch.relu(_conv_bn(out, sd, f"{p}conv2.weight", f"{p}bn2", prec, stride=s))
            out = _conv_bn(out, sd, f"{p}conv3.weight", f"{p}bn3", prec)
            if f"{p}downsample.0.weight" in sd:
                y = _conv_bn(y, sd, f"{p}downsample.0.weight", f"{p}downsample.1", prec, stride=s)
            y = torch.relu(prec.round(out + y))
        cs.append(y)
    return cs


def _hardswish(x, r):
    return r(r(x * torch.clamp(r(x + 3.0), 0.0, 6.0)) / 6.0)


def _hardsigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def mobilenet_body(sd, x, prec) -> List[torch.Tensor]:
    b = "backbone.body."
    r = prec.round

    def hswish(t):
        return _hardswish(t, r)

    y = hswish(_conv_bn(x, sd, f"{b}0.0.weight", f"{b}0.1", prec, stride=2))
    cin, c4 = 16, None
    for i, (k, exp, out, se, hs, stride) in enumerate(V3_LARGE):
        act = hswish if hs else torch.relu
        p = f"{b}{i + 1}.block."
        j, h = 0, y
        if exp != cin:
            h = act(_conv_bn(h, sd, f"{p}{j}.0.weight", f"{p}{j}.1", prec))
            j += 1
        h = act(_conv_bn(h, sd, f"{p}{j}.0.weight", f"{p}{j}.1", prec, stride=stride,
                         groups=exp))
        j += 1
        if se:
            # The float32 biases add before the gates round.
            s = r(h.mean(dim=(2, 3), keepdim=True))
            s = r(torch.relu(conv(s, sd[f"{p}{j}.fc1.weight"], prec)
                             + sd[f"{p}{j}.fc1.bias"].float().view(1, -1, 1, 1)))
            s = r(_hardsigmoid(conv(s, sd[f"{p}{j}.fc2.weight"], prec)
                               + sd[f"{p}{j}.fc2.bias"].float().view(1, -1, 1, 1)))
            h = r(h * s)
            j += 1
        h = _conv_bn(h, sd, f"{p}{j}.0.weight", f"{p}{j}.1", prec)
        y = r(h + y) if (stride == 1 and cin == out) else h
        cin = out
        if i == MNV3_C4:
            c4 = y
    c5 = hswish(_conv_bn(y, sd, f"{b}16.0.weight", f"{b}16.1", prec))
    return [c4, c5]


def fpn(sd, cs: List[torch.Tensor], prec) -> List[torch.Tensor]:
    """torchvision's FeaturePyramidNetwork with LastLevelMaxPool: lateral
    1x1 convs, top-down nearest upsample and add, 3x3 output convs, and the
    pool level (kernel 1, stride 2)."""
    f = "backbone.fpn."

    def lateral(i, t):
        return conv(t, sd[f"{f}inner_blocks.{i}.0.weight"], prec,
                    bias=sd[f"{f}inner_blocks.{i}.0.bias"])

    def output(i, t):
        return conv(t, sd[f"{f}layer_blocks.{i}.0.weight"], prec,
                    bias=sd[f"{f}layer_blocks.{i}.0.bias"])

    last = lateral(len(cs) - 1, cs[-1])
    outs = [output(len(cs) - 1, last)]
    for i in range(len(cs) - 2, -1, -1):
        lat = lateral(i, cs[i])
        up = F.interpolate(last, size=lat.shape[-2:], mode="nearest")
        last = prec.round(lat + up)
        outs.insert(0, output(i, last))
    outs.append(outs[-1][:, :, ::2, ::2])
    return outs


def backbone_features(sd, cfg, images, prec=FLOAT32) -> List[torch.Tensor]:
    """The FPN levels, NCHW float32, of images [N, H, W, 3] in [0, 1]."""
    x = prec.round(normalize(images, cfg["image_mean"], cfg["image_std"]))
    if cfg["backbone"] == "resnet50_fpn":
        return fpn(sd, resnet50_body(sd, x, prec), prec)
    return fpn(sd, mobilenet_body(sd, x, prec), prec)


# --------------------------------------------------------------------------
# Anchors and boxes.


def anchors_per_level(cfg, shapes, image_hw, device) -> List[torch.Tensor]:
    """[H * W * A, 4] per level, (y, x, anchor) order, torchvision 0.13's
    rounded zero-centred cell anchors shifted by the level's stride."""
    out = []
    for (fh, fw), sizes in zip(shapes, cfg["anchor_sizes"]):
        s = np.asarray(sizes, np.float32)
        r = np.asarray(cfg["aspect_ratios"], np.float32)
        hr = np.sqrt(r)
        ws = ((1.0 / hr)[:, None] * s[None]).reshape(-1)
        hs = (hr[:, None] * s[None]).reshape(-1)
        cell = (np.stack([-ws, -hs, ws, hs], axis=1) / 2.0).round()
        sx = np.arange(fw, dtype=np.float32) * (image_hw[1] // fw)
        sy = np.arange(fh, dtype=np.float32) * (image_hw[0] // fh)
        yy, xx = np.meshgrid(sy, sx, indexing="ij")
        shifts = np.stack([xx.ravel(), yy.ravel(), xx.ravel(), yy.ravel()], axis=1)
        a = (shifts[:, None, :] + cell[None]).reshape(-1, 4).astype(np.float32)
        out.append(torch.as_tensor(a, device=device))
    return out


def box_area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(b1, b2):
    a1, a2 = box_area(b1), box_area(b2)
    iw = torch.clamp(torch.minimum(b1[..., :, None, 2], b2[..., None, :, 2])
                     - torch.maximum(b1[..., :, None, 0], b2[..., None, :, 0]), min=0.0)
    ih = torch.clamp(torch.minimum(b1[..., :, None, 3], b2[..., None, :, 3])
                     - torch.maximum(b1[..., :, None, 1], b2[..., None, :, 1]), min=0.0)
    inter = iw * ih
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def decode(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """torchvision ``BoxCoder.decode_single``: deltas [..., K*4] on boxes
    [..., 4]."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    dx, dy = d[..., 0] / wx, d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(d[..., 3] / wh, max=BBOX_XFORM_CLIP)
    pcx = dx * w[..., None] + cx[..., None]
    pcy = dy * h[..., None] + cy[..., None]
    pw = torch.exp(dw) * w[..., None]
    ph = torch.exp(dh) * h[..., None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
    return out.reshape(deltas.shape)


def clip(boxes, h, w):
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    return torch.stack([torch.minimum(torch.maximum(boxes[..., 0], zero), w),
                        torch.minimum(torch.maximum(boxes[..., 1], zero), h),
                        torch.minimum(torch.maximum(boxes[..., 2], zero), w),
                        torch.minimum(torch.maximum(boxes[..., 3], zero), h)], dim=-1)


def big_enough(boxes, min_size):
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) & ((boxes[..., 3] - boxes[..., 1]) >= min_size)


# --------------------------------------------------------------------------
# NMS: the reference's blocked bitmask with its in-block fixpoint.

NMS_BLOCK = 256


def sort_desc(x):
    return torch.sort(x, dim=-1, descending=True, stable=True)


def nms_keep(boxes, scores, valid, thresh, presorted=False):
    """keep [B, N] and the score order [B, N] of a masked NMS over rows."""
    bsz, n = scores.shape
    dev = scores.device
    b = min(NMS_BLOCK, n)
    n_pad = -(-n // b) * b
    if presorted:
        order = torch.arange(n, device=dev).expand(bsz, n)
        ob, ov = boxes, valid
    else:
        order = torch.sort(-torch.where(valid, scores, torch.full_like(scores, NEG_INF)),
                           dim=-1, stable=True).indices
        ob = torch.gather(boxes, 1, order[..., None].expand(bsz, n, 4))
        ov = torch.gather(valid, 1, order)
    sb = torch.zeros((bsz, n_pad, 4), dtype=boxes.dtype, device=dev)
    sb[:, :n] = ob
    sa = torch.zeros((bsz, n_pad), dtype=torch.bool, device=dev)
    sa[:, :n] = ov
    kept = torch.zeros((bsz, n_pad), dtype=torch.bool, device=dev)
    tri = torch.ones((b, b), dtype=torch.bool, device=dev).triu(1)
    for start in range(0, n_pad, b):
        blk = sb[:, start:start + b]
        active = sa[:, start:start + b]
        if start > 0:
            hit = (box_iou(blk, sb[:, :start]) > thresh) & kept[:, None, :start]
            active = active & ~hit.any(dim=-1)
        sup = tri & active[:, :, None] & active[:, None, :] & (box_iou(blk, blk) > thresh)
        alive = ~sup.any(dim=1)
        kept[:, start:start + b] = active & ~(sup & alive[:, :, None]).any(dim=1)
    if presorted:
        return kept[:, :n], order
    keep = torch.zeros((bsz, n), dtype=torch.bool, device=dev)
    keep.scatter_(1, order, kept[:, :n])
    return keep, order


def topk_kept(scores, keep, k):
    vals, idx = sort_desc(torch.where(keep, scores, torch.full_like(scores, NEG_INF)))
    return idx[:, :k], vals[:, :k] > NEG_INF


# --------------------------------------------------------------------------
# Neuron dynamics (norse 0.0.7, Euler, dt 1e-3; LIF tau_mem_inv 100,
# tau_syn_inv 200). A Python constant takes the state's dtype first, as a
# weakly typed scalar does in the reference.

DT = 1e-3
TAU_MEM, TAU_SYN = 100.0, 200.0
ENC_VTH, LIF_VTH = 0.25, 0.1


def _c(x: float, like: torch.Tensor) -> float:
    return float(torch.tensor(x, dtype=like.dtype))


def encoder_step(x, v):
    v = v + _c(DT * TAU_MEM, v) * ((0.0 - v) + x)
    z = (v - _c(ENC_VTH, v) > 0).to(v.dtype)
    return z, v - z * v


def lif_step(cur, v, i):
    v_dec = v + _c(DT * TAU_MEM, v) * ((0.0 - v) + i)
    i_dec = i + _c(-DT * TAU_SYN, i) * i
    z = (v_dec - _c(LIF_VTH, v) > 0).to(v.dtype)
    return z, (1.0 - z) * v_dec, i_dec + cur


def li_step(cur, v, i):
    i_jump = i + cur
    v_new = v + _c(DT * TAU_MEM, v) * ((0.0 - v) + i_jump)
    return v_new, i_jump + _c(-DT * TAU_SYN, i_jump) * i_jump


def encoder_thresholds(t_steps: int) -> torch.Tensor:
    """1 - a^m for m = 1..T (a = 1 - dt * tau_mem_inv), a float64 power
    rounded once to float32: the constant-current encoder's membrane after
    m steps from rest, per unit of input."""
    a = float(np.float32(1.0 - DT * TAU_MEM))
    return torch.tensor([1.0 - a ** m for m in range(1, t_steps + 1)], dtype=torch.float32)


def encoder_periods(x: torch.Tensor, t_steps: int) -> torch.Tensor:
    """The encoder's spike period of each input, exactly: 1 + the number of
    steps m <= T at which x * (1 - a^m) stays at or below the threshold (T + 1:
    no spike within T steps). The encoder fires at step t (0-based) where
    (t + 1) is a multiple of the period."""
    thr = encoder_thresholds(t_steps).to(x.device)
    p = torch.ones(x.shape, dtype=torch.int32, device=x.device)
    for m in range(t_steps):
        p += (x.float() * thr[m] <= ENC_VTH).to(torch.int32)
    return p


def li_coefficients(t_steps: int) -> torch.Tensor:
    """a_u with v_T = sum_u a_u cur_u: the LI readout unrolled over T steps
    (float64 sums rounded to float32)."""
    tm, ts = DT * TAU_MEM, DT * TAU_SYN
    return torch.tensor([tm * sum((1.0 - tm) ** (t_steps - k) * (1.0 - ts) ** (k - u)
                                  for k in range(u, t_steps + 1))
                         for u in range(1, t_steps + 1)], dtype=torch.float32)


def rpn_head(sd, feats: List[torch.Tensor], t_steps: int, prec=FLOAT32):
    """The spiking RPN head on NCHW levels. Returns (objectness [N, H, W, A],
    deltas [N, H, W, 4A]) per level, float32, and the encoder's spike count
    of each level [L] (float64, over images, steps and channels).

    With ``prec.cast`` the head keeps what the configuration stores in that
    dtype as it does: the weights and each step's conv currents rounded to
    it, the encoder's spikes from its exact periods, and the readout, linear
    in the spikes, as the LI-weighted spike sums times the readout weights,
    rounded to it; the states stay float32."""
    w_shared = prec.cast_(sd["rpn.head.shared_conv.weight"].float())
    w_cls = prec.cast_(sd["rpn.head.conv_cls.weight"].float())
    w_out = torch.cat([w_cls, prec.cast_(sd["rpn.head.conv_bbox.weight"].float())], dim=0)
    a = w_cls.shape[0]
    sdt = prec.states
    li = li_coefficients(t_steps).tolist()
    objs, dels, counts = [], [], []
    for f in feats:
        x = prec.round(f).to(sdt)
        v_enc = torch.zeros_like(x)
        v, i = torch.zeros_like(x), torch.zeros_like(x)
        n, _, h, w = x.shape
        lv = torch.zeros((n, w_out.shape[0], h, w), dtype=sdt, device=x.device)
        li_i = torch.zeros_like(lv)
        ssum = torch.zeros_like(x, dtype=torch.float32)
        periods = encoder_periods(f, t_steps) if prec.cast is not None else None
        count = torch.zeros((), dtype=torch.float64, device=x.device)
        for t in range(t_steps):
            if periods is None:
                z, v_enc = encoder_step(x, v_enc)
            else:
                z = (torch.remainder(torch.full_like(periods, t + 1), periods) == 0).to(sdt)
            count = count + z.sum(dtype=torch.float64)
            cur = prec.cast_(conv(z.float(), w_shared, prec))
            s, v, i = lif_step(cur.to(sdt), v, i)
            if prec.cast is None:
                lv, li_i = li_step(conv(s.float(), w_out, prec).to(sdt), lv, li_i)
            else:
                ssum = ssum + li[t] * s.float()
        if prec.cast is None:
            mem = lv.float()
        else:
            mem = prec.cast_(conv(ssum, w_out, prec))
        mem = mem.permute(0, 2, 3, 1)
        objs.append(mem[..., :a].contiguous())
        dels.append(mem[..., a:].contiguous())
        counts.append(count)
    return objs, dels, torch.stack(counts)


def box_head(sd, x: torch.Tensor, t_steps: int, prec=FLOAT32):
    """The spiking box head on RoI features x [R, 256 * 7 * 7] in torch's
    (C, 7, 7) flattening. Returns (class logits [R, C], deltas [R, 4C]).
    With ``prec.cast`` the weights, the RoI features and every step's
    currents are rounded to it and the encoder fires from its exact
    periods, as in :func:`rpn_head`; the states stay float32."""
    p = "roi_heads.box_head_and_predictor."
    w6, w7, wc, wb = (prec.cast_(sd[f"{p}{k}.weight"].float())
                      for k in ("fc6", "fc7", "cls_score", "bbox_pred"))
    sdt = prec.states
    r = x.shape[0]
    x = prec.cast_(x)
    xs = prec.round(x).to(sdt)
    v_enc = torch.zeros_like(xs)
    periods = encoder_periods(x, t_steps) if prec.cast is not None else None

    def zeros(k):
        return torch.zeros((r, k), dtype=sdt, device=x.device)

    v6, i6, v7, i7 = zeros(w6.shape[0]), zeros(w6.shape[0]), zeros(w7.shape[0]), zeros(w7.shape[0])
    vc, ic, vb, ib = zeros(wc.shape[0]), zeros(wc.shape[0]), zeros(wb.shape[0]), zeros(wb.shape[0])

    def linear(s, w):
        return prec.cast_(prec.round(torch.matmul(s.float(), prec.round(w).t()))).to(sdt)

    for t in range(t_steps):
        if periods is None:
            z, v_enc = encoder_step(xs, v_enc)
        else:
            z = (torch.remainder(torch.full_like(periods, t + 1), periods) == 0).to(sdt)
        s6, v6, i6 = lif_step(linear(z, w6), v6, i6)
        s7, v7, i7 = lif_step(linear(s6, w7), v7, i7)
        vc, ic = li_step(linear(s7, wc), vc, ic)
        vb, ib = li_step(linear(s7, wb), vb, ib)
    return vc.float(), vb.float()


# --------------------------------------------------------------------------
# RPN selection, RoIAlign and the postprocess.


def flatten_head(objs, dels):
    n = objs[0].shape[0]
    counts = [o.shape[1] * o.shape[2] * o.shape[3] for o in objs]
    return (torch.cat([o.reshape(n, -1) for o in objs], 1),
            torch.cat([d.reshape(n, -1, 4) for d in dels], 1), counts)


def select_pre_nms(obj, deltas, anchors, counts, top_n):
    """Per level the top ``top_n`` anchors by objectness, decoded. Returns
    (logits [N, S], proposals [N, S, 4], takes per level)."""
    vals, boxes, takes = [], [], []
    off = 0
    for k in counts:
        take = min(top_n, k)
        v, idx = sort_desc(obj[:, off:off + k])
        v, idx = v[:, :take], idx[:, :take] + off
        d = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
        vals.append(v)
        boxes.append(decode(d, anchors[idx]))
        takes.append(take)
        off += k
    return torch.cat(vals, 1), torch.cat(boxes, 1), takes


def filter_proposals(proposals, scores, takes, image_hw, rpn):
    """Post-NMS proposals from the pre-NMS rows: ``scores`` are the sigmoid
    objectness [N, S], in descending order within each level. Returns
    (boxes [N, P, 4], valid [N, P])."""
    n = proposals.shape[0]
    boxes = clip(proposals, image_hw[0], image_hw[1])
    valid = big_enough(boxes, rpn["min_size"]) & (scores >= rpn["score_thresh"])
    smax = max(takes)
    bs = boxes.new_zeros((n, len(takes), smax, 4))
    ss = scores.new_zeros((n, len(takes), smax))
    vs = torch.zeros((n, len(takes), smax), dtype=torch.bool, device=boxes.device)
    off = 0
    for lvl, k in enumerate(takes):
        bs[:, lvl, :k] = boxes[:, off:off + k]
        ss[:, lvl, :k] = scores[:, off:off + k]
        vs[:, lvl, :k] = valid[:, off:off + k]
        off += k
    keep, _ = nms_keep(bs.reshape(-1, smax, 4), ss.reshape(-1, smax), vs.reshape(-1, smax),
                       rpn["nms_thresh"], presorted=True)
    keep = keep.reshape(n, len(takes), smax)
    keep = torch.cat([keep[:, lvl, :k] for lvl, k in enumerate(takes)], 1)
    idx, out_valid = topk_kept(scores, keep, rpn["post_nms_top_n_test"])
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), out_valid


def roi_align(feats: List[torch.Tensor], boxes: torch.Tensor, image_hw) -> torch.Tensor:
    """MultiScaleRoIAlign over NCHW levels (7x7, sampling ratio 2,
    aligned=False). boxes [N, R, 4]. Returns [N, R, C, 7, 7] float32."""
    n, r, _ = boxes.shape
    c = feats[0].shape[1]
    dev = boxes.device
    scales = []
    for f in feats:
        s_h = 2.0 ** round(math.log2(f.shape[2] / image_hw[0]))
        scales.append(s_h)
    k_min, k_max = int(-math.log2(scales[0])), int(-math.log2(scales[-1]))
    size = torch.sqrt(box_area(boxes))
    lvl = torch.floor(4.0 + torch.log2(size / torch.tensor(224.0, device=dev)) + 1e-6)
    lvl = (torch.clamp(lvl, k_min, k_max) - k_min).long()
    out = torch.zeros((n, r, c, 7, 7), dtype=torch.float32, device=dev)
    ph = torch.arange(7, dtype=torch.float32, device=dev)
    sub = (torch.arange(2, dtype=torch.float32, device=dev) + 0.5) / 2.0
    for li, f in enumerate(feats):
        sel = lvl == li
        if not bool(sel.any()):
            continue
        img, roi = sel.nonzero(as_tuple=True)
        b = boxes[img, roi] * scales[li]
        hh, ww = f.shape[2], f.shape[3]
        seven = torch.tensor(7.0, device=dev)
        bw = torch.clamp(b[:, 2] - b[:, 0], min=1.0) / seven
        bh = torch.clamp(b[:, 3] - b[:, 1], min=1.0) / seven
        ys = b[:, 1, None, None] + (ph[:, None] + sub[None]) * bh[:, None, None]   # [K, 7, 2]
        xs = b[:, 0, None, None] + (ph[:, None] + sub[None]) * bw[:, None, None]
        fm = f.float().permute(0, 2, 3, 1)                                        # [N, H, W, C]
        acc = None
        for sa in range(2):
            for sb in range(2):
                y = ys[:, :, None, sa].expand(-1, 7, 7)
                x = xs[:, None, :, sb].expand(-1, 7, 7)
                inside = ((y >= -1.0) & (y <= hh) & (x >= -1.0) & (x <= ww)).float()
                y, x = torch.clamp(y, min=0.0), torch.clamp(x, min=0.0)
                y0 = torch.clamp(y.long(), max=hh - 1)
                x0 = torch.clamp(x.long(), max=ww - 1)
                y = torch.where(y0 >= hh - 1, y0.float(), y)
                x = torch.where(x0 >= ww - 1, x0.float(), x)
                y1, x1 = torch.clamp(y0 + 1, max=hh - 1), torch.clamp(x0 + 1, max=ww - 1)
                ly, lx = y - y0.float(), x - x0.float()
                hy, hx = 1.0 - ly, 1.0 - lx
                k = img[:, None, None]

                def at(yi, xi):
                    return fm[k, yi, xi]                                           # [K, 7, 7, C]

                v = (((hy * hx * inside)[..., None] * at(y0, x0)
                      + (hy * lx * inside)[..., None] * at(y0, x1))
                     + ((ly * hx * inside)[..., None] * at(y1, x0)
                        + (ly * lx * inside)[..., None] * at(y1, x1)))
                acc = v if acc is None else acc + v
        out[img, roi] = (acc / 4.0).permute(0, 3, 1, 2)
    return out


def class_boxes(deltas, proposals, image_hw, n_cls):
    n, p, _ = proposals.shape
    boxes = decode(deltas, proposals, (10.0, 10.0, 5.0, 5.0)).reshape(n, p, -1, 4)
    return clip(boxes.expand(n, p, n_cls, 4), image_hw[0], image_hw[1])


def postprocess(all_scores, all_boxes, prop_valid, roi) -> Dict[str, torch.Tensor]:
    """The open-set postprocess from the per-class scores [N, P, C] and
    clipped boxes [N, P, C, 4] of the proposals (zero where a proposal is not
    valid). Returns boxes, scores, labels, valid [N, D + P, ...]: the
    ``detections_per_img`` best foreground detections, then the kept
    background boxes in score order."""
    n, p, c = all_scores.shape
    fg_boxes = all_boxes[:, :, 1:].reshape(n, -1, 4)
    fg_scores = all_scores[:, :, 1:].reshape(n, -1)
    fg_labels = torch.arange(1, c, device=all_scores.device).repeat(p)
    fg_prop_valid = prop_valid.repeat_interleave(c - 1, dim=1)
    above = fg_scores > roi["score_thresh"]
    fg_valid = above & fg_prop_valid & big_enough(fg_boxes, roi["min_size"])
    claimed = (above & fg_prop_valid).reshape(n, p, c - 1).any(dim=-1)
    bg_boxes, bg_scores = all_boxes[:, :, 0], all_scores[:, :, 0]
    bg_valid = prop_valid & ~claimed & big_enough(bg_boxes, roi["min_size"])
    fg_keep, _ = nms_keep(all_boxes[:, :, 1:].transpose(1, 2).reshape(-1, p, 4),
                          all_scores[:, :, 1:].transpose(1, 2).reshape(-1, p),
                          fg_valid.reshape(n, p, c - 1).transpose(1, 2).reshape(-1, p),
                          roi["nms_thresh"])
    fg_keep = fg_keep.reshape(n, c - 1, p).transpose(1, 2).reshape(n, -1)
    bg_keep, bg_order = nms_keep(bg_boxes, bg_scores, bg_valid, roi["nms_thresh"])
    fg_idx, fg_ok = topk_kept(fg_scores, fg_keep, roi["detections_per_img"])
    # The kept background rows in score order, then the others.
    kept_o = torch.gather(bg_keep, 1, bg_order)
    cum = torch.cumsum(kept_o.long(), dim=1)
    nk = cum[:, -1:]
    pos_i = torch.arange(p, device=all_scores.device).expand(n, p)
    pos = torch.where(kept_o, cum - 1, nk + pos_i - cum)
    bg_idx = torch.zeros_like(bg_order).scatter_(1, pos, bg_order)
    bg_ok = pos_i < nk
    boxes = torch.cat([torch.gather(fg_boxes, 1, fg_idx[..., None].expand(-1, -1, 4)),
                       torch.gather(bg_boxes, 1, bg_idx[..., None].expand(-1, -1, 4))], 1)
    scores = torch.cat([torch.gather(fg_scores, 1, fg_idx), torch.gather(bg_scores, 1, bg_idx)], 1)
    labels = torch.cat([fg_labels[fg_idx], torch.zeros_like(bg_idx)], 1)
    valid = torch.cat([fg_ok, bg_ok], 1)
    return {"boxes": torch.where(valid[..., None], boxes, 0.0),
            "scores": torch.where(valid, scores, 0.0),
            "labels": torch.where(valid, labels, 0), "valid": valid}


# --------------------------------------------------------------------------
# Stages as the comparison uses them.


def rpn_stage(sd, cfg, images, prec=FLOAT32, feats=None):
    """The RPN head on ``feats`` (NCHW levels; None: the backbone and FPN of
    images [N, H, W, 3]). Returns a dict: feats, obj (logits [N, K]), deltas
    [N, K, 4], anchors [K, 4], counts (anchors per level), enc_spikes [L]."""
    if feats is None:
        feats = backbone_features(sd, cfg, images, prec)
    objs, dels, enc = rpn_head(sd, feats, cfg["t_rpn"], prec)
    obj, deltas, counts = flatten_head(objs, dels)
    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    anchors = torch.cat(anchors_per_level(cfg, shapes, images.shape[1:3], images.device))
    return {"feats": feats, "obj": obj, "deltas": deltas, "anchors": anchors,
            "counts": counts, "enc_spikes": enc}


def box_stage(sd, cfg, feats, proposals, prec=FLOAT32):
    """RoIAlign over the levels but the pool and the box head on proposals
    [N, P, 4]. Returns (all_scores [N, P, C], all_boxes [N, P, C, 4]) before
    the validity mask."""
    n, p, _ = proposals.shape
    hw = cfg["bucket"]
    pooled = roi_align(feats[:-1], proposals, hw)
    logits, deltas = box_head(sd, pooled.reshape(n * p, -1), cfg["t_det"], prec)
    del pooled
    logits, deltas = logits.reshape(n, p, -1), deltas.reshape(n, p, -1)
    return torch.softmax(logits, dim=-1), class_boxes(deltas, proposals, hw, logits.shape[-1])


def forward(sd, cfg, images, prec=FLOAT32) -> Dict[str, torch.Tensor]:
    """The whole detector, as the program's evaluation returns it (original
    sizes equal to the bucket): boxes, scores, labels, valid, proposals and
    objectness (pre-NMS), all_scores, all_boxes."""
    r = rpn_stage(sd, cfg, images, prec)
    logits, props, takes = select_pre_nms(r["obj"], r["deltas"], r["anchors"], r["counts"],
                                          cfg["rpn"]["pre_nms_top_n_test"])
    scores = torch.sigmoid(logits)
    boxes, valid = filter_proposals(props, scores, takes, cfg["bucket"], cfg["rpn"])
    all_scores, all_boxes = box_stage(sd, cfg, r["feats"], boxes, prec)
    all_scores = torch.where(valid[..., None], all_scores, 0.0)
    all_boxes = torch.where(valid[..., None, None], all_boxes, 0.0)
    out = postprocess(all_scores, all_boxes, valid, cfg["roi"])
    out.update(proposals=props, objectness=scores, all_scores=all_scores, all_boxes=all_boxes)
    return out
