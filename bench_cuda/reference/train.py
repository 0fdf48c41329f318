"""The plain reference of a frozen-backbone training step: the RPN's and
the RoI heads' targets, samples and losses, their gradients through the
spiking heads (SuperSpike surrogate), and AdamW.

Semantics (torchvision 0.13's Faster R-CNN training as the reference
configures it, with the spiking heads of ``model.py``): anchors matched at
0.7/0.3 with low-quality matches, 256 a image sampled at half positive, BCE
on the objectness and smooth-L1 (beta 1/9) on the positives' deltas over the
sampled count; proposals from the detached head outputs (per-level top
``pre_nms_top_n_train``, NMS, the top ``post_nms_top_n_train``); the ground
truth appended, matched at 0.5 without low-quality matches, 512 a image
sampled at a quarter positive, cross-entropy and smooth-L1 on the sampled
RoIs. The samplers take given uniform draws: the largest draws win.

The heads keep what the configuration stores in its compute dtype in that
dtype (``model.Precision.cast``): the weights, the currents and the RPN
readout are rounded to it on the way forward and passed straight through on
the way back; the states stay float32. The RPN head's encoder then fires from
its exact periods, as the port's training kernels compute it; the box head's
carries its membrane step by step, as the port's scan does. Without a cast
dtype every value is float32 and the RPN head is the scan too.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_cuda.reference import model as ref

NEG_INF = ref.NEG_INF
ALPHA = 100.0          # SuperSpike's steepness (norse 0.0.7)
RPN_BLOCK = 4          # images a block of the RPN head's forward and backward


class _Spike(torch.autograd.Function):
    """Heaviside forward; SuperSpike backward g / (alpha |x| + 1)^2."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x > 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / (ALPHA * x.abs() + 1.0) ** 2


def straight(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` forward, its gradient passed through."""
    return x if dtype is None else x + (x.to(dtype).to(x.dtype) - x).detach()


def lif_step(cur, v, i):
    """``model.lif_step`` with the surrogate gradient through the spike."""
    v_dec = v + ref._c(ref.DT * ref.TAU_MEM, v) * ((0.0 - v) + i)
    i_dec = i + ref._c(-ref.DT * ref.TAU_SYN, i) * i
    z = _Spike.apply(v_dec - ref._c(ref.LIF_VTH, v))
    return z, (1.0 - z) * v_dec, i_dec + cur


def smooth_l1(d, beta):
    a = d.abs()
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def encode(gt, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """torchvision ``BoxCoder.encode_single``."""
    wx, wy, ww, wh = weights
    ew, eh = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    ex, ey = boxes[..., 0] + 0.5 * ew, boxes[..., 1] + 0.5 * eh
    gw, gh = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
    gx, gy = gt[..., 0] + 0.5 * gw, gt[..., 1] + 0.5 * gh
    return torch.stack([wx * (gx - ex) / ew, wy * (gy - ey) / eh,
                        ww * torch.log(gw / ew), wh * torch.log(gh / eh)], dim=-1)


def match(quality, gt_valid, high, low, low_quality):
    """torchvision's ``Matcher``: [N, G, K] quality -> [N, K] index, -1
    below ``low``, -2 between."""
    q = torch.where(gt_valid[..., :, None], quality, -1.0)
    vals, idx = q.max(dim=-2)
    out = torch.where(vals < low, -1, idx)
    out = torch.where((vals >= low) & (vals < high), -2, out)
    if low_quality:
        best = (q == q.max(dim=-1, keepdim=True).values) & gt_valid[..., :, None]
        out = torch.where(best.any(dim=-2), idx, out)
    return out


def _top(keys, k, limit=None):
    vals, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    take = vals > NEG_INF
    if limit is not None:
        take = take & (torch.arange(k, device=keys.device) < limit)
    return torch.zeros_like(keys, dtype=torch.bool).scatter(-1, idx, take)


def sample(positive, negative, rp, rn, batch, fraction):
    """The positives with the largest ``rp`` (at most batch x fraction) and
    the negatives with the largest ``rn`` (the rest of the batch)."""
    k = positive.shape[-1]
    pos = _top(torch.where(positive, rp, NEG_INF), min(int(batch * fraction), k))
    neg = _top(torch.where(negative, rn, NEG_INF), min(batch, k),
               batch - pos.sum(dim=-1, keepdim=True))
    return pos, neg


def rpn_targets(anchors, gt_boxes, gt_valid, rpn):
    """Anchor labels [N, K] (1, 0, -1 ignored) and regression targets."""
    matched = match(ref.box_iou(gt_boxes, anchors[None]), gt_valid, rpn["fg_iou_thresh"],
                    rpn["bg_iou_thresh"], True)
    labels = torch.where(matched >= 0, 1.0, torch.where(matched == -1, 0.0, -1.0))
    labels = torch.where(gt_valid.any(dim=-1, keepdim=True), labels, 0.0)
    mb = torch.gather(gt_boxes, 1, matched.clamp(min=0)[..., None].expand(-1, -1, 4))
    safe = torch.where((labels == 1.0)[..., None], mb, anchors[None])
    return labels, encode(safe, anchors[None])


def roi_samples(proposals, prop_valid, gt_boxes, gt_labels, gt_valid, roi, draws):
    """The sampled RoIs, positives first: boxes [N, S, 4], labels [N, S],
    regression targets [N, S, 4], valid [N, S]."""
    s = roi["batch_size_per_image"]
    all_boxes = torch.cat([proposals, gt_boxes], 1)
    all_valid = torch.cat([prop_valid, gt_valid], 1)
    rp, rn, r_pack = draws
    quality = torch.where(all_valid[:, None, :], ref.box_iou(gt_boxes, all_boxes), -1.0)
    matched = match(quality, gt_valid, roi["fg_iou_thresh"], roi["bg_iou_thresh"], False)
    safe = matched.clamp(min=0)
    labels = torch.where(matched >= 0, torch.gather(gt_labels, 1, safe), 0)
    ignore = matched == -2
    pos, neg = sample((labels > 0) & all_valid & ~ignore, (labels == 0) & all_valid & ~ignore,
                      rp, rn, s, roi["positive_fraction"])
    key = torch.where(pos, 2.0 + r_pack, torch.where(neg, 1.0 + r_pack, NEG_INF))
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :s], idx[:, :s]
    ok = vals > NEG_INF
    boxes = torch.gather(all_boxes, 1, idx[..., None].expand(-1, -1, 4))
    lab = torch.where(ok, torch.gather(labels, 1, idx), 0)
    mb = torch.gather(gt_boxes, 1, torch.gather(safe, 1, idx)[..., None].expand(-1, -1, 4))
    unit = torch.tensor((0.0, 0.0, 1.0, 1.0), device=boxes.device)
    boxes = torch.where(ok[..., None], boxes, unit)
    target = torch.where(((lab > 0) & ok)[..., None], mb, boxes)
    return boxes, lab, encode(target, boxes, tuple(roi["bbox_reg_weights"])), ok


def _rpn_block(w, feats, t_steps, cast):
    """Objectness [n, K_b] and deltas [n, K_b, 4] of a block of images. With
    ``cast`` as the kernels compute it (exact encoder periods, the readout
    from the LI-weighted spike sums); without, as the float32 scan does (the
    encoder's membrane and the LI readout carried step by step)."""
    w_shared = straight(w["rpn.head.shared_conv.weight"], cast)
    w_out = torch.cat([straight(w["rpn.head.conv_cls.weight"], cast),
                       straight(w["rpn.head.conv_bbox.weight"], cast)], 0)
    a = w["rpn.head.conv_cls.weight"].shape[0]
    li = ref.li_coefficients(t_steps).tolist()
    objs, dels = [], []
    for f in feats:
        periods = ref.encoder_periods(f, t_steps) if cast is not None else None
        v, i, v_enc = torch.zeros_like(f), torch.zeros_like(f), torch.zeros_like(f)
        ssum = torch.zeros_like(f)
        n, _, h, wd = f.shape
        lv = torch.zeros((n, w_out.shape[0], h, wd), device=f.device)
        li_i = torch.zeros_like(lv)
        for t in range(t_steps):
            if periods is None:
                z, v_enc = ref.encoder_step(f, v_enc)
            else:
                z = (torch.remainder(torch.full_like(periods, t + 1), periods) == 0).float()
            cur = straight(torch.nn.functional.conv2d(z, w_shared, padding=1), cast)
            s, v, i = lif_step(cur, v, i)
            if periods is None:
                lv, li_i = ref.li_step(torch.nn.functional.conv2d(s, w_out), lv, li_i)
            else:
                ssum = ssum + li[t] * s
        out = lv if periods is None else straight(torch.nn.functional.conv2d(ssum, w_out), cast)
        out = out.permute(0, 2, 3, 1)
        objs.append(out[..., :a])
        dels.append(out[..., a:])
    n = feats[0].shape[0]
    return (torch.cat([o.reshape(n, -1) for o in objs], 1),
            torch.cat([d.reshape(n, -1, 4) for d in dels], 1))


def _box_head(w, x, t_steps, cast):
    """The box head on RoI features x [R, 256 * 49] (torch's flattening)
    under autograd; the encoder carries its membrane step by step."""
    p = "roi_heads.box_head_and_predictor."
    w6, w7, wc, wb = (straight(w[f"{p}{k}.weight"], cast)
                      for k in ("fc6", "fc7", "cls_score", "bbox_pred"))
    x = x if cast is None else x.to(cast).float()
    r = x.shape[0]
    v_enc = torch.zeros_like(x)

    def zeros(k):
        return torch.zeros((r, k), device=x.device)

    v6, i6, v7, i7 = zeros(w6.shape[0]), zeros(w6.shape[0]), zeros(w7.shape[0]), zeros(w7.shape[0])
    vc, ic, vb, ib = zeros(wc.shape[0]), zeros(wc.shape[0]), zeros(wb.shape[0]), zeros(wb.shape[0])
    for _ in range(t_steps):
        with torch.no_grad():
            z, v_enc = ref.encoder_step(x, v_enc)
        s6, v6, i6 = lif_step(straight(z @ w6.t(), cast), v6, i6)
        s7, v7, i7 = lif_step(straight(s6 @ w7.t(), cast), v7, i7)
        vc, ic = ref.li_step(straight(s7 @ wc.t(), cast), vc, ic)
        vb, ib = ref.li_step(straight(s7 @ wb.t(), cast), vb, ib)
    return vc, vb


def step_losses(w: Dict[str, torch.Tensor], cfg, feats: List[torch.Tensor], batch: Dict,
                cast) -> Dict[str, float]:
    """One step's four losses on the FPN levels ``feats`` (NCHW, float32),
    with the gradients of the leaves of ``w`` (torchvision names, requiring
    grad) accumulated in their ``.grad``. The RPN head runs and back-props
    in blocks of images; its losses are over the whole batch's counts."""
    rpn, roi = cfg["rpn"], cfg["roi"]
    n = feats[0].shape[0]
    tg = batch["targets"]
    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    per_level = ref.anchors_per_level(cfg, shapes, cfg["bucket"], feats[0].device)
    counts = [a.shape[0] for a in per_level]
    anchors = torch.cat(per_level)
    labels, targets = rpn_targets(anchors, tg["boxes"], tg["valid"], rpn)
    rp, rn = batch["draws"]["rpn"]
    pos, neg = sample(labels == 1.0, labels == 0.0, rp, rn, rpn["batch_size_per_image"],
                      rpn["positive_fraction"])
    sampled = pos | neg
    num = sampled.sum().clamp(min=1)
    obj_all, del_all, losses = [], [], {"loss_objectness": 0.0, "loss_rpn_box_reg": 0.0}
    for b in range(0, n, RPN_BLOCK):
        sl = slice(b, min(b + RPN_BLOCK, n))
        obj, deltas = _rpn_block(w, [f[sl] for f in feats], cfg["t_rpn"], cast)
        lb = labels[sl]
        bce = obj.clamp(min=0) - obj * lb + torch.log1p(torch.exp(-obj.abs()))
        l_obj = (bce * sampled[sl]).sum() / num
        l_box = (smooth_l1(deltas - targets[sl], 1.0 / 9).sum(-1) * pos[sl]).sum() / num
        (l_obj + l_box).backward()
        losses["loss_objectness"] += float(l_obj.detach())
        losses["loss_rpn_box_reg"] += float(l_box.detach())
        obj_all.append(obj.detach())
        del_all.append(deltas.detach())
    with torch.no_grad():
        logits, props, takes = ref.select_pre_nms(torch.cat(obj_all), torch.cat(del_all), anchors,
                                                  counts, rpn["pre_nms_top_n_train"])
        train_rpn = dict(rpn, post_nms_top_n_test=rpn["post_nms_top_n_train"])
        boxes, valid = ref.filter_proposals(props, torch.sigmoid(logits), takes, cfg["bucket"],
                                            train_rpn)
        sboxes, slabels, stargets, svalid = roi_samples(
            boxes, valid, tg["boxes"], tg["labels"], tg["valid"], roi, batch["draws"]["roi"])
        pooled = ref.roi_align(feats[:-1], sboxes, cfg["bucket"])
    s = sboxes.shape[1]
    cls, reg = _box_head(w, pooled.reshape(n * s, -1), cfg["t_det"], cast)
    del pooled
    lab, ok = slabels.reshape(-1), svalid.reshape(-1)
    cnt = ok.sum().clamp(min=1)
    ce = -torch.gather(torch.log_softmax(cls, -1), 1, lab[:, None])[:, 0]
    l_cls = (ce * ok).sum() / cnt
    reg = reg.reshape(n * s, -1, 4)
    rl = torch.gather(reg, 1, lab.clamp(0, reg.shape[1] - 1)[:, None, None].expand(-1, 1, 4))[:, 0]
    l_reg = (smooth_l1(rl - stargets.reshape(-1, 4), 1.0 / 9).sum(-1) * ((lab > 0) & ok)).sum() / cnt
    (l_cls + l_reg).backward()
    losses.update(loss_classifier=float(l_cls.detach()), loss_box_reg=float(l_reg.detach()))
    return losses


class AdamW:
    """torch.optim.AdamW's update, written out: decoupled weight decay,
    bias-corrected moments, the reference's betas and eps (torch's
    defaults)."""

    BETAS, EPS = (0.9, 0.999), 1e-8

    def __init__(self, leaves, lr, weight_decay):
        self.leaves, self.lr, self.wd = leaves, lr, weight_decay
        self.betas, self.eps = self.BETAS, self.EPS
        self.m = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.v = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.leaves.items():
            g = p.grad
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / (1.0 - b2 ** self.t) ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1.0 - b1 ** self.t))
            p.grad = None
