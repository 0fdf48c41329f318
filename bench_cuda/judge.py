"""The comparison that decides ``correct``: what the timed window returned,
against the plain reference (``reference/model.py``) on the same inputs and
the same state dict.

Evaluation. A spiking head turns a rounding difference into a spike that
fires or not, and the backbone's bf16 rounding moves its FPN levels by a
percent or more from float32's (sharply more on some MobileNet seeds), so
a float32 run from the images parts from the program at every head by as
much as a lower precision does. The reference therefore checks the start
and then follows the program step by step from its own state, the FPN
levels of the judged images. Those levels are not what the timed call
returned: the harness computes them in a second pass after the window
(``models/detector.backbone_features``, the function the entry calls), and
the window's own backbone is judged only through the ``objectness`` that
the reference computes from them:

  * ``features``: the program's FPN levels against the reference's
    backbone and FPN from the images, in float32;
  * ``objectness``: the program's pre-NMS objectness of every image and
    level, as logits in descending order, against the reference RPN head's
    top ``pre_nms_top_n`` of the same level on the program's levels, in
    descending order (the heads in float32 with what the configuration
    stores in its compute dtype rounded to it: weights, RoI features,
    currents, the RPN readout; ``model.rpn_head``) (order statistics: a rank swap between two near-equal
    anchors costs nothing, a shifted or scaled map does);
  * ``proposals``: each pre-NMS proposal of the program against the best
    overlapping of the reference's top 2 x ``pre_nms_top_n`` decoded boxes
    of its level; the mean of 1 - IoU;
  * ``proposals_own``: the same against the reference's RPN head on its
    own levels, from the images: the one number that the reference
    computes end to end, with nothing of the program's state;
  * ``class_scores`` and ``box_shifts``: the reference takes the program's
    pre-NMS proposals and objectness through its own filtering (clip, masks,
    NMS, top-k), RoIAlign on the program's levels and its box head; on
    every valid proposal, the program's per-class scores as centred
    log-scores (the class logits up to a constant), and its per-class boxes
    as shifts from their proposal, against the reference's;
  * ``detections``: the reference's postprocess of the program's own
    per-class scores and boxes against the program's boxes, scores, labels
    and validity: mismatched elements, exact.

``features``, ``objectness``, ``class_scores`` and ``box_shifts`` each as
:class:`Gap`'s ``rel`` and ``scale`` (the latter named ``<name>_scale``).
Every run reports all of them; a cell compares those
that its ``limits/<cell>.json`` names. A number is compared only where the
control (the reference in the precision below the configuration's,
``model.CONTROL``) reads three times what sound runs of the program read
over a dozen seeds or more, and its limit lies between the two; ``PERF.md``
section 2 gives the readings.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_cuda.reference import model as ref

class Gap:
    """Two gaps of ``got`` from ``want``, accumulated over pieces in
    float64: ``rel`` = ||got - want|| / ||want||, which every difference
    raises, and ``scale`` = |<got, want> / <want, want> - 1|, how far
    ``got`` lies from ``want`` along ``want``, in which differences that
    rounding moves either way cancel and a lost or added share of the
    signal does not."""

    def __init__(self):
        self.diff = self.dot = self.norm = 0.0
        self.bad = False

    def add(self, got: torch.Tensor, want: torch.Tensor):
        got, want = got.double(), want.double()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            self.bad = True
            return
        self.diff += float(((got - want) ** 2).sum())
        self.dot += float((got * want).sum())
        self.norm += float((want ** 2).sum())

    def rel(self) -> float:
        if self.bad or self.norm == 0.0:
            return 0.0 if not self.bad and self.diff == 0.0 else float("inf")
        return (self.diff / self.norm) ** 0.5

    def scale(self) -> float:
        if self.bad or self.norm == 0.0:
            return 0.0 if not self.bad and self.diff == 0.0 else float("inf")
        return abs(self.dot / self.norm - 1.0)


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(1e-12, 1.0 - 1e-12)
    return torch.log(p) - torch.log1p(-p)


def _centred_log(scores: torch.Tensor) -> torch.Tensor:
    lp = torch.log(scores.double().clamp(min=1e-30))
    return lp - lp.mean(dim=-1, keepdim=True)


def _proposal_gap(got_props: torch.Tensor, r: Dict, takes: List[int]) -> float:
    """The sum over the program's pre-NMS proposals [N, sum(takes), 4] of
    1 - IoU with the best overlapping of the top 2 x take decoded boxes of
    their level in the reference's RPN stage ``r``."""
    total, off_a, off_s = 0.0, 0, 0
    for k, take in zip(r["counts"], takes):
        _, idx = ref.sort_desc(r["obj"][:, off_a:off_a + k])
        sel = idx[:, :min(2 * take, k)] + off_a
        boxes = ref.decode(torch.gather(r["deltas"], 1, sel[..., None].expand(-1, -1, 4)),
                           r["anchors"][sel])
        for i in range(got_props.shape[0]):
            best = ref.box_iou(got_props[i, off_s:off_s + take], boxes[i]).amax(dim=1)
            total += float((1.0 - best.double()).sum())
        off_a += k
        off_s += take
    return total


class EvalJudge:
    """Accumulates the evaluation numbers over judged batches."""

    def __init__(self, sd, cfg: Dict):
        self.sd, self.cfg = sd, cfg
        # The heads keep what the configuration stores in its compute dtype
        # (weights, RoI features, currents, the RPN readout) in that dtype,
        # as the program does; float32 compute keeps everything.
        cast = None if cfg["compute_dtype"] == "float32" else getattr(torch, cfg["compute_dtype"])
        self.heads = ref.Precision(cast=cast)
        self.feat, self.obj, self.cls, self.shift = Gap(), Gap(), Gap(), Gap()
        self.iou_gap, self.iou_own, self.iou_n = 0.0, 0.0, 0
        self.mismatched = 0
        self.enc_spikes: List[float] = []

    def add(self, images: torch.Tensor, out: Dict[str, torch.Tensor],
            feats: List[torch.Tensor]):
        """One batch: the images [N, H, W, 3], the program's outputs and its
        FPN levels (NHWC) of these images."""
        cfg, rpn = self.cfg, self.cfg["rpn"]
        with torch.no_grad(), ref.float32_matmuls():
            feats = [f.float().permute(0, 3, 1, 2) for f in feats]
            own = ref.backbone_features(self.sd, cfg, images)
            for f, w in zip(feats, own):
                self.feat.add(f, w)
            r = ref.rpn_stage(self.sd, cfg, images, self.heads, feats=feats)
            self.enc_spikes.append(float(r["enc_spikes"].sum()))
            top_n = rpn["pre_nms_top_n_test"]
            takes = [min(top_n, k) for k in r["counts"]]
            n = images.shape[0]
            got_obj = out["objectness"].float()
            got_props = out["proposals"].float()
            if got_obj.shape[1] != sum(takes):
                self.obj.bad = True
                self.iou_gap = self.iou_own = float("inf")
                return
            off_a = off_s = 0
            for k, take in zip(r["counts"], takes):
                v, _ = ref.sort_desc(r["obj"][:, off_a:off_a + k])
                want = _logit(torch.sigmoid(v[:, :take]))
                got = torch.sort(_logit(got_obj[:, off_s:off_s + take]), dim=-1,
                                 descending=True).values
                self.obj.add(got, want)
                off_a += k
                off_s += take
            self.iou_gap += _proposal_gap(got_props, r, takes)
            self.iou_n += n * sum(takes)
            # From the images to the proposals on the reference's side alone:
            # its RPN head on its own levels.
            self.iou_own += _proposal_gap(
                got_props, ref.rpn_stage(self.sd, cfg, images, self.heads, feats=own), takes)
            del own
            boxes, valid = ref.filter_proposals(got_props, got_obj, takes, cfg["bucket"], rpn)
            want_scores, want_boxes = ref.box_stage(self.sd, cfg, feats, boxes, self.heads)
            del r
            got_scores, got_boxes = out["all_scores"].float(), out["all_boxes"].float()
            self.cls.add(_centred_log(got_scores[valid]), _centred_log(want_scores[valid]))
            shift_from = boxes[:, :, None, :]
            self.shift.add((got_boxes - shift_from)[valid], (want_boxes - shift_from)[valid])
            det = ref.postprocess(got_scores, got_boxes, valid, cfg["roi"])
            for key in ("boxes", "scores", "labels", "valid"):
                a, b = out[key], det[key]
                self.mismatched += (int((a != b).sum()) if a.shape == b.shape
                                    else max(a.numel(), b.numel()))

    def readings(self) -> Dict[str, float]:
        return {"features": self.feat.rel(), "features_scale": self.feat.scale(),
                "objectness": self.obj.rel(), "objectness_scale": self.obj.scale(),
                "proposals": self.iou_gap / max(self.iou_n, 1),
                "proposals_own": self.iou_own / max(self.iou_n, 1),
                "class_scores": self.cls.rel(), "class_scores_scale": self.cls.scale(),
                "box_shifts": self.shift.rel(), "box_shifts_scale": self.shift.scale(),
                "detections": float(self.mismatched)}


def held(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number with its limit, in the limits' order."""
    return {k: {"value": readings.get(k, float("inf")), "limit": lim} for k, lim in limits.items()}


def within(compared: Dict[str, Dict[str, float]]) -> bool:
    return all(v["value"] <= v["limit"] for v in compared.values())
