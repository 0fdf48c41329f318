"""One run of a training cell: the frozen-backbone step of the port, timed,
and its first three steps followed by the reference. On W > 1 cards every
rank runs this (``ranks.py`` starts them), as ``torchrun`` runs the step.

  1. set-up: the state dict drawn from ``--seed`` and loaded, the trainable
     heads split off (``train/optim.split_trainable``), AdamW built
     (``train/optim.build_optimizer``) and the step (``train/steps.
     make_train_step``); the mix's batches drawn on the card: images, 1 to
     ``max_boxes`` seeded boxes an image, and the samplers' uniform draws.
     On W cards each batch is a global batch of W x ``batch`` frames drawn
     as one card draws a batch of that size: rank r keeps its rows
     r x ``batch`` onwards, and every rank the global batch's draws, as the
     port's data parallelism takes them (``parallel/collectives.py``). Then
     the step's first three calls, on three different batches, each loss
     read, the first gradient read from AdamW's state after one step and
     every trained leaf's change after three;
  2. the window: the same object's steps on the batches in turn until
     ``--seconds`` have passed (``--trace 1``: ``traced_batches`` steps under
     the profiler), ended by a synchronise. On W cards rank 0's clock
     decides before each step whether it runs, and tells the other ranks
     over a gloo group of the harness's own, which waits on no card; the
     window starts and ends with every card synchronised and a barrier;
  3. the reference (``reference/train.py``) follows the first three steps
     of the global batch from the same weights, batches and draws, on the
     program's FPN levels of those images (the backbone is frozen; rank 0
     computes them again, ``batch`` frames at a time, as each rank did),
     with its own AdamW; the numbers compared are each step's total loss,
     the first gradient's norm and the three steps' change's norm, each by
     the worst trained leaf, and on W cards by the worst rank.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from bench_cuda import flops, harness, judge, profile, weights
from bench_cuda.reference import model as ref
from bench_cuda.reference import train as ref_train

FIRST_STEPS = 3
ALONE_REPS = 20
# The port's trained leaves and the state dict's names for them.
LEAVES = {"rpn_head/shared_conv/w": "rpn.head.shared_conv.weight",
          "rpn_head/conv_cls/w": "rpn.head.conv_cls.weight",
          "rpn_head/conv_bbox/w": "rpn.head.conv_bbox.weight",
          **{f"box_head/{k}/w": f"roi_heads.box_head_and_predictor.{k}.weight"
             for k in ("fc6", "fc7", "cls_score", "bbox_pred")}}
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")


def train_batches(mix: Dict, cfg: Dict, seed: int, device, world: int = 1,
                  rank: Optional[int] = 0, count: Optional[int] = None) -> List[Dict]:
    """The mix's distinct batches (the first ``count``): frames of the
    bucket (pixels uniform in [0, 1)), 1 to ``max_boxes`` boxes an image
    with labels in 1..C-1, and the samplers' draws: ``rpn`` two [N, K] over
    the anchors, ``roi`` three [N, P + G] over the proposals and the ground
    truth. N is the global batch, ``world`` x ``batch``; the images and
    targets are ``rank``'s rows of it (``rank`` None: all of them)."""
    g = torch.Generator(device=device).manual_seed(harness.input_seed(seed))
    h, w = cfg["min_size"], cfg["max_size"]
    rows, gmax = mix["batch"], mix["max_boxes"]
    n = rows * world
    dev = dict(device=device)
    a = len(cfg["anchor_sizes"][0]) * len(cfg["aspect_ratios"])
    k = a * sum(lh * lw for lh, lw in flops.level_shapes(cfg))
    p = cfg["rpn"]["post_nms_top_n_train"] + gmax
    mine = slice(None) if rank is None else slice(rank * rows, (rank + 1) * rows)
    sizes = torch.tensor([[h, w]] * (n if rank is None else rows), dtype=torch.int64, **dev)
    out = []
    for _ in range(count or mix["distinct_batches"]):
        images = torch.rand((n, h, w, 3), generator=g, **dev)[mine].clone()
        boxes = torch.randint(mix["min_boxes"], gmax + 1, (n, 1), generator=g, **dev)[mine]
        ctr = (torch.rand((n, gmax, 2), generator=g, **dev)
               * torch.tensor([w * 0.74, h * 0.61], **dev) + torch.tensor([w * 0.13, h * 0.195], **dev))
        half = (torch.rand((n, gmax, 2), generator=g, **dev) * torch.tensor([w * 0.11, h * 0.156], **dev)
                + min(h, w) * 0.026)
        labels = torch.randint(1, cfg["num_classes"], (n, gmax), generator=g, **dev)[mine]
        draws = {"rpn": tuple(torch.rand((n, k), generator=g, **dev) for _ in range(2)),
                 "roi": tuple(torch.rand((n, p), generator=g, **dev) for _ in range(3))}
        out.append({"images": images, "image_sizes": sizes, "original_sizes": sizes,
                    "targets": {"boxes": torch.cat([ctr - half, ctr + half], -1)[mine],
                                "labels": labels,
                                "valid": torch.arange(gmax, **dev)[None] < boxes},
                    "draws": draws})
    return out


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The worst leaf's gap of two norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in want)


class _Ranks:
    """This rank's part in a cell on W cards: the port's process group, and
    a gloo group of the harness's own (the window's go-ahead, barriers,
    gathers), which waits on no card. With one card, nothing."""

    def __init__(self, device, world: int):
        self.device, self.world, self.rank, self.ctl = device, world, 0, None
        if world > 1:
            import torch.distributed as dist

            from snn_automotive_object_detection_tpu_torch.parallel.mesh import (
                init_distributed,
            )

            init_distributed(device.type)
            self.dist, self.rank = dist, dist.get_rank()
            self.ctl = dist.new_group(backend="gloo")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.ctl is not None:
            self.dist.barrier(group=self.ctl)

    def rank0s(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        if self.ctl is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        self.dist.broadcast(t, 0, group=self.ctl)
        return bool(t)

    def gather(self, obj) -> List:
        if self.ctl is None:
            return [obj]
        out = [None] * self.world
        self.dist.all_gather_object(out, obj, group=self.ctl)
        return out

    def allreduce_alone_s(self, numel: int) -> float:
        """Seconds of one all-reduce of ``numel`` float32 values over the
        port's group, every rank starting together: the exchange without
        the wait for the slowest rank that a step's all-reduce holds."""
        buf = torch.zeros(numel, device=self.device)
        for _ in range(3):
            self.dist.all_reduce(buf)
        self.sync()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(ALONE_REPS):
                self.dist.all_reduce(buf)
            return (time.perf_counter() - t0) / ALONE_REPS
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(ALONE_REPS):
            self.dist.all_reduce(buf)
        end.record()
        end.synchronize()
        return 1e-3 * start.elapsed_time(end) / ALONE_REPS

    def close(self):
        if self.ctl is not None:
            self.dist.destroy_process_group()


def readings_of(program: Dict, losses_r, grad_r, change_r, moved) -> Dict[str, float]:
    """One rank's numbers against the reference's."""
    losses_p, grad_p, change_p = program["losses"], program["grad"], program["change"]
    out = {
        "loss": max(abs(sum(p[k] for k in LOSSES) - sum(r.values())) / abs(sum(r.values()))
                    for p, r in zip(losses_p, losses_r)),
        "first_gradient": worst_leaf_gap(grad_p, grad_r),
        "change": worst_leaf_gap({k: change_p[k] for k in moved}, {k: change_r[k] for k in moved}),
    }
    gmed, cmed = statistics.median(grad_r.values()), statistics.median(change_r.values())
    for k in LEAVES:
        out[f"first_gradient/{k}"] = abs(grad_p[k] - grad_r[k]) / max(grad_r[k], gmed)
        out[f"change/{k}"] = abs(change_p[k] - change_r[k]) / max(change_r[k], cmed)
    for name in LOSSES:
        out[name] = max(abs(p[name] - r[name]) / max(abs(r[name]), 1e-12)
                        for p, r in zip(losses_p, losses_r))
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}


def run(cell, seed, seconds, traced, t_start, device, man, cfg, mix, limits, fault=None,
        world=1):
    """One run of a training cell on this rank (``harness.run`` hands it
    over); the result line on rank 0, None on the others."""
    from snn_automotive_object_detection_tpu_torch.models.detector import backbone_features
    from snn_automotive_object_detection_tpu_torch.train import optim
    from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
        convert_torch_state_dict,
    )
    from snn_automotive_object_detection_tpu_torch.utils.weights import flatten_tree

    on_card = device.type == "cuda"
    group = _Ranks(device, world)
    try:
        if on_card:
            cuda_build.build_all()
        pcfg = harness.port_config(cfg)
        o = mix["optimizer"]
        sd = weights.make_state_dict(cfg, seed, device)
        params = convert_torch_state_dict(sd, cfg["rpn_snn"], cfg["detector_snn"], device=device)
        del sd
        trainable, frozen = optim.split_trainable(params)
        opt, sched = optim.build_optimizer(trainable, "AdamW", o["lr"],
                                           weight_decay=o["weight_decay"])
        make = FAULTS[fault](make_train_step) if fault else make_train_step
        step = make(pcfg, opt, sched)
        batches = train_batches(mix, cfg, seed, device, world, group.rank)
        n_distinct = len(batches)
        leaves = flatten_tree(trainable)
        start = {k: v.detach().clone() for k, v in leaves.items()}

        def call(i):
            b = batches[i % n_distinct]
            return step(trainable, frozen, b, None, draws=b["draws"])

        losses_p, grad_p = [], {}
        beta1 = opt.param_groups[0]["betas"][0]
        for i in range(FIRST_STEPS):
            out = call(i)
            (~torch.isfinite(out["loss_total"])).long().item()   # the window's check, warmed up
            losses_p.append({k: float(v) for k, v in out.items()})
            if i == 0:
                grad_p = {k: float(opt.state[v]["exp_avg"].norm()) / (1.0 - beta1)
                          if v in opt.state else 0.0 for k, v in leaves.items()}
        change_p = {k: float((v.detach() - start[k]).norm()) for k, v in leaves.items()}
        del start

        bad = torch.zeros((), dtype=torch.int64, device=device)
        trace, alone_s = None, None
        group.sync()
        t_begin = time.perf_counter()
        setup_s = t_begin - t_start
        calls = 0
        if traced:
            n_traced = mix["traced_batches"]

            def window():
                for i in range(n_traced):
                    bad.add_((~torch.isfinite(call(FIRST_STEPS + 1 + i)["loss_total"])).long())

            if on_card:
                trace = profile.trace(lambda: call(FIRST_STEPS), window, device, group.sync)
            else:
                window()
            calls = n_traced
            if world > 1:
                alone_s = group.allreduce_alone_s(sum(v.numel() for v in leaves.values()))
        else:
            while group.rank0s(calls == 0 or time.perf_counter() - t_begin < seconds):
                bad.add_((~torch.isfinite(call(FIRST_STEPS + calls)["loss_total"])).long())
                calls += 1
        group.sync()
        window_s = time.perf_counter() - t_begin
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        every = group.gather({"failed": int(bad), "peak": peak, "banned": harness.banned_modules(),
                              "busy_s": trace.busy_s if trace is not None else None,
                              "losses": losses_p, "grad": grad_p, "change": change_p})
    finally:
        group.close()
    found = sorted({m for r in every for m in r["banned"]})
    if found:
        raise harness.RunError(f"modules loaded that a run may not load: {found}")
    if group.rank > 0:
        return None
    failed = sum(r["failed"] for r in every)
    peak = max(r["peak"] for r in every)

    # The program's FPN levels of the first steps' images, the global batch
    # ``batch`` frames at a time: its frozen backbone's, the state the
    # reference follows it from.
    merged = optim.merge_params(trainable, frozen)
    del params, opt, step, leaves, batches
    if on_card:
        torch.cuda.empty_cache()
    firsts = train_batches(mix, cfg, seed, device, world, None, FIRST_STEPS)

    def levels(images):
        rows = mix["batch"]
        with torch.no_grad():
            parts = [backbone_features(merged, images[j:j + rows], pcfg, True)
                     for j in range(0, images.shape[0], rows)]
        return [torch.cat([p[lvl] for p in parts]).float().permute(0, 3, 1, 2)
                for lvl in range(len(parts[0]))]

    sd = weights.make_state_dict(cfg, seed, device)
    ref_leaves = {k: sd[v].detach().clone().requires_grad_(True) for k, v in LEAVES.items()}
    del sd
    w = {LEAVES[k]: v for k, v in ref_leaves.items()}
    start = {k: v.detach().clone() for k, v in ref_leaves.items()}
    adamw = ref_train.AdamW(ref_leaves, o["lr"], o["weight_decay"])
    cast = None if cfg["compute_dtype"] == "float32" else getattr(torch, cfg["compute_dtype"])
    losses_r, grad_r = [], {}
    with ref.float32_matmuls():
        for i in range(FIRST_STEPS):
            feats = levels(firsts[i]["images"])
            losses_r.append(ref_train.step_losses(w, cfg, feats, firsts[i], cast))
            del feats
            if i == 0:
                grad_r = {k: float(v.grad.norm()) for k, v in ref_leaves.items()}
            adamw.step()
    change_r = {k: float((v.detach() - start[k]).norm()) for k, v in ref_leaves.items()}
    # Leaves whose gradient is nought to rounding move by round-off alone:
    # left out of the change by the reference's gradient.
    med = statistics.median(grad_r.values())
    moved = [k for k in change_r if grad_r[k] >= 1e-3 * med]
    by_rank = [readings_of(r, losses_r, grad_r, change_r, moved) for r in every]
    readings = {k: max(r[k] for r in by_rank) for k in by_rank[0]}
    compared = judge.held(readings, limits)
    correct = failed == 0 and judge.within(compared)

    values = {}
    if traced:
        ctx = harness.Context(trace=trace, cfg=cfg, batch=mix["batch"], batches=calls,
                              allreduce_alone_s=alone_s)
        for m in harness.per_layer(man, cell):
            v = harness.reader(m["name"]).read(ctx) if trace is not None else None
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"train_images_per_s": calls * mix["batch"] * world / window_s,
               "peak_mem_gib": peak / harness.GIB, "setup_s": setup_s}
        for m in harness.end_to_end(man, cell):
            values[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    busy = [r["busy_s"] for r in every]
    return harness.result(correct, calls, failed, values, device, peak, trace, readings, compared,
                          count=world, busy_s=None if None in busy else sum(busy) / len(busy))


# Planted faults, by name (``harness.run(..., fault=...)``): each wraps the
# port's ``make_train_step``.


def half_batch(make_step):
    """The step on the first half of each rank's rows only, its losses the
    mean over that half (the global batch's draws cut to the same rows)."""
    def make(config, optimizer, scheduler):
        step = make_step(config, optimizer, scheduler)

        def half(trainable, frozen, batch, generator, draws=None):
            n = batch["images"].shape[0]
            k, world = n // 2, draws["rpn"][0].shape[0] // n
            rows = torch.cat([torch.arange(r * n, r * n + k) for r in range(world)])
            rows = rows.to(batch["images"].device)
            cut = {"images": batch["images"][:k], "image_sizes": batch["image_sizes"][:k],
                   "original_sizes": batch["original_sizes"][:k],
                   "targets": {name: v[:k] for name, v in batch["targets"].items()}}
            return step(trainable, frozen, cut, generator,
                        draws={name: tuple(d[rows] for d in v) for name, v in draws.items()})
        return half
    return make


def unchanged(make_step):
    """The step computes its losses and leaves the state as it was."""
    from snn_automotive_object_detection_tpu_torch.utils.weights import tree_leaves

    def make(config, optimizer, scheduler):
        step = make_step(config, optimizer, scheduler)

        def same(trainable, frozen, batch, generator, draws=None):
            keep = [leaf.detach().clone() for leaf in tree_leaves(trainable)]
            out = step(trainable, frozen, batch, generator, draws=draws)
            with torch.no_grad():
                for leaf, k in zip(tree_leaves(trainable), keep):
                    leaf.copy_(k)
            return out
        return same
    return make


def no_exchange(make_step):
    """The exchange of gradients between the ranks left out: each rank
    updates with the gradient of its own rows."""
    from snn_automotive_object_detection_tpu_torch.train import steps

    def make(config, optimizer, scheduler):
        step = make_step(config, optimizer, scheduler)

        def alone(*args, **kwargs):
            keep = steps.sum_grads_over_ranks
            steps.sum_grads_over_ranks = lambda leaves: None
            try:
                return step(*args, **kwargs)
            finally:
                steps.sum_grads_over_ranks = keep
        return alone
    return make


FAULTS = {"half_batch": half_batch, "unchanged": unchanged, "no_exchange": no_exchange}
