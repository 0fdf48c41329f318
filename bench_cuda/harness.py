"""One run of one cell: set-up, the measured window, the comparison with the
reference and the result line.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names a configuration (``configs/<config>.json``) and a
traffic mix (``traffic/<traffic>.json``); its limits are
``limits/<cell>.json``; each per-layer metric is a reader
``metrics/<metric>.py``. A new cell, configuration, mix or metric is new
files and entries.

A run of an evaluation cell, as ``python -m bench_cuda`` drives it (a
training cell's traffic has ``"mode": "train"``, and ``train.py`` runs it;
a training cell may ask for more than one card, and then runs one rank a
card, ``ranks.py``; an evaluation cell runs on one card):

  1. set-up: the port's kernels from its build cache in the checkout, the
     state dict drawn from ``--seed`` (``weights.py``) and loaded through the
     port's ``utils/checkpoint.convert_torch_state_dict``, the mix's batches
     drawn on the device, then ``warmup_calls`` calls of the entry;
  2. the window: with ``--trace 0`` the entry called on the batches in turn
     until ``--seconds`` have passed, a CUDA event recorded after each
     batch, ended by a synchronise; with ``--trace 1`` the mix's
     ``traced_batches`` under the profiler;
  3. after the window: the modules loaded are checked (no JAX, no JAX
     package), the peak memory read, the program's FPN levels of the judged
     batches computed, its state freed, and one cycle of the window's
     batches, chosen by the seed, judged (``judge.py``) against the
     reference on the same inputs and weights. The window's outputs of that
     cycle are judged as the timed call returned them; the FPN levels are
     not among them, and come from a second pass of the program after the
     window (``models/detector.backbone_features``, the function
     ``detector_apply`` calls), since keeping the window's would add them
     to the peak memory. The ``features`` number reads that second pass;
     the window's own backbone is judged through its ``objectness``, which
     the reference computes from the second pass's levels;
  4. the line: ``correct``, ``attempted`` and ``failed`` batches, the
     metrics, the device, with ``--trace 1`` the breakdown, and last the
     numbers compared with their limits.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
CACHE = ROOT / "_cache"
# Whole top-level module names that may not be loaded in a run.
BANNED = ("jax", "jaxlib", "flax", "snn_automotive_object_detection_tpu", "bench_torch",
          "chip_smoke")
GIB = 2.0 ** 30
# The keys a file may set, each read by the program or the reference (or,
# for "why", "source", "architecture", "reduced" and "assumed", prose): a
# key outside these does nothing, and a file that sets one is refused.
PROSE = {"why", "source", "architecture", "reduced", "assumed"}
CONFIG_KEYS = PROSE | {
    "backbone", "num_classes", "rpn_snn", "detector_snn", "t_rpn", "t_det", "min_size",
    "max_size", "compute_dtype", "snn_state_dtype", "image_mean", "image_std", "fpn_channels",
    "representation_size", "anchor_sizes", "aspect_ratios", "rpn", "roi", "weights"}
WEIGHTS_KEYS = {"fpn_out_gain"}
MIX_KEYS = {"eval": PROSE | {"mode", "batch", "distinct_batches", "warmup_calls",
                            "traced_batches"},
            "train": PROSE | {"mode", "batch", "distinct_batches", "min_boxes", "max_boxes",
                             "optimizer", "traced_batches"}}
OPTIMIZER_KEYS = {"lr", "weight_decay"}


class RunError(RuntimeError):
    """A run that cannot give a result."""


def manifest(path: Optional[Path] = None) -> Dict[str, Any]:
    return json.loads((path or REPO / "BENCHMARK.json").read_text())


def _unread(what: str, keys, known) -> None:
    extra = sorted(set(keys) - set(known))
    if extra:
        raise RunError(f"{what}: {extra} would change nothing; the harness reads only "
                       f"{sorted(known)}")


def _data(kind: str, name: str) -> Dict[str, Any]:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise RunError(f"no {kind} file {path.relative_to(REPO)}")
    return json.loads(path.read_text())


def workload(man: Dict, name: str) -> Dict[str, Any]:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise RunError(f"no workload {name!r} in BENCHMARK.json")


def _reported(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def end_to_end(man: Dict, cell: str) -> List[Dict]:
    return [m for m in man["end_to_end"] if _reported(m, cell)]


def per_layer(man: Dict, cell: str) -> List[Dict]:
    moved = {m["name"] for m in end_to_end(man, cell)}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str):
    """The module ``metrics/<name>.py``: ``read(ctx)`` gives the metric's
    value, or None where the traced window holds nothing to read."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no reader {path.relative_to(REPO)} for the metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"bench_cuda.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


@dataclasses.dataclass
class Context:
    """What a metric reader reads: the traced window, the configuration,
    the images a batch or step (a card's), the batches or steps traced, in
    evaluation the encoder spikes a batch of the judged images, and on more
    than one card the seconds of the gradients' all-reduce alone."""
    trace: Any
    cfg: Dict[str, Any]
    batch: int
    batches: int
    enc_spikes_per_batch: Optional[float] = None
    allreduce_alone_s: Optional[float] = None


def port_config(cfg: Dict[str, Any]):
    """The port's ``DetectorConfig`` of a configuration file."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
    from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
    from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig

    roi = dict(cfg["roi"], bbox_reg_weights=tuple(cfg["roi"]["bbox_reg_weights"]))
    return DetectorConfig(
        num_classes=cfg["num_classes"], backbone=cfg["backbone"], rpn_snn=cfg["rpn_snn"],
        detector_snn=cfg["detector_snn"], t_rpn=cfg["t_rpn"], t_det=cfg["t_det"],
        image_mean=tuple(cfg["image_mean"]), image_std=tuple(cfg["image_std"]),
        min_size=cfg["min_size"], max_size=cfg["max_size"], rpn=RPNConfig(**cfg["rpn"]),
        roi=RoIConfig(**roi), compute_dtype=getattr(torch, cfg["compute_dtype"]),
        snn_state_dtype=(None if cfg["snn_state_dtype"] is None
                         else getattr(torch, cfg["snn_state_dtype"])),
        fpn_channels=cfg["fpn_channels"], representation_size=cfg["representation_size"])


def input_seed(seed: int) -> int:
    """The inputs' stream, apart from the weights' (``seed``)."""
    return (seed + 0x9E3779B97F4A7C15) % 2 ** 64


def eval_batches(mix: Dict, cfg: Dict, seed: int, device) -> List[Dict]:
    """The mix's distinct batches: ``batch`` frames of the bucket, pixels
    uniform in [0, 1), drawn on the device; the original size is the
    bucket's, so that the program's boxes come back in the bucket's
    coordinates."""
    import torch

    g = torch.Generator(device=device).manual_seed(input_seed(seed))
    h, w = cfg["min_size"], cfg["max_size"]
    n = mix["batch"]
    sizes = torch.tensor([[h, w]] * n, dtype=torch.int64, device=device)
    return [{"images": torch.rand((n, h, w, 3), generator=g, device=device),
             "image_sizes": sizes, "original_sizes": sizes}
            for _ in range(mix["distinct_batches"])]


def cell_files(man: Dict, cell: str, overrides: Optional[Dict] = None):
    """(entry, configuration, mix, limits) of a cell, with ``overrides``
    ({"config": {...}, "mix": {...}}) merged over the files: the CPU tests
    run the cells at a small bucket with them."""
    w = workload(man, cell)
    cfg = _data("configs", w["config"])
    mix = _data("traffic", w["traffic"])
    lim = _data("limits", cell)
    overrides = overrides or {}
    for key, val in overrides.get("config", {}).items():
        cfg[key] = {**cfg[key], **val} if isinstance(val, dict) else val
    mix.update(overrides.get("mix", {}))
    _unread(f"configs/{w['config']}.json", cfg, CONFIG_KEYS)
    _unread(f"configs/{w['config']}.json weights", cfg["weights"], WEIGHTS_KEYS)
    if mix.get("mode") not in MIX_KEYS:
        raise RunError(f"traffic {w['traffic']!r}: mode {mix.get('mode')!r} has no runner")
    _unread(f"traffic/{w['traffic']}.json", mix, MIX_KEYS[mix["mode"]])
    if mix["mode"] == "train":
        _unread(f"traffic/{w['traffic']}.json optimizer", mix["optimizer"], OPTIMIZER_KEYS)
    cfg["bucket"] = (cfg["min_size"], cfg["max_size"])
    return w, cfg, mix, lim


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _p95(xs: List[float]) -> float:
    return statistics.quantiles(xs, n=100, method="inclusive")[94]


def run(cell: str, seed: int, seconds: float, traced: bool, t_start: float, device=None,
        man: Optional[Dict] = None, overrides: Optional[Dict] = None,
        entry=None, features=None, fault: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """One run of ``cell``; returns the result line as a dict, "compared"
    last (None on a rank other than 0). ``device`` None is the CUDA device,
    which must be there; the CPU tests pass "cpu" and small ``overrides``.
    In evaluation ``entry`` replaces the port's ``detector_apply`` and
    ``features(params, images, config)`` its ``backbone_features`` (the
    control, the tests' planted faults); in training ``fault`` names one of
    ``train.FAULTS``. A cell on W > 1 cards is a training cell: this
    process is rank 0 and starts the others (``ranks.py``)."""
    # Build caches at fixed places inside the checkout, whatever the
    # environment names (the port's own kernels build into its ``_build/``).
    CACHE.mkdir(exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch

    man = man or manifest()
    w, cfg, mix, limits = cell_files(man, cell, overrides)
    world = w["chips"]
    if world > 1 and mix["mode"] != "train":
        raise RunError(f"{cell} asks for {world} cards; an evaluation cell runs on one")
    rank = int(os.environ.get("RANK", "0")) if world > 1 else 0
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < world:
            raise RunError(f"{cell} needs {world} CUDA device(s); "
                           f"{torch.cuda.device_count()} here")
        device = torch.device("cuda", rank)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)

    from snn_automotive_object_detection_tpu_torch.models.detector import (
        backbone_features,
        detector_apply,
    )
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
        convert_torch_state_dict,
    )

    from bench_cuda import judge, profile, weights

    if mix["mode"] == "train":
        from bench_cuda import ranks, train

        def go():
            return train.run(cell, seed, seconds, traced, t_start, device, man, cfg, mix, limits,
                             fault, world)

        if world == 1 or rank > 0:
            return go()
        if on_card:
            cuda_build.build_all()      # once, before the other ranks look for the kernels
        args = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                "--trace", str(int(traced)), "--device", device.type,
                "--overrides", json.dumps(overrides or {})] + (["--fault", fault] if fault else [])
        with ranks.group_of(world, args, REPO):
            return go()
    apply = entry or detector_apply

    def levels(params, images, config):
        with torch.inference_mode():
            return backbone_features(params, images, config, False)

    features = features or levels
    if on_card:
        cuda_build.build_all()
    pcfg = port_config(cfg)
    sd = weights.make_state_dict(cfg, seed, device)
    params = convert_torch_state_dict(sd, cfg["rpn_snn"], cfg["detector_snn"], device=device)
    del sd
    batches = eval_batches(mix, cfg, seed, device)
    n_distinct = len(batches)

    def warm():
        # The window's own work, its check of the scores included, so that
        # no kernel's module is first loaded inside the window.
        for i in range(mix["warmup_calls"]):
            out = apply(params, batches[i % n_distinct], pcfg)[0]
            (~torch.isfinite(out["scores"]).all()).long().item()

    warm()
    if on_card:
        torch.cuda.synchronize(device)

    judged_cycle = seed % 2
    kept: Dict[int, Dict] = {}
    bad = torch.zeros((), dtype=torch.int64, device=device)    # batches with non-finite scores
    marks: List[Any] = []

    def mark():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    def call(i):
        out = apply(params, batches[i % n_distinct], pcfg)[0]
        bad.add_((~torch.isfinite(out["scores"]).all()).long())
        mark()
        if i // n_distinct == judged_cycle:
            kept[i % n_distinct] = out

    trace = None
    t_begin = time.perf_counter()
    setup_s = t_begin - t_start
    if traced:
        n_traced = max(mix["traced_batches"], n_distinct * (judged_cycle + 1))

        def window():
            for i in range(n_traced):
                call(i)

        if on_card:
            trace = profile.trace(warm, window, device)
        else:
            window()
        calls = n_traced
    else:
        mark()
        calls = 0
        while (calls < n_distinct * (judged_cycle + 1)
               or time.perf_counter() - t_begin < seconds):
            call(calls)
            calls += 1
        if on_card:
            torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t_begin
    failed = int(bad)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if not traced:
        if on_card:
            batch_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            batch_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    found = banned_modules()
    if found:
        raise RunError(f"modules loaded that a run may not load: {found}")

    # The program's own state at the step the reference follows it from:
    # the FPN levels of the judged batches.
    feats = [features(params, batches[j]["images"], pcfg) for j in range(n_distinct)]
    del params, marks
    if on_card:
        torch.cuda.empty_cache()
    sd = weights.make_state_dict(cfg, seed, device)
    jd = judge.EvalJudge(sd, cfg)
    for j in range(n_distinct):
        jd.add(batches[j]["images"], kept[j], feats[j])
        feats[j] = None
    readings = jd.readings()
    compared = judge.held(readings, limits)
    correct = failed == 0 and judge.within(compared)

    values = {}
    if traced:
        ctx = Context(trace=trace, cfg=cfg, batch=mix["batch"], batches=calls,
                      enc_spikes_per_batch=sum(jd.enc_spikes) / len(jd.enc_spikes))
        for m in per_layer(man, cell):
            v = reader(m["name"]).read(ctx) if trace is not None else None
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"eval_images_per_s": calls * mix["batch"] / window_s,
               "eval_batch_ms_p95": _p95(batch_ms),
               "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for m in end_to_end(man, cell):
            values[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    line = result(correct, calls, failed, values, device, peak, trace, readings, compared)
    if not traced:
        line["batch_ms_samples"] = len(batch_ms)
        line["compared"] = line.pop("compared")
    return line


def result(correct, calls, failed, values, device, peak, trace, readings, compared, count=1,
           busy_s=None):
    """The result line: the contract's keys, every reading of the comparison,
    and last the numbers compared with their limits. ``peak`` is the fullest
    card's; ``busy_s``, the mean over the cards, defaults to the trace's."""
    import torch

    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": count, "memory_peak_bytes": peak}
    if on_card:
        dev["power"] = _power_limit()
    line = {"correct": correct, "attempted": calls, "failed": failed, "metrics": values,
            "device": dev}
    if trace is not None:
        dev.update(busy_s=trace.busy_s if busy_s is None else busy_s, window_s=trace.window_s)
        line["breakdown"] = {"device_ops": [[n, s] for n, s in trace.top_ops],
                             "idle_gaps": [[n, s] for n, s in trace.idle_gaps]}
    line["readings"] = readings
    line["compared"] = compared
    return line
