"""The harness on the CPU: cells, configurations, mixes and metrics found by
name; no run without a card; no JAX; and the comparison failing the control
and every planted fault of an evaluation cell, at 64 x 128."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_cuda import harness, weights
from bench_cuda.reference import model as ref

REPO = harness.REPO
SMALL = {"config": {"min_size": 64, "max_size": 128,
                    "rpn": {"pre_nms_top_n_test": 50, "post_nms_top_n_test": 30}},
         "mix": {"batch": 2, "distinct_batches": 2, "warmup_calls": 1, "traced_batches": 4}}
CELLS = ("r50_eval_b8", "mnv3_eval_b16")


def _run(cell, seed=11, **kw):
    return harness.run(cell, seed, 0.0, False, 0.0, device="cpu", overrides=SMALL, **kw)


def test_every_entry_has_its_files():
    man = harness.manifest()
    names = [c["name"] for c in man["configs"]]
    for c in man["configs"]:
        assert (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["source"] == c["source"]
    for w in man["workloads"]:
        assert w["config"] in names
        harness.cell_files(man, w["name"])
        for m in harness.per_layer(man, w["name"]):
            assert callable(harness.reader(m["name"]).read)
        assert {m["name"] for m in harness.end_to_end(man, w["name"])} >= {"setup_s"}
    assert all(harness.per_layer(man, w["name"]) for w in man["workloads"])


def test_new_files_are_found_without_editing_others(tmp_path):
    """A cell, a configuration, a mix and a metric added to a copy as new
    files and entries: the copy's harness finds them all by name."""
    shutil.copytree(REPO / "bench_cuda", tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    b = tmp_path / "bench_cuda"
    cfg = json.loads((b / "configs" / "r50_snn_t8_t12.json").read_text())
    (b / "configs" / "r50_snn_t8_t16.json").write_text(json.dumps({**cfg, "t_det": 16}))
    mix = json.loads((b / "traffic" / "eval_b8.json").read_text())
    (b / "traffic" / "eval_b4.json").write_text(json.dumps({**mix, "batch": 4}))
    (b / "limits" / "r50_t16_eval_b4.json").write_text(
        (b / "limits" / "r50_eval_b8.json").read_text())
    (b / "metrics" / "copies_ms.eval.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx.trace.seconds(('memcpy',)) / ctx.batches\n")
    man["configs"].append({"name": "r50_snn_t8_t16", "source": cfg["source"],
                           "file": "bench_cuda/configs/r50_snn_t8_t16.json",
                           "reduced": [], "why": "a longer box head"})
    man["workloads"].append({"name": "r50_t16_eval_b4", "config": "r50_snn_t8_t16",
                             "traffic": "eval_b4", "chips": 1, "why": "batch 4"})
    man["per_layer"].append({"name": "copies_ms.eval", "unit": "ms", "better": "lower",
                             "source": "device_trace", "layer": "device",
                             "moves": "eval_images_per_s", "workloads": ["r50_t16_eval_b4"]})
    for m in man["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("r50_t16_eval_b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    probe = (
        "from bench_cuda import harness\n"
        "man = harness.manifest()\n"
        "w, cfg, mix, lim = harness.cell_files(man, 'r50_t16_eval_b4')\n"
        "assert cfg['t_det'] == 16 and mix['batch'] == 4 and 'features' in lim\n"
        "names = [m['name'] for m in harness.per_layer(man, 'r50_t16_eval_b4')]\n"
        "assert 'copies_ms.eval' in names, names\n"
        "assert harness.reader('copies_ms.eval').read\n"
        "print('found')\n")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{REPO}"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "found", out.stderr


@pytest.mark.parametrize("kind,key", [("traffic", "pixels"), ("configs", "weights.kind"),
                                      ("traffic", "optimizer.betas")])
def test_a_key_nothing_reads_is_refused(kind, key, monkeypatch):
    """A data file that sets a key no code reads fails the run rather than
    leaving a later change to believe it changed the traffic or the model."""
    data = harness._data

    def patched(k, name):
        d = data(k, name)
        if k == kind:
            outer, _, inner = key.partition(".")
            if inner:
                d[outer] = {**d[outer], inner: 1}
            else:
                d[outer] = 1
        return d
    monkeypatch.setattr(harness, "_data", patched)
    cell = "r50_train_frozen_b16" if "optimizer" in key else "r50_eval_b8"
    with pytest.raises(harness.RunError, match=key.rpartition(".")[2]):
        harness.cell_files(harness.manifest(), cell)


def test_an_evaluation_cell_on_more_cards_is_refused():
    """Only training runs on ranks: an evaluation cell on four cards must not
    time one card under its name."""
    man = harness.manifest()
    man["workloads"] = [dict(w, chips=4) for w in man["workloads"]]
    with pytest.raises(harness.RunError, match="4 cards"):
        harness.run("r50_eval_b8", 1, 0.0, False, 0.0, device="cpu", man=man, overrides=SMALL)


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "bench_cuda", "--workload", "r50_eval_b8",
                          "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_loads_no_jax():
    """A CPU run in a fresh process loads none of the banned modules, and
    a run that finds one loaded gives no result."""
    probe = (
        "import sys, types\n"
        "from bench_cuda import harness\n"
        f"ov = {SMALL!r}\n"
        "harness.run('r50_eval_b8', 3, 0.0, False, 0.0, device='cpu', overrides=ov)\n"
        "assert harness.banned_modules() == [], harness.banned_modules()\n"
        "sys.modules['jax'] = types.ModuleType('jax')\n"
        "try:\n"
        "    harness.run('r50_eval_b8', 3, 0.0, False, 0.0, device='cpu', overrides=ov)\n"
        "except harness.RunError as e:\n"
        "    print('refused', e)\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("refused") and "jax" in out.stdout


def _limits_above(readings, factor=1.5):
    """Limits just above a sound run's readings at this size (the cells'
    own are set at the cells' sizes)."""
    return {k: (0.0 if k == "detections" else factor * v + 1e-9) for k, v in readings.items()}


def _faulty(kind):
    """The port's entry with a planted fault in what it returns."""
    from snn_automotive_object_detection_tpu_torch.models.detector import detector_apply

    def entry(params, batch, config):
        out, losses = detector_apply(params, batch, config)
        out = dict(out)
        n = out["scores"].shape[0]
        if kind == "half_batch":
            # Half of the batch left out: its rows copied from the other half.
            for k in ("objectness", "proposals", "all_scores", "all_boxes", "boxes", "scores",
                      "labels", "valid"):
                out[k] = torch.cat([out[k][: n // 2]] * 2)
        elif kind == "answer":
            # One answer altered where it is produced: one detection's score.
            out["scores"] = out["scores"].clone()
            out["scores"][0, 0] += 0.25
        return out, losses
    return entry


@pytest.mark.parametrize("cell", CELLS)
def test_faults_and_control_are_not_correct(cell, monkeypatch):
    sound = _run(cell)
    limits = _limits_above(sound["readings"])
    monkeypatch.setattr(harness, "_data", _with_limits(limits))
    assert _run(cell)["correct"]
    for kind in ("half_batch", "answer"):
        assert not _run(cell, entry=_faulty(kind))["correct"], kind
    # The control: the reference in the precision below the configuration's.
    _, cfg, _, _ = harness.cell_files(harness.manifest(), cell, SMALL)
    sd = weights.make_state_dict(cfg, 11, "cpu")

    def control(params, batch, pcfg):
        return ref.forward(sd, cfg, batch["images"], ref.CONTROL), {}

    def control_levels(params, images, pcfg):
        return [f.permute(0, 2, 3, 1)
                for f in ref.backbone_features(sd, cfg, images, ref.CONTROL)]

    got = _run(cell, entry=control, features=control_levels)
    assert not got["correct"]
    assert got["readings"]["features"] > 3 * sound["readings"]["features"]


def _with_limits(limits):
    data = harness._data

    def patched(kind, name):
        return dict(limits) if kind == "limits" else data(kind, name)
    return patched


@pytest.mark.cuda
def test_a_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "bench_cuda", "--workload", "r50_eval_b8",
                          "--seed", "2147483701", "--seconds", "2", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "compared"


TRAIN_SMALL = {"config": {"min_size": 64, "max_size": 128,
                          "rpn": {"pre_nms_top_n_train": 60, "post_nms_top_n_train": 40},
                          "roi": {"batch_size_per_image": 32}},
               "mix": {"batch": 2, "distinct_batches": 4, "max_boxes": 4, "traced_batches": 2}}


@pytest.mark.parametrize("cell", ["r50_train_frozen_b16", "r50_train_frozen_b16_dp4"])
def test_training_faults_are_not_correct(cell, monkeypatch):
    """Each fault the cell can have, planted under a run that skips only the
    look for a card, comes out not correct: the state left unchanged, half
    of the batch left out and, on four ranks (gloo, four processes), the
    exchange of gradients between them left out."""
    def run(**kw):
        return harness.run(cell, 13, 0.0, False, 0.0, device="cpu", overrides=TRAIN_SMALL, **kw)

    sound = run()
    assert sound["correct"] and sound["failed"] == 0 and sound["attempted"] >= 1
    limits = {k: 1.5 * sound["readings"][k] + 1e-9 for k in ("loss", "first_gradient", "change")}
    monkeypatch.setattr(harness, "_data", _with_limits(limits))
    assert run()["correct"]
    unchanged = run(fault="unchanged")
    assert not unchanged["correct"] and unchanged["readings"]["change"] == pytest.approx(1.0)
    assert not run(fault="half_batch")["correct"]
    if harness.workload(harness.manifest(), cell)["chips"] > 1:
        assert sound["device"]["count"] == 4
        alone = run(fault="no_exchange")
        assert not alone["correct"] and alone["readings"]["first_gradient"] > 0.5
