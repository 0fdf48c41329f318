"""The port's host side imports on a machine with torch and numpy only.

The H100 machine has PyTorch, numpy and scipy but no JAX, OpenCV, PyYAML,
Pillow or Matplotlib. In a subprocess where importing any of those fails,
the port's data, evaluation, checkpoint, logging, config, energy and
plotting modules, its anchors, its CLIs (training, T sweep, noise
sweeps, new-object discovery, energy and noise plots), its data
parallelism (``parallel/``) and its tools (the synthetic shape set, the
bench-weight trainer, the numerics ablation and the parity harness) must
import, and none of them may bring in the JAX
package. The training CLI also runs there, ``--test-only`` on
the CPU, on a COCO-format set whose configs are JSON and whose images are
``.npy`` files, as ``chip_smoke.py`` gives it on the card's machine.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "cv2", "yaml", "PIL", "matplotlib")
MODULES = ("data", "data.coco", "data.idd", "data.loader", "data.registry", "data.smoke",
           "data.transforms", "evaluation", "evaluation.coco_metrics",
           "evaluation.evaluator", "evaluation._native", "utils.checkpoint",
           "utils.logging", "utils.config", "utils.energy", "utils.plotting",
           "utils.parallel", "models.transform", "ops.anchors", "cli.train",
           "cli.test_and_energy_eff", "cli.noise_calculations", "cli.new_object_discovery",
           "cli.energy_efficiency_plot", "cli.noise_plots", "parallel", "parallel.mesh",
           "parallel.collectives", "parallel.dryrun", "tools", "tools.synth_shapes",
           "tools.make_bench_weights", "tools.ablate_bf16", "tools.parity_vs_reference")

BLOCK = f"""
import importlib, importlib.abc, sys

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError(f"{{name}} is not installed here")
        return None

sys.meta_path.insert(0, Blocker())
"""

SCRIPT = BLOCK + f"""
for m in {MODULES!r}:
    importlib.import_module("snn_automotive_object_detection_tpu_torch." + m)
jax_pkg = [m for m in sys.modules
           if m.split(".")[0] in ("snn_automotive_object_detection_tpu",) + {BLOCKED!r}]
assert not jax_pkg, jax_pkg
print("imported", len({MODULES!r}))
"""


def test_host_modules_import_without_jax_cv2_yaml_pil_matplotlib():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"imported {len(MODULES)}" in out.stdout


def test_cli_runs_without_jax_cv2_yaml_pil_matplotlib(tmp_path):
    import json

    import numpy as np

    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in (1, 2):
        np.save(tmp_path / f"{i}.npy", rng.integers(0, 256, (128, 256, 3), dtype=np.uint8))
        images.append({"id": i, "file_name": f"{i}.npy", "height": 128, "width": 256})
        anns.append({"id": i, "image_id": i, "bbox": [20.0, 10.0, 60.0, 40.0],
                     "category_id": 1, "area": 2400.0, "iscrowd": 0})
    (tmp_path / "ann.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": [{"id": 1, "name": "c1"}]}))
    (tmp_path / "ds.json").write_text(json.dumps(
        {"dataset": "cityscapes", "images_dir": str(tmp_path),
         "ann_file_train": str(tmp_path / "ann.json"), "ann_file_val": str(tmp_path / "ann.json"),
         "out_dir": str(tmp_path / "out"), "num_classes": 2,
         "classes": {"0": "background", "1": "c1"}}))
    (tmp_path / "model.json").write_text(json.dumps(
        {"transform": {"min_size": 64, "max_size": 128},
         "RPN": {"rpn_pre_nms_top_n_test": 32, "rpn_post_nms_top_n_test": 16}}))
    argv = ["-d", str(tmp_path / "ds.json"), "--model-config", str(tmp_path / "model.json"),
            "--rpn-snn", "--detector-snn", "-t-rpn", "2", "-t-det", "2", "-j", "1",
            "--device", "cpu", "--test-only"]
    script = BLOCK + f"""
from snn_automotive_object_detection_tpu_torch.cli import train
stats = train.main(train.get_args_parser().parse_args({argv!r}))
assert stats.shape == (12,)
print("stats", len(stats))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "stats 12" in out.stdout
