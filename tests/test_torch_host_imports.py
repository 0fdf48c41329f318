"""The port's host side imports on a machine with torch and numpy only.

The H100 machine has PyTorch, numpy and scipy but no JAX, OpenCV, PyYAML,
Pillow or Matplotlib. In a subprocess where importing any of those fails,
the port's data, evaluation, checkpoint, logging, config, energy and
plotting modules must import, and none of them may bring in the JAX
package.
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
           "utils.parallel", "models.transform")

SCRIPT = f"""
import importlib, importlib.abc, sys

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError(f"{{name}} is not installed here")
        return None

sys.meta_path.insert(0, Blocker())
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
