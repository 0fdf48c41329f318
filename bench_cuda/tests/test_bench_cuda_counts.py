"""The yardstick's counts: K1's least time as ``chip_smoke.py`` counts it,
and the dense FLOPs of a batch."""

import json
import subprocess
import sys

import pytest

from bench_cuda import flops, harness, roofline

LEVELS = [(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)]


@pytest.mark.parametrize("enc", [0.0, 1.0e8, 1.0561e8, 3.0e8])
def test_rpn_head_bound_is_chip_smokes(enc):
    """The same shapes and encoder spike count as chip_smoke's K1 check
    (batch 2, T 8, 256 channels, 15 readout channels): its bound is set by
    the operations, which both count alike."""
    # In a process of its own: a run refuses to finish where chip_smoke is loaded.
    probe = (
        "import json, chip_smoke\n"
        f"levels, enc = {LEVELS!r}, {enc!r}\n"
        "neurons = sum(2 * h * w * 256 for h, w in levels) * 8\n"
        "ops = 2.0 * enc * 9 * 256 + sum(2.0 * 2 * h * w * 256 * 15 for h, w in levels)\n"
        "print(json.dumps(chip_smoke._bound(0.0, ops, 10.0 * neurons)['bound_ms']))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=harness.REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    theirs = json.loads(out.stdout)
    ours = 1e3 * roofline.rpn_head_bound_s(LEVELS, 2, 256, 8, 15, enc)
    assert ours == pytest.approx(theirs, rel=1e-12)


def test_rpn_head_bound_of_the_kernel_table():
    """0.5536 ms, K1's bound at batch 2 in PERF.md's kernel table, comes
    from an encoder firing about 1.056e8 times on chip_smoke's levels."""
    assert 1e3 * roofline.rpn_head_bound_s(LEVELS, 2, 256, 8, 15, 1.0561e8) == \
        pytest.approx(0.5536, abs=5e-5)


def test_dense_flops_of_a_flagship_batch():
    """3.19 TFLOP a flagship evaluation batch of 2 (PERF.md, PR 16), 12.75
    at batch 8 and 0.75 a MobileNet batch of 2."""
    man = harness.manifest()
    r50 = harness.cell_files(man, "r50_eval_b8")[1]
    mnv3 = harness.cell_files(man, "mnv3_eval_b16")[1]
    assert flops.eval_batch(r50, 2)["total"] / 1e12 == pytest.approx(3.19, abs=0.005)
    assert flops.eval_batch(r50, 8)["total"] / 1e12 == pytest.approx(12.75, abs=0.01)
    assert flops.eval_batch(mnv3, 2)["total"] / 1e12 == pytest.approx(0.75, abs=0.005)


def test_dense_flops_of_a_frozen_training_step():
    """A frozen step of 16: the backbone once (5.21 TFLOP), the RPN head's
    3x3 conv and fc6 twice (no gradient into their frozen inputs), the
    readouts and fc7 three times; 40.86 TFLOP in all."""
    cfg = harness.cell_files(harness.manifest(), "r50_train_frozen_b16")[1]
    ev, tr = flops.eval_batch(cfg, 16), flops.train_step(cfg, 16)
    conv3 = sum(flops.conv(h, w, 3, 256, 256) for h, w in flops.level_shapes(cfg)) * 8 * 16
    assert tr["backbone_fpn"] == ev["backbone_fpn"]
    assert tr["rpn_head"] == 3 * ev["rpn_head"] - conv3
    fc6 = 2 * 512 * 16 * 12 * 256 * 49 * 1024
    box = 2 * 512 * 16 * 12 * (256 * 49 * 1024 + 1024 * 1024 + 1024 * 45)
    assert tr["box_head"] == 3 * box - fc6
    assert tr["total"] / 1e12 == pytest.approx(40.86, abs=0.005)
