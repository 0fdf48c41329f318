"""The port's own configs and its last tools against the JAX package's, on
the CPU.

  * The named dataset configs and the model config are the port's own JSON
    files: loaded with PyYAML blocked, each equals the JAX loader's dict of
    the YAML file of that name (integer class ids included), and neither
    ``CONFIG_DIR`` nor the COCO matcher's source lies outside the port.
  * ``tools/ablate_bf16.py``: the five variants both tools run map to the
    JAX tool's dtypes (compute, neuron states, backbone); the JAX tool's two
    kernels-off names are refused; ``fp32`` and ``state32`` run once at
    the 64 x 128 bucket and print the JAX tool's JSON lines.
  * ``tools/parity_vs_reference.py`` on the mini COCO set with a reference
    ``.pth`` (``tools/torch_mirror.py``'s detector, as
    tests/test_parity_harness.py drives the JAX harness): its stats are the
    port CLI's own ``--test-only`` stats, its rates the ``.npz`` means, and
    its fp32 column is the JAX harness's (``--skip-bf16``): the stats within
    5e-2 each (random weights give mAP 0 on both, so the rates carry this
    check) and the 7 rate means within ``RATE_GAP_FP32``, which lies between
    the float32 ulps that flip a few spikes of the spiking heads
    (tests/test_torch_cli.py) and the gap of the port's own bf16 column, so
    that a harness that ran bf16 for fp32 fails; the fp32 runs carry
    ``--fp32`` and the bf16 runs do not.
  * ``scripts/chain_recipe.sh`` parses (``bash -n``), and its commands are
    the JAX recipe's with the port's modules in place of the root tools.
"""

import builtins
import json
import os
import pathlib
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snn_automotive_object_detection_tpu.utils import config as j_config
from snn_automotive_object_detection_tpu_torch.cli import train as t_cli
from snn_automotive_object_detection_tpu_torch.evaluation import _native
from snn_automotive_object_detection_tpu_torch.tools import ablate_bf16 as t_ablate
from snn_automotive_object_detection_tpu_torch.tools import make_bench_weights as mbw
from snn_automotive_object_detection_tpu_torch.tools import parity_vs_reference as t_pvr
from snn_automotive_object_detection_tpu_torch.utils import checkpoint, config

from chip_smoke import apply_mirror_gains
from tests.mini_dataset import make_mini_env
from tests.test_torch_checkpoint import _mirror_sd
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "snn_automotive_object_detection_tpu_torch"
# On the mini set the port's fp32 rate means lie at most 4.96e-5 from the
# JAX harness's (float32 ulps flip a few spikes) and its bf16 means 7.82e-4
# from its fp32 ones (both read on the CPU): the limit lies between the two.
RATE_GAP_FP32 = 2e-4


def test_configs_are_the_ports_own_and_need_no_yaml(monkeypatch):
    real_import = builtins.__import__

    def no_yaml(name, *args, **kw):
        if name == "yaml":
            raise ImportError("yaml is blocked")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    names = ("cityscapes", "bdd", "idd", "pascal", "coco")
    got = {n: config.load_dataset_config(n, data_root="/data") for n in names}
    model = config.load_model_yaml()
    monkeypatch.undo()
    for n in names:
        assert got[n] == j_config.load_dataset_config(n, data_root="/data"), n
    assert model == j_config.load_model_yaml()
    assert got["cityscapes"]["classes"][3] == "car"
    assert pathlib.Path(config.CONFIG_DIR).resolve() == PKG / "configs"
    assert pathlib.Path(_native._SRC).resolve() == PKG / "csrc" / "coco_eval.cpp"
    assert (PKG / "csrc" / "coco_eval.cpp").read_bytes() == (ROOT / "csrc" / "coco_eval.cpp").read_bytes()


def test_ablation_variants_match_the_jax_tool():
    import jax.numpy as jnp

    from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
    from tools import ablate_bf16 as j_ablate

    def name(dt):
        return None if dt is None else str(jnp.dtype(dt)) if not isinstance(
            dt, torch.dtype) else str(dt).replace("torch.", "")

    jbase, tbase = JConfig(num_classes=9), t_ablate.DetectorConfig(num_classes=9)
    for v in t_ablate.VARIANTS:
        jc, jbb = j_ablate.make_variant_config(jbase, v)
        tc, tbb = t_ablate.make_variant_config(tbase, v)
        want = (name(jc.compute_dtype), name(jc.snn_state_dtype or jc.compute_dtype), name(jbb))
        got = (name(tc.compute_dtype), name(tc.state_dtype), name(tbb))
        assert got == want, v
    for v in ("bf16_xla", "state32_xla"):
        j_ablate.make_variant_config(jbase, v)   # the JAX tool runs them
        with pytest.raises(ValueError, match="kernels off"):
            t_ablate.make_variant_config(tbase, v)


def test_ablation_runs_fp32_and_state32(tmp_path, capsys):
    cfg = mbw.bench_config(min_size=64, max_size=128, t_rpn=2, t_det=2)
    params = mbw.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    pth = tmp_path / "w.pth"
    checkpoint.save_checkpoint(str(pth), {"params": params})
    out = tmp_path / "ablation.jsonl"
    args = t_ablate.get_args_parser().parse_args(
        ["--load", str(pth), "--images", "2", "--variants", "fp32,state32", "--out", str(out),
         "--device", "cpu"])
    lines = t_ablate.main(args, base=cfg)
    assert sorted(lines) == ["fp32", "state32"]
    written = [json.loads(x) for x in out.read_text().splitlines()]
    assert written == [json.loads(json.dumps(lines[v])) for v in ("fp32", "state32")]
    for line in written:
        assert sorted(line) == ["AP50", "AP75", "images", "mAP", "per_class", "variant", "wall_s"]
        assert line["images"] == 2 and len(line["per_class"]) == 5
    assert "deltas vs fp32 mAP:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="kernels off"):
        t_ablate.main(t_ablate.get_args_parser().parse_args(
            ["--load", str(pth), "--variants", "fp32,bf16_xla", "--device", "cpu"]), base=cfg)


def test_parity_harness_on_the_mini_set(tmp_path, capsys, monkeypatch):
    from tools import parity_vs_reference as j_pvr

    _, ds_yaml, model_yaml = make_mini_env(tmp_path)
    ckpt = tmp_path / "mirror.pth"
    # The card's gains, so that every spiking layer fires (fc7 from the
    # fourth step on).
    torch.save({"model": apply_mirror_gains(_mirror_sd("resnet50", num_classes=4))}, str(ckpt))
    common = [str(ckpt), "-d", ds_yaml, "--model-config", model_yaml, "-t-rpn", "2",
              "-t-det", "4", "-b", "2", "-j", "1"]
    args = t_pvr.get_args_parser().parse_args(
        common + ["--device", "cpu", "--out-dir", str(tmp_path / "port")])
    real_main, runs = t_cli.main, []

    def recording_main(cli_args):
        runs.append(cli_args)
        return real_main(cli_args)

    monkeypatch.setattr(t_cli, "main", recording_main)
    stats, rates = t_pvr.main(args)
    monkeypatch.undo()
    out = capsys.readouterr().out
    assert "PARITY REPORT" in out and "bf16-vs-fp32 mAP delta" in out
    assert sorted(stats) == sorted(rates) == ["bf16", "fp32"]
    assert all(s.shape == (12,) and np.isfinite(s).all() for s in stats.values())
    assert all(len(r) == 7 for r in rates.values())
    # fp32 runs first with --fp32, bf16 without it; each the stats, then the rates.
    assert [(a.fp32, a.test_only, a.extract_spike_rates) for a in runs] == [
        (True, True, []), (True, False, ["test"]), (False, True, []), (False, False, ["test"])]
    # The rates are the last run's .npz means (bf16 ran last).
    npz = tmp_path / "port" / "spike_rates_test_cityscapes.npz"
    assert rates["bf16"] == t_pvr.rates_from_npz(str(npz))
    # The stats are the CLI's own fp32 run, its flags written out here.
    own = real_main(t_cli.get_args_parser().parse_args(
        ["-d", ds_yaml, "--model-config", model_yaml, "--rpn-snn", "--detector-snn",
         "--load-model", str(ckpt), "-t-rpn", "2", "-t-det", "4", "-b", "2", "-j", "1",
         "--device", "cpu", "--out-dir", str(tmp_path / "own"), "--test-only", "--fp32"]))
    np.testing.assert_array_equal(stats["fp32"], own)

    jstats, jrates = j_pvr.main(j_pvr.get_args_parser().parse_args(
        common + ["--skip-bf16", "--out-dir", str(tmp_path / "jax")]))
    jax_gap = np.abs(np.subtract(rates["fp32"], jrates["fp32"])).max()
    bf16_gap = np.abs(np.subtract(rates["bf16"], rates["fp32"])).max()
    print(f"fp32 stats: port {np.round(stats['fp32'], 4).tolist()}, "
          f"jax {np.round(jstats['fp32'], 4).tolist()}; rates: port {rates['fp32']}, "
          f"jax {jrates['fp32']}, bf16 {rates['bf16']}; fp32 port-vs-jax rate gap "
          f"{jax_gap:.3g}, port bf16-vs-fp32 {bf16_gap:.3g}")
    np.testing.assert_allclose(stats["fp32"], jstats["fp32"], rtol=0, atol=5e-2)
    assert min(jrates["fp32"]) > 0
    # The fp32 column is the JAX harness's to the ulps that flip a few
    # spikes, and the bf16 column is further off: a harness that ran bf16
    # for its fp32 column fails.
    assert jax_gap <= RATE_GAP_FP32 < bf16_gap


def _commands(path):
    """The python commands of a recipe script: (module or tool, its flags)."""
    text = path.read_text().replace("\\\n", " ")
    cmds = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words and words[0] in ('"${MBW[@]}"', "${MBW[@]}"):
            words = ["python", "-m", "snn_automotive_object_detection_tpu_torch.tools."
                     "make_bench_weights"] + words[1:]
        if words[:1] == ["python"]:
            cmds.append(words)
    return cmds


def _normalised(words):
    """(tool name, {flag: value}) with the phases' files named by their stem
    (``X_p1`` for a directory ``X_p1`` of the JAX recipe or a file
    ``X_p1.pth`` of the port's) and the kernels-off ablation variant left
    out."""
    tool = words[2].rsplit(".", 1)[-1] if words[1] == "-m" else pathlib.Path(words[1]).stem
    flags, rest = {}, words[3:] if words[1] == "-m" else words[2:]
    i = 0
    while i < len(rest):
        key = rest[i]
        val = rest[i + 1] if i + 1 < len(rest) and not rest[i + 1].startswith("--") else None
        i += 1 if val is None else 2
        if key in ("--out", "--load") and val and val.endswith(".pth"):
            val = val[:-4]
        if key == "--variants":
            val = ",".join(v for v in val.split(",") if not v.endswith("_xla"))
        flags[key] = val
    return tool, flags


def test_chain_recipe_is_the_jax_recipe():
    port = PKG / "scripts" / "chain_recipe.sh"
    subprocess.run(["bash", "-n", str(port)], check=True)
    mine = [_normalised(w) for w in _commands(port)]
    theirs = [_normalised(w) for w in _commands(ROOT / "tools" / "chain_recipe.sh")]
    assert [t for t, _ in mine] == [t for t, _ in theirs] == [
        "make_bench_weights"] * 4 + ["ablate_bf16"]
    for (_, a), (_, b) in zip(mine, theirs):
        for flags in (a, b):   # the default output names differ only in their stem
            for k in ("--out", "--load"):
                if k in flags and flags[k]:
                    flags[k] = flags[k].replace("${OUT}", "OUT").replace("$OUT", "OUT")
        assert a == b
    assert "--second-recipe" in port.read_text()
