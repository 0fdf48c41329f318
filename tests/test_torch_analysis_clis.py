"""The port's analysis CLIs against the JAX package's, on the CPU.

``snn_automotive_object_detection_tpu_torch/cli``: the noise sweeps, new-object
discovery, the energy recompute and tradeoff matrix, the noise plots, and
``ops/anchors.fpn_feature_shapes``. The sweeps run on the mini COCO set of
tests/mini_dataset.py with ``--device cpu`` at the 64 x 128 bucket, from a
checkpoint that the port's training CLI writes once per module: one epoch
with ``--no-amp`` (bf16 neuron states), whose RPN head is the bf16-state
training route (K1's and K7's bf16-state instances, as plain versions on
the CPU).

  * The gaussian and the rain sweep write the JAX CLI's rows,
    [noise_type, intensity, mAP, mAP@.5, mAR@100], to the JAX CLI's file
    names, after each point; the JAX CLI's own gaussian sweep on the same
    set and flags gives rows of the same types, noise name and intensities.
  * ``discover`` gives the JAX ``discover``'s output exactly on a seeded
    synthetic dump; NOD's ``main`` on the port's own ``-ext-prop-det`` dump
    writes ``params.txt`` and its panels.
  * The energy recompute from a rates ``.npz`` prints the JAX CLI's report
    line for line; ``tradeoff_matrix`` is the JAX one's; ``-p`` and
    ``noise_plots`` write their files; ``fpn_feature_shapes`` is the JAX
    helper's.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snn_automotive_object_detection_tpu_torch.cli import energy_efficiency_plot as t_ep
from snn_automotive_object_detection_tpu_torch.cli import new_object_discovery as t_nod
from snn_automotive_object_detection_tpu_torch.cli import noise_calculations as t_noise
from snn_automotive_object_detection_tpu_torch.cli import noise_plots as t_npl
from snn_automotive_object_detection_tpu_torch.cli import train as t_cli
from snn_automotive_object_detection_tpu_torch.ops.anchors import fpn_feature_shapes

from tests.mini_dataset import make_mini_env


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs these files in parallel
    workers, where more threads a process only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mini_env(tmp_path_factory):
    tmp, ds_yaml, model_yaml = make_mini_env(tmp_path_factory.mktemp("mini"))
    return pathlib.Path(tmp), ds_yaml, model_yaml


def _argv(mini_env, out, *extra):
    _, ds_yaml, model_yaml = mini_env
    return ["-d", ds_yaml, "--model-config", model_yaml, "--rpn-snn", "--detector-snn",
            "-t-rpn", "2", "-t-det", "2", "-b", "2", "-j", "1", "--out-dir", str(out), *extra]


@pytest.fixture(scope="module")
def trained(mini_env, tmp_path_factory):
    """The weights of one ``--no-amp`` epoch of the port's training CLI."""
    out = tmp_path_factory.mktemp("train")
    t_cli.main(t_cli.get_args_parser().parse_args(_argv(
        mini_env, out, "--epochs", "1", "--opt", "SGD", "--lr", "0.01", "--no-amp",
        "--device", "cpu")))
    return out / "model_cityscapes_1.pth"


def _row_types(rows):
    return [[type(v).__name__ if i != 1 else "number" for i, v in enumerate(r)] for r in rows]


@pytest.mark.parametrize("rain", [False, True])
def test_noise_sweep_rows(mini_env, trained, tmp_path, rain):
    extra = (["--rain-noise", "--rain-max", "50", "--rain-step", "50"] if rain
             else ["--gaussian-max", "0.05", "--gaussian-step", "0.05"])
    argv = _argv(mini_env, tmp_path, "--load-model", str(trained), "--no-amp", "--device",
                 "cpu", "--save-name", "SNN", *extra)
    rows = t_noise.main(t_noise.get_args_parser().parse_args(argv))
    name = "rain" if rain else "gaussian"
    assert [r[:2] for r in rows] == [[name, 0], [name, 50]] if rain else \
        [[name, 0.0], [name, 0.05]]
    assert _row_types(rows) == [["str", "number", "float", "float", "float"]] * 2
    assert all(0 <= v <= 1 for r in rows for v in r[2:])
    path = tmp_path / f"{'rain_noise_acc' if rain else 'noise_acc'}_SNN.json"
    assert json.loads(path.read_text()) == rows


def test_noise_sweep_rows_as_the_jax_cli_writes_them(mini_env, trained, tmp_path):
    from cli import noise_calculations as j_noise

    extra = ["--gaussian-max", "0.05", "--gaussian-step", "0.05", "--fp32"]
    j_noise.main(j_noise.get_args_parser().parse_args(_argv(mini_env, tmp_path / "jax",
                                                             *extra)))
    rows = t_noise.main(t_noise.get_args_parser().parse_args(
        _argv(mini_env, tmp_path / "port", "--device", "cpu", *extra)))
    want = json.loads((tmp_path / "jax" / "noise_acc.json").read_text())
    assert json.loads((tmp_path / "port" / "noise_acc.json").read_text()) == rows
    assert [r[:2] for r in rows] == [r[:2] for r in want]
    assert _row_types(rows) == _row_types(want)


def _synthetic_dump(seed=0, n_images=4):
    """Per-image dumps in the ``-ext-prop-det`` layout: known and background
    boxes over a 2048 x 1024 image (some inside the ego-vehicle region),
    proposals with objectness."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        n, p = int(rng.integers(6, 30)), int(rng.integers(20, 80))

        def boxes(k):
            xy = rng.uniform([0, 0], [1900, 950], (k, 2))
            return np.concatenate([xy, xy + rng.uniform(10, 300, (k, 2))], 1)

        out.append({"image_id": i + 1, "boxes": boxes(n), "labels": rng.integers(0, 3, n),
                    "scores": rng.uniform(0, 1, n), "all_scores": np.zeros((4, 3)),
                    "all_boxes": np.zeros((4, 3, 4)), "proposals": boxes(p),
                    "objectness": rng.uniform(0, 1, p)})
    return out


@pytest.mark.parametrize("dataset,max_det", [("cityscapes", 0), ("bdd", 3)])
def test_discover_equals_the_jax_discover(dataset, max_det):
    from cli import new_object_discovery as j_nod

    dump = _synthetic_dump(seed=len(dataset))
    got = t_nod.discover(dump, dataset, 0.05, 0.5, max_det)
    want = j_nod.discover(dump, dataset, 0.05, 0.5, max_det)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["image_id"] == w["image_id"]
        for k in ("new_boxes", "new_object_scores"):
            np.testing.assert_array_equal(g[k], w[k])
        for k in ("boxes", "labels", "scores"):
            np.testing.assert_array_equal(g["known"][k], w["known"][k])
    assert sum(len(g["new_boxes"]) for g in got) > 0


def test_nod_main_on_the_port_dump(mini_env, trained, tmp_path):
    tmp, ds_yaml, _ = mini_env
    t_cli.main(t_cli.get_args_parser().parse_args(_argv(
        mini_env, tmp_path, "--load-model", str(trained), "--no-amp", "--device", "cpu",
        "-ext-prop-det", "test", "-n-img", "4")))
    dump = tmp_path / "test_results_per_img_cityscapes.npz"
    processed = t_nod.main(t_nod.get_args_parser().parse_args(
        ["-d", ds_yaml, "-f", str(dump), "-s", "2", "-sc", "0.0"]))
    assert [p["image_id"] for p in processed] == [1, 2, 3, 4]
    out = tmp / "out" / "new_objects_cityscapes"
    assert "save_images = 2" in (out / "params.txt").read_text()
    assert len(list(out.glob("nod_*.png"))) == 2


@pytest.fixture
def rates_npz(tmp_path):
    rng = np.random.default_rng(2)
    path = tmp_path / "rates.npz"
    np.savez(path, shared=rng.uniform(0, 0.1, (5, 4)), fc6=rng.uniform(0, 0.05, 80),
             fc7=rng.uniform(0, 0.05, 80))
    return path


def test_energy_recompute_prints_the_jax_report(rates_npz, capsys):
    from cli import energy_efficiency_plot as j_ep

    argv = ["-f", str(rates_npz), "-t-rpn", "8", "-t-det", "12", "--bucket", "768", "1536"]
    j_ep.main(j_ep.get_args_parser().parse_args(argv))
    want = capsys.readouterr().out
    report = t_ep.main(t_ep.get_args_parser().parse_args(argv))
    got = capsys.readouterr().out
    assert got == want and "Total energy consumption" in got and "FC7" in got
    assert 0 < report["reduction"] < 1


def test_tradeoff_matrix_and_plots(tmp_path):
    from cli import energy_efficiency_plot as j_ep

    eff = [[r, d, 0.1 + 0.05 * (r + d) + 0.01 * (r * d % 3)] for r in (4, 5, 6) for d in (8, 9)]
    perf = [[r, d, 0.2, 0.4 + 0.01 * (r + d) - 0.02 * (d % 2), 0.5] for r in (4, 5, 6)
            for d in (8, 9)]
    got, want = t_ep.tradeoff_matrix(eff, perf, 1.0, 0.5), j_ep.tradeoff_matrix(eff, perf, 1.0, 0.5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[0].shape == (3, 2)
    for name, rows in (("eff", eff), ("perf", perf)):
        (tmp_path / f"{name}.json").write_text(json.dumps(rows))
    t_ep.main(t_ep.get_args_parser().parse_args(
        ["-p", "--efficiency-json", str(tmp_path / "eff.json"), "--metrics-json",
         str(tmp_path / "perf.json"), "-o", str(tmp_path / "tradeoff.pdf")]))
    assert (tmp_path / "tradeoff.pdf").stat().st_size > 0
    ga, ra = tmp_path / "g.json", tmp_path / "r.json"
    ga.write_text(json.dumps([["gaussian", 0.0, 0.3, 0.5, 0.4],
                              ["gaussian", 0.01, 0.2, 0.4, 0.35]]))
    ra.write_text(json.dumps([["rain", 0, 0.3, 0.5, 0.4], ["rain", 50, 0.25, 0.45, 0.37]]))
    t_npl.main(t_npl.get_args_parser().parse_args(
        ["--gaussian", f"SNN={ga}", "--rain", f"SNN={ra}", "-o", str(tmp_path / "noise.png")]))
    assert (tmp_path / "noise.png").stat().st_size > 0
    x, rel = t_npl.relative_drop(json.loads(ga.read_text()))
    assert x == [0.0, 0.01] and rel.tolist() == [100.0, 80.0]


@pytest.mark.parametrize("size,levels", [((768, 1536), 5), ((64, 128), 5), ((100, 150), 3)])
def test_fpn_feature_shapes_equal_the_jax_helper(size, levels):
    from snn_automotive_object_detection_tpu.ops.anchors import fpn_feature_shapes as j_shapes

    assert fpn_feature_shapes(size, levels) == j_shapes(size, levels)
