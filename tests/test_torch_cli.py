"""The port's CLIs (``snn_automotive_object_detection_tpu_torch/cli``) on the
mini COCO set of tests/mini_dataset.py, on the CPU (``--device cpu``), at
the 64 x 128 bucket with two steps per head.

  * ``--test-only`` gives the 12 COCO stats and writes ``hyperparams.txt``
    and, with ``--profile``, a trace; so do ``--no-amp`` (bf16 neuron
    states), the ANN heads (neither ``--rpn-snn`` nor ``--detector-snn``)
    and ``--load-model`` of a reference ``.pth``.
  * One epoch (in ``--fp32``, the scans under autograd: the bf16 training
    route's plain kernel versions are tests/test_torch_rpn_train.py's)
    writes ``model_<name>_1.pth`` (weights) and ``checkpoint.pth``
    (the whole state); ``--resume`` from it runs epoch 2 from the saved
    optimizer state and leaves ``model_<name>_2.pth``, which
    ``--load-model`` reads back.
  * ``-ext-prop-det`` writes the new-object-discovery dump in the JAX
    CLI's ``.npz`` layout; ``--extract-spike-rates`` the rates; the T sweep
    one row per (t_rpn, t_det).
  * The dump against the JAX CLI's on one reference ``.pth`` (the
    reference's detector as ``tools/torch_mirror.py`` builds it, with an
    ANN RPN head, tests/test_checkpoint.py's keys) in ``--fp32``: the
    backbones of the two libraries differ by float32 ulps, which the ANN
    RPN head passes on at that scale, so the proposals and objectness agree
    within 1e-4 relative (+1e-4) and 1e-3 (+5e-2 pixels) after sorting, and
    the spiking box head's outputs, whose encoder turns ulps into a few
    flipped spikes, within the borderline rule of tests/test_torch_ann_heads.py:
    at least 90% of the detections matched and at most 5% of the pre-NMS
    class scores and boxes outside tolerance.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snn_automotive_object_detection_tpu_torch.cli import test_and_energy_eff as t_sweep
from snn_automotive_object_detection_tpu_torch.cli import train as t_cli

from tests.mini_dataset import make_mini_env
from tests.test_checkpoint import _ann_head_state_dict
from tests.test_torch_checkpoint import _mirror_sd
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def mini_env(tmp_path_factory):
    tmp, ds_yaml, model_yaml = make_mini_env(tmp_path_factory.mktemp("mini"))
    return pathlib.Path(tmp), ds_yaml, model_yaml


def _argv(mini_env, out, *extra, snn=True):
    _, ds_yaml, model_yaml = mini_env
    heads = ["--rpn-snn", "--detector-snn"] if snn else []
    return ["-d", ds_yaml, "--model-config", model_yaml, *heads, "-t-rpn", "2",
            "-t-det", "2", "-b", "2", "-j", "1", "--device", "cpu", "--out-dir", str(out),
            *extra]


def _run(mini_env, out, *extra, snn=True):
    return t_cli.main(t_cli.get_args_parser().parse_args(_argv(mini_env, out, *extra, snn=snn)))


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference checkpoint: the mirror detector for the mini set's 4
    classes, with an ANN RPN head."""
    sd = {k: v for k, v in _mirror_sd("resnet50", num_classes=4).items()
          if not k.startswith("rpn.head")}
    sd.update({k: v for k, v in _ann_head_state_dict().items() if k.startswith("rpn.head")})
    path = tmp_path_factory.mktemp("pth") / "reference.pth"
    torch.save({"model": sd}, path)
    return path


@pytest.mark.parametrize("extra,snn", [((), True), (("--no-amp",), True), (("--fp32",), True),
                                       ((), False)])
def test_cli_test_only(mini_env, tmp_path, capsys, extra, snn):
    stats = _run(mini_env, tmp_path, "--test-only", "--profile", str(tmp_path / "prof"), *extra,
                 snn=snn)
    assert stats.shape == (12,) and np.isfinite(stats).all()
    assert "Time spent generating detections" in capsys.readouterr().out
    hyper = (tmp_path / "hyperparams.txt").read_text()
    assert "box_predictor" in hyper if not snn else "box_head" in hyper
    assert (tmp_path / "prof" / "trace.json").exists()


def test_cli_train_resume_and_load_model(mini_env, tmp_path):
    _run(mini_env, tmp_path, "--epochs", "1", "--opt", "SGD", "--lr", "0.01", "--fp32")
    for name in ("model_cityscapes_1.pth", "checkpoint.pth"):
        assert (tmp_path / name).exists(), name
    state = torch.load(tmp_path / "checkpoint.pth", weights_only=True)
    assert state["epoch"] == 1 and state["optimizer"]["state"]
    weights = torch.load(tmp_path / "model_cityscapes_1.pth", weights_only=True)
    assert sorted(weights) == ["args", "params"] and weights["args"]["epochs"] == 1
    _run(mini_env, tmp_path, "--epochs", "2", "--opt", "SGD", "--lr", "0.01", "--fp32",
         "--resume", str(tmp_path / "checkpoint.pth"))
    assert torch.load(tmp_path / "checkpoint.pth", weights_only=True)["epoch"] == 2
    second = torch.load(tmp_path / "model_cityscapes_2.pth", weights_only=True)["params"]
    moved = [not torch.equal(a, b) for a, b in zip(
        weights["params"]["rpn_head"]["shared_conv"].values(),
        second["rpn_head"]["shared_conv"].values())]
    assert all(moved)
    stats = _run(mini_env, tmp_path / "eval", "--test-only", "--fp32", "--load-model",
                 str(tmp_path / "model_cityscapes_2.pth"))
    assert stats.shape == (12,)
    with pytest.raises(NotImplementedError):
        _run(mini_env, tmp_path, "--resume", str(tmp_path / "checkpoint.pth"), "--load-model",
             str(tmp_path / "model_cityscapes_2.pth"))


def test_cli_load_reference_pth(mini_env, tmp_path, reference_pth):
    stats = _run(mini_env, tmp_path, "--test-only", "--detector-snn", "--load-model",
                 str(reference_pth), snn=False)
    assert stats.shape == (12,)


@pytest.mark.parametrize("snn", [True, False])
def test_cli_extract_prop_det_and_rates(mini_env, tmp_path, snn):
    _run(mini_env, tmp_path, "-ext-prop-det", "test", "-n-img", "3", snn=snn)
    data = list(np.load(tmp_path / "test_results_per_img_cityscapes.npz",
                        allow_pickle=True)["results"])
    assert len(data) == 3
    keys = {"image_id", "boxes", "labels", "scores", "proposals", "objectness"}
    assert set(data[0]) == (keys | {"all_scores", "all_boxes"} if snn else keys)
    if snn:
        _run(mini_env, tmp_path, "--extract-spike-rates", "val")
        rates = np.load(tmp_path / "spike_rates_val_cityscapes.npz")
        assert sorted(rates.files) == ["fc6", "fc7", "shared"]
        assert rates["shared"].shape == (5, 4)


def test_cli_plot_images(mini_env, tmp_path):
    _run(mini_env, tmp_path, "--plot-images", "--max-plot-images", "2")
    assert len(list((tmp_path / "pred_images").glob("*.png"))) >= 2


@pytest.mark.parametrize("option", ["metrics", "efficiency"])
def test_cli_t_sweep(mini_env, tmp_path, option):
    argv = _argv(mini_env, tmp_path, "-o", option, "-r1", "2", "-r2", "2", "-d1", "2",
                 "-d2", "3")
    rows = t_sweep.main(t_sweep.get_args_parser().parse_args(argv))
    assert [r[:2] for r in rows] == [[2, 2], [2, 3]]
    assert len(rows[0]) == (5 if option == "metrics" else 3)
    assert json.loads((tmp_path / f"sweep_{option}.json").read_text()) == rows


def _sorted_level_rows(objectness, proposals):
    order = np.argsort(-objectness, kind="stable")
    return objectness[order], proposals[order]


def test_cli_dump_matches_the_jax_cli(mini_env, tmp_path, reference_pth):
    from cli import train as j_cli

    common = ["-ext-prop-det", "test", "-n-img", "4", "--fp32", "--detector-snn",
              "--load-model", str(reference_pth)]
    _run(mini_env, tmp_path / "port", *common, snn=False)
    _, ds_yaml, model_yaml = mini_env
    j_cli.main(j_cli.get_args_parser().parse_args(
        ["-d", ds_yaml, "--model-config", model_yaml, "-t-rpn", "2", "-t-det", "2", "-b", "2",
         "-j", "1", "--out-dir", str(tmp_path / "jax"), *common]))
    name = "test_results_per_img_cityscapes.npz"
    port = list(np.load(tmp_path / "port" / name, allow_pickle=True)["results"])
    jax_ = list(np.load(tmp_path / "jax" / name, allow_pickle=True)["results"])
    assert [d["image_id"] for d in port] == [d["image_id"] for d in jax_]
    hits = n_want = n_got = bad = total = 0
    for p, j in zip(port, jax_):
        assert set(p) == set(j)
        for k in ("proposals", "objectness", "all_scores", "all_boxes"):
            assert p[k].shape == j[k].shape, k
        po, pp = _sorted_level_rows(p["objectness"], p["proposals"])
        jo, jp = _sorted_level_rows(j["objectness"], j["proposals"])
        np.testing.assert_allclose(po, jo, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(pp, jp, rtol=1e-3, atol=5e-2)
        for k, rtol, atol in (("all_scores", 1e-4, 1e-5), ("all_boxes", 1e-3, 5e-2)):
            bad += int((np.abs(p[k] - j[k]) > atol + rtol * np.abs(j[k])).sum())
            total += j[k].size
        used = np.zeros(len(p["scores"]), bool)
        for box, score, label in zip(j["boxes"], j["scores"], j["labels"]):
            ok = ((p["labels"] == label) & ~used & (np.abs(p["scores"] - score) <= 1e-4)
                  & (np.abs(p["boxes"] - box) <= 5e-2 + 1e-3 * np.abs(box)).all(axis=1))
            if ok.any():
                used[np.argmax(ok)] = True
                hits += 1
        n_want, n_got = n_want + len(j["scores"]), n_got + len(p["scores"])
    print(f"dump: {hits} of {n_want} JAX / {n_got} port detections matched; {bad} of "
          f"{total} pre-NMS class scores and boxes outside tolerance")
    assert n_want > 0 and hits >= 0.9 * max(n_want, n_got)
    assert bad <= 0.05 * total
