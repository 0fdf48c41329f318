"""The port's data parallelism: two gloo processes on the CPU.

Each test spawns two ranks of one process group that run this module
(``python -m tests.test_torch_distributed <mode> <dir>``, through
``parallel/dryrun.run_ranks``, which kills them and fails after 300 s);
the ranks import torch and the port only, never JAX. The parent computes
whatever JAX gives and hands it over in ``.npz`` files.

  * ``basics``: ``all_gather_objects`` of unequal payloads, the logger's
    global average (1.0 and 2.0 give 1.5), the loader's shard of 5 items
    (equal step counts), a rank-0 checkpoint read by both ranks right
    after the save's barrier (the cases of tests/distributed_worker.py).
  * ``steps``: tests/test_torch_train_step.py's setup (its weights, batch
    and the JAX sampler's draws, the JAX backbone's features shared), one
    float32 SGD step on 2 ranks of 1 image each against the JAX
    ``make_train_step`` loss on both images: losses 1e-5 relative,
    gradients within 1e-4 of their largest element, parameters after the
    step within that file's bound; the two ranks' losses, gradients and
    updated leaves bit-equal. Then a batch whose images sample different
    counts (every RoI slot kept: 512 slots for 100 proposals and the
    ground truth), with the generator's draws, against one process on both
    images: losses within 1e-6 relative, gradients within 1e-5 of their
    largest element; the classifier's mean of per-image means misses that
    tolerance (by 18 times on these inputs).
  * ``evalcli``: ``cli/train.py --test-only`` on 2 ranks of ``-b 1`` gives
    exactly the 12 stats of one process at ``-b 1`` (tests/test_distributed.py).
  * ``dryrun_multiprocess(2)``: the counterpart of ``dryrun_multichip``.

Two repairs for ranks on several cards, in one process: every kernel
wrapper launches through ``utils/cuda_build.launch``, which enters
``torch.cuda.device`` of its tensors' card around the C call (checked with
``torch.cuda.device`` and the stream lookup replaced, and by the wrappers'
sources), and ``build_all`` moves each compiler log into place from a file
of its own process, as it moves each library.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu_torch.parallel.dryrun import (
    dryrun_multiprocess,
    run_ranks,
)
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)

MODULE = "tests.test_torch_distributed"
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")
COUNTS_ROI_SLOTS = 512
COUNTS_SEED = 5


def _spawn(mode, tmp):
    outs = run_ranks(MODULE, 2, [mode, str(tmp)])
    for rank, out in enumerate(outs):
        assert f"[rank {rank}] ALL OK" in out, out
    return outs


# ------------------------------------------------------------------ ranks


def _rank_basics(tmp, rank):
    from snn_automotive_object_detection_tpu_torch.data.loader import DetectionLoader
    from snn_automotive_object_detection_tpu_torch.parallel.collectives import (
        all_gather_objects,
        parallel_world,
    )
    from snn_automotive_object_detection_tpu_torch.parallel.mesh import is_main_process
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        load_checkpoint_args,
        save_checkpoint,
    )
    from snn_automotive_object_detection_tpu_torch.utils.logging import MetricLogger

    assert parallel_world() == (rank, 2) and is_main_process() == (rank == 0)
    got = all_gather_objects({"rank": rank, "payload": "x" * (10 + 100 * rank)})
    assert [g["rank"] for g in got] == [0, 1] and len(got[1]["payload"]) == 110, got

    logger = MetricLogger()
    logger.update(loss=float(rank + 1))
    logger.synchronize_between_processes()
    assert abs(logger.meters["loss"].global_avg - 1.5) < 1e-9

    class FiveImages:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            img = np.random.default_rng(i).uniform(0, 255, (64, 128, 3)).astype(np.uint8)
            return img, {"boxes": np.asarray([[4.0, 4.0, 60.0, 40.0]], np.float32),
                         "labels": np.asarray([1], np.int64), "image_id": i}

    loader = DetectionLoader(FiveImages(), batch_size=1, bucket=(64, 128), min_size=64,
                             max_size=128, num_workers=1, shard=(rank, 2))
    counts = all_gather_objects(len(list(loader)))
    assert counts[0] == counts[1] == len(loader) == 3, counts

    path = os.path.join(tmp, "ckpt.pth")
    save_checkpoint(path, {"epoch": 3, "params": {"w": torch.full((2,), float(rank))}},
                    args={"lr": 0.1})
    # The save returned on every rank after its barrier: rank 0's file is there.
    state = load_checkpoint(path)
    assert state["epoch"] == 3 and torch.equal(state["params"]["w"], torch.zeros(2))
    assert load_checkpoint_args(path)["lr"] == 0.1


def _config(spec, **roi):
    from snn_automotive_object_detection_tpu_torch.models.factory import DetectorConfig
    from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
    from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig

    h, w = spec["img"]
    return DetectorConfig(
        num_classes=spec["num_classes"], t_rpn=spec["t"], t_det=spec["t"], min_size=h,
        max_size=w, image_mean=tuple(spec["mean"]), image_std=tuple(spec["std"]),
        rpn=RPNConfig(**spec["rpn"]), roi=RoIConfig(**{**spec["roi"], **roi}),
        compute_dtype=torch.float32)


def _load_inputs(tmp):
    """(spec, flat params, features [2, ...] per level, batch, draws)."""
    spec = json.loads((tmp / "spec.json").read_text())
    z = np.load(tmp / "inputs.npz")
    flat = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
    feats = [torch.from_numpy(z[f"f/{i}"]) for i in range(spec["levels"])]
    batch = {k[2:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("b/")}
    draws = {"rpn": tuple(torch.from_numpy(z[f"d/rpn{i}"]) for i in range(2)),
             "roi": tuple(torch.from_numpy(z[f"d/roi{i}"]) for i in range(3))}
    return spec, flat, feats, batch, draws


def _batch_rows(batch, rows):
    targets = {k[2:]: v[rows] for k, v in batch.items() if k.startswith("t_")}
    out = {k: v[rows] for k, v in batch.items() if not k.startswith("t_")}
    out["targets"] = targets
    return out


def one_step(spec, flat, feats, batch, generator=None, draws=None, **roi):
    """One float32 SGD step of ``spec``'s detector on ``batch`` with the
    backbone's output replaced by ``feats``: (losses, flat gradients, flat
    updated trainable leaves), all as numpy."""
    from snn_automotive_object_detection_tpu_torch.models import detector as t_detector
    from snn_automotive_object_detection_tpu_torch.models.factory import init_params
    from snn_automotive_object_detection_tpu_torch.train import optim
    from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step
    from snn_automotive_object_detection_tpu_torch.utils.checkpoint import load_weights_lenient
    from snn_automotive_object_detection_tpu_torch.utils.weights import (
        flatten_tree,
        to_numpy_tree,
    )

    cfg = _config(spec, **roi)
    template = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert sorted(flatten_tree(template)) == sorted(flat)
    # Copies: the loaded leaves share the arrays' memory, and the step
    # updates them in place.
    params = load_weights_lenient(template, {k: np.array(v) for k, v in flat.items()},
                                  verbose=False)
    tt, tf = optim.split_trainable(params)
    opt, sched = optim.build_optimizer(tt, "SGD", spec["lr"], momentum=0.9, weight_decay=1e-4)
    real = t_detector.resnet50_fpn_apply
    t_detector.resnet50_fpn_apply = lambda *args: feats
    try:
        losses = make_train_step(cfg, opt, sched)(tt, tf, batch, generator, draws)
    finally:
        t_detector.resnet50_fpn_apply = real
    return ({k: float(v) for k, v in losses.items()},
            flatten_tree(to_numpy_tree(tt, grads=True)), flatten_tree(to_numpy_tree(tt)))


def _save_step(path, got):
    losses, grads, new = got
    np.savez(path, **{f"l/{k}": v for k, v in losses.items()},
             **{f"g/{k}": v for k, v in grads.items()}, **{f"n/{k}": v for k, v in new.items()})


def _rank_steps(tmp, rank):
    spec, flat, feats, batch, draws = _load_inputs(tmp)
    rows = slice(rank, rank + 1)
    mine = [f[rows] for f in feats]
    _save_step(tmp / f"jax_draws_rank{rank}.npz",
               one_step(spec, flat, mine, _batch_rows(batch, rows), draws=draws))
    _save_step(tmp / f"counts_rank{rank}.npz",
               one_step(spec, flat, mine, _batch_rows(batch, rows),
                        torch.Generator().manual_seed(COUNTS_SEED),
                        batch_size_per_image=COUNTS_ROI_SLOTS))


def _rank_evalcli(tmp, rank):
    from snn_automotive_object_detection_tpu_torch.cli import train as t_cli
    from snn_automotive_object_detection_tpu_torch.parallel.collectives import (
        all_gather_objects,
    )

    stats = np.asarray(t_cli.main(t_cli.get_args_parser().parse_args(_cli_argv(tmp))))
    both = all_gather_objects(stats)
    np.testing.assert_array_equal(both[0], both[1])
    np.save(tmp / f"stats_rank{rank}.npy", stats)


def _cli_argv(tmp):
    return ["-d", str(tmp / "mini.yaml"), "--model-config", str(tmp / "model.yaml"),
            "--rpn-snn", "--detector-snn", "-t-rpn", "2", "-t-det", "2", "-b", "1", "-j", "1",
            "--device", "cpu", "--test-only"]


def _rank_main(mode, tmp):
    from pathlib import Path

    from snn_automotive_object_detection_tpu_torch.parallel.collectives import parallel_world
    from snn_automotive_object_detection_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(2)
    assert init_distributed("cpu"), "no process group from the environment"
    rank, _ = parallel_world()
    {"basics": _rank_basics, "steps": _rank_steps, "evalcli": _rank_evalcli}[mode](
        Path(tmp), rank)
    torch.distributed.destroy_process_group()
    print(f"[rank {rank}] ALL OK")


# ------------------------------------------------------------------ tests


def test_collectives_logger_loader_and_checkpoint_on_two_ranks(tmp_path):
    _spawn("basics", tmp_path)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX step of tests/test_torch_train_step.py's setup, the inputs
    handed to the ranks, and what the ranks wrote."""
    import jax
    import jax.numpy as jnp
    import optax

    from snn_automotive_object_detection_tpu.models import detector as j_detector
    from snn_automotive_object_detection_tpu.models import resnet_fpn as j_resnet
    from snn_automotive_object_detection_tpu.models import transform as j_transform
    from snn_automotive_object_detection_tpu.models.detector import detector_apply as j_apply
    from snn_automotive_object_detection_tpu.models.factory import DetectorConfig as JConfig
    from snn_automotive_object_detection_tpu.models.roi_heads import RoIConfig as JRoI
    from snn_automotive_object_detection_tpu.models.rpn import RPNConfig as JRPN
    from snn_automotive_object_detection_tpu.train import optim as j_optim
    from snn_automotive_object_detection_tpu_torch.utils.weights import flatten_tree
    from tests import test_torch_train_step as ts
    from tests.test_torch_detector_e2e import MEAN, STD, T_STEPS, _scaled_params
    from tests.test_torch_train_losses import roi_draws, rpn_draws

    IMG = ts.IMG
    tmp = tmp_path_factory.mktemp("steps")
    spec = dict(t=T_STEPS, img=list(IMG), mean=MEAN, std=STD, num_classes=5, rpn=ts.RPN_KW,
                roi=ts.ROI_KW, lr=ts.LR, levels=5)
    jcfg = JConfig(rpn=JRPN(**ts.RPN_KW), roi=JRoI(**ts.ROI_KW), compute_dtype=jnp.float32,
                   num_classes=5, t_rpn=T_STEPS, t_det=T_STEPS, min_size=IMG[0],
                   max_size=IMG[1], image_mean=MEAN, image_std=STD)
    params, batch = _scaled_params(jcfg), ts._batch()
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jt, jf = j_optim.split_trainable(jparams)
    jfeats = jax.jit(lambda x: j_resnet.resnet50_fpn_apply(
        jparams["backbone"], j_transform.normalize_images(x, MEAN, STD), jnp.float32)
    )(jbatch["images"])
    key = jax.random.PRNGKey(11)

    def loss_fn(trainable):
        _, losses = j_apply(j_optim.merge_params(trainable, jf), jbatch, jcfg,
                            training=True, rng=key)
        return sum(losses.values()), losses

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_detector, "resnet50_fpn_apply", lambda *args, **kw: list(jfeats))
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jt)
    jopt = j_optim.build_optimizer("SGD", ts.LR, momentum=0.9, weight_decay=1e-4)
    updates, _ = jopt.update(jgrads, jopt.init(jt), jt)
    jnew = optax.apply_updates(jt, updates)
    key_rpn, key_roi = jax.random.split(key)
    n_anchors = sum((IMG[0] // s) * (IMG[1] // s) * 3 for s in (4, 8, 16, 32, 64))
    rpn = rpn_draws(key_rpn, ts.N_IMAGES, n_anchors)
    roi = roi_draws(key_roi, ts.N_IMAGES, ts.RPN_KW["post_nms_top_n_train"] + ts.N_GT)

    (tmp / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp / "inputs.npz", **{f"p/{k}": v for k, v in flatten_tree(params).items()},
             **{f"f/{i}": np.asarray(f) for i, f in enumerate(jfeats)},
             **{f"b/{k}": v for k, v in batch.items() if k != "targets"},
             **{f"b/t_{k}": v for k, v in batch["targets"].items()},
             **{f"d/rpn{i}": d for i, d in enumerate(rpn)},
             **{f"d/roi{i}": d for i, d in enumerate(roi)})
    _spawn("steps", tmp)

    def read(name):
        z = np.load(tmp / name)
        return ({k[2:]: float(z[k]) for k in z.files if k.startswith("l/")},
                {k[2:]: z[k] for k in z.files if k.startswith("g/")},
                {k[2:]: z[k] for k in z.files if k.startswith("n/")})

    return dict(tmp=tmp, lr=ts.LR, jlosses=jax.tree.map(float, jlosses),
                jgrads=flatten_tree(jax.tree.map(np.asarray, jgrads)),
                jnew=flatten_tree(jax.tree.map(np.asarray, jnew)),
                ranks=[read(f"jax_draws_rank{r}.npz") for r in range(2)],
                counts=[read(f"counts_rank{r}.npz") for r in range(2)])


@pytest.mark.parametrize("run", ["ranks", "counts"])
def test_ranks_are_bit_equal(steps, run):
    (l0, g0, n0), (l1, g1, n1) = steps[run]
    assert l0 == l1
    assert sorted(g0) == sorted(g1) == sorted(n0) == sorted(n1)
    for k in g0:
        assert np.array_equal(g0[k], g1[k]) and np.array_equal(n0[k], n1[k]), k


@pytest.mark.parametrize("name", LOSSES + ("loss_total",))
def test_two_ranks_give_the_jax_global_batch_losses(steps, name):
    got, want = steps["ranks"][0][0][name], steps["jlosses"].get(name)
    if want is None:
        want = sum(steps["jlosses"][k] for k in LOSSES)
    print(f"{name}: two ranks {got:.7f} jax {want:.7f}")
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("group", ["rpn_head", "box_head"])
def test_two_ranks_give_the_jax_gradients_and_update(steps, group):
    _, grads, new = steps["ranks"][0]
    keys = [k for k in steps["jgrads"] if k.startswith(group + "/")]
    assert keys
    for k in keys:
        want = steps["jgrads"][k]
        top, err = np.abs(want).max(), np.abs(grads[k] - want).max()
        print(f"{k}: max |grad| {top:.4g}, max |diff| {err:.3g}")
        assert top > 0 and err <= 1e-4 * top, k
        np.testing.assert_allclose(new[k], steps["jnew"][k], rtol=1e-6,
                                   atol=steps["lr"] * 1e-4 * top, err_msg=k)


def test_unequal_counts_are_summed_over_ranks(steps):
    """Images of unequal sampled counts: the ranks' losses are the global
    batch's (one process on both images), not the mean of per-image
    means."""
    from snn_automotive_object_detection_tpu_torch.models import rpn as t_rpn
    from snn_automotive_object_detection_tpu_torch.models import roi_heads as t_roi

    spec, flat, feats, batch, _ = _load_inputs(steps["tmp"])
    counts = []

    def record(t):
        counts.append(int(t))
        return t

    per_image = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_rpn, "sum_over_ranks", record)
        mp.setattr(t_roi, "sum_over_ranks", record)
        for i in range(2):
            rows = slice(i, i + 1)
            # One image alone, with its rows of the two-image draws.
            gen = torch.Generator().manual_seed(COUNTS_SEED)
            draws = _generator_draws(gen, spec, batch)
            per_image.append(one_step(spec, flat, [f[rows] for f in feats],
                                      _batch_rows(batch, rows),
                                      draws={k: tuple(d[rows] for d in v)
                                             for k, v in draws.items()},
                                      batch_size_per_image=COUNTS_ROI_SLOTS)[0])
    rpn_counts, roi_counts = counts[0::2], counts[1::2]
    print(f"sampled counts per image: RPN {rpn_counts}, RoI {roi_counts}")
    assert roi_counts[0] != roi_counts[1]

    whole = one_step(spec, flat, feats, _batch_rows(batch, slice(0, 2)),
                     torch.Generator().manual_seed(COUNTS_SEED),
                     batch_size_per_image=COUNTS_ROI_SLOTS)
    (got, grads, _), (want, want_grads, _) = steps["counts"][0], whole
    for k in LOSSES:
        mean_of_means = (per_image[0][k] + per_image[1][k]) / 2
        print(f"{k}: two ranks {got[k]:.7f}, one process {want[k]:.7f}, mean of per-image "
              f"means {mean_of_means:.7f}")
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    # The classifier's per-image losses and counts differ enough that the
    # mean of the per-image means misses the same tolerance.
    mean_of_means = (per_image[0]["loss_classifier"] + per_image[1]["loss_classifier"]) / 2
    assert mean_of_means != pytest.approx(want["loss_classifier"], rel=1e-6)
    for k, want_g in want_grads.items():
        top = np.abs(want_g).max()
        assert np.abs(grads[k] - want_g).max() <= 1e-5 * top, k


def _generator_draws(gen, spec, batch):
    """The draws the samplers take from ``gen`` for the two-image batch,
    in their order: RPN (rp, rn) over the anchors, RoI (rp, rn, r_pack)
    over the proposals and ground truth."""
    h, w = spec["img"]
    n_anchors = sum((h // s) * (w // s) * 3 for s in (4, 8, 16, 32, 64))
    k_roi = spec["rpn"]["post_nms_top_n_train"] + batch["t_valid"].shape[1]
    return {"rpn": tuple(torch.rand((2, n_anchors), generator=gen) for _ in range(2)),
            "roi": tuple(torch.rand((2, k_roi), generator=gen) for _ in range(3))}


def test_two_rank_test_only_gives_the_one_process_stats(tmp_path):
    from snn_automotive_object_detection_tpu_torch.cli import train as t_cli
    from tests.mini_dataset import make_mini_env

    make_mini_env(tmp_path)
    want = np.asarray(t_cli.main(t_cli.get_args_parser().parse_args(_cli_argv(tmp_path))))
    _spawn("evalcli", tmp_path)
    np.testing.assert_array_equal(np.load(tmp_path / "stats_rank0.npy"), want)
    assert want.shape == (12,) and np.isfinite(want).all()


def test_launch_enters_the_card_of_its_tensors(monkeypatch):
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    entered, calls = [], []

    class FakeDevice:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.append(None)

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(cb, "stream_ptr", lambda device: 1000 + device.index)
    card = torch.device("cuda", 1)

    def fn(*args):
        calls.append((args, list(entered)))
        return 0

    before = cb.LAUNCHES["stem"]
    cb.launch("stem", fn, [7, 8], card)
    assert calls == [((7, 8, 1001), [card])] and entered == [card, None]
    assert cb.LAUNCHES["stem"] == before + 1
    with pytest.raises(RuntimeError, match="failed to launch"):
        cb.launch("stem", lambda *args: 700, [], card)
    assert cb.LAUNCHES["stem"] == before + 1 and entered[-1] is None


def test_every_wrapper_launches_through_the_guard():
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    wrappers = []
    for path in sorted(cb.PKG_DIR.rglob("*.py")):
        if cb.BUILD_DIR in path.parents:   # build outputs, not the package
            continue
        text = path.read_text()
        if path.name == "cuda_build.py" or "cb.function(" not in text:
            continue
        wrappers.append(path.name)
        # The stream and the counter are cuda_build.launch's alone.
        assert "stream_ptr" not in text and "LAUNCHES[" not in text, path
        assert "cb.launch(" in text, path
    assert sorted(wrappers) == ["cuda_fc6.py", "cuda_fpn.py", "cuda_kernels.py",
                                "cuda_roi_align.py", "cuda_rpn.py", "cuda_stem.py",
                                "cuda_tail.py"]


def test_build_moves_the_log_into_place(tmp_path, monkeypatch):
    import subprocess

    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stem.cu").write_text("// a source\n")
    monkeypatch.setattr(cb, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cb, "_nvcc", lambda: "nvcc")
    replaced = []
    real_replace = os.replace

    def replace(src, dst):
        replaced.append((os.path.basename(src), os.path.basename(dst)))
        real_replace(src, dst)

    class Nvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            with open(self.out, "wb") as f:
                f.write(b"lib")
            return "ptxas info : Used 40 registers\n", None

    monkeypatch.setattr(subprocess, "Popen", Nvcc)
    monkeypatch.setattr(os, "replace", replace)
    reports = cb.build_all(["stem"])
    pid = os.getpid()
    assert replaced == [(f"stem.ptxas.log.{pid}", "stem.ptxas.log"),
                        (f"libstem.so.{pid}", "libstem.so")]
    assert reports == {"stem": "ptxas info : Used 40 registers\n"}
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [
        "libstem.so", "stem.ptxas.log"]


def test_dryrun_multiprocess():
    losses = dryrun_multiprocess(2)
    assert sorted(losses) == sorted(LOSSES + ("loss_total",))


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
