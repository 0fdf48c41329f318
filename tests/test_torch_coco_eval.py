"""Port vs JAX: the COCO evaluator (``evaluation/``).

The same seeded ground truth (a COCO dict of 12 images over 4 classes,
crowd boxes and every area range among them) and the same seeded
detections (near-GT boxes, random boxes, background-labelled boxes) go
through the port's ``CocoEvaluator`` and the JAX package's: the 12 stats
must be equal, with ``--rm-bg`` on and off, with the detections split over
evaluators merged through ``others=``, given as torch tensors, and with
the native C++ matcher and the numpy one.
"""

import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.data.coco import CocoDataset as JCoco
from snn_automotive_object_detection_tpu.evaluation.evaluator import (
    CocoEvaluator as JEvaluator,
)
from snn_automotive_object_detection_tpu_torch.data.coco import CocoDataset
from snn_automotive_object_detection_tpu_torch.evaluation import _native
from snn_automotive_object_detection_tpu_torch.evaluation.evaluator import CocoEvaluator
from snn_automotive_object_detection_tpu_torch.utils.parallel import parallel_world

N_IMAGES, N_CLASSES = 12, 4


def _coco(seed=0):
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(1, N_IMAGES + 1):
        images.append({"id": i, "file_name": f"{i}.png", "height": 480, "width": 640})
        for _ in range(int(rng.integers(1, 7))):
            side = float(rng.choice([12.0, 50.0, 150.0])) * rng.uniform(0.7, 1.3)
            bw, bh = side * rng.uniform(0.6, 1.4), side * rng.uniform(0.6, 1.4)
            x, y = rng.uniform(0, 640 - bw), rng.uniform(0, 480 - bh)
            anns.append({"id": len(anns) + 1, "image_id": i, "bbox": [x, y, bw, bh],
                         "category_id": int(rng.integers(1, N_CLASSES + 1)),
                         "area": bw * bh, "iscrowd": int(rng.random() < 0.1)})
    cats = [{"id": c, "name": f"c{c}"} for c in range(1, N_CLASSES + 1)]
    return {"images": images, "annotations": anns, "categories": cats}


def _detections(coco, seed=1):
    """{image_id: {"boxes", "scores", "labels", "valid"}}: a jittered copy
    of most GT boxes, random boxes and background (label 0) boxes, padded
    to 40 slots with invalid entries."""
    rng = np.random.default_rng(seed)
    out = {}
    for img in coco["images"]:
        gts = [a for a in coco["annotations"] if a["image_id"] == img["id"]]
        boxes, labels = [], []
        for a in gts:
            if rng.random() < 0.8:
                x, y, w, h = a["bbox"]
                j = rng.normal(0, 0.08 * max(w, h), 4)
                boxes.append([x + j[0], y + j[1], x + w + j[2], y + h + j[3]])
                labels.append(a["category_id"] if rng.random() < 0.9
                              else int(rng.integers(0, N_CLASSES + 1)))
        for _ in range(int(rng.integers(2, 9))):
            x, y = rng.uniform(0, 560), rng.uniform(0, 400)
            boxes.append([x, y, x + rng.uniform(8, 80), y + rng.uniform(8, 80)])
            labels.append(int(rng.integers(0, N_CLASSES + 1)))
        n = len(boxes)
        pad = 40 - n
        out[img["id"]] = {
            "boxes": np.concatenate([np.asarray(boxes, np.float32),
                                     np.zeros((pad, 4), np.float32)]),
            "scores": np.concatenate([rng.uniform(0.05, 1, n), np.zeros(pad)]).astype(np.float32),
            "labels": np.concatenate([labels, np.zeros(pad)]).astype(np.int64),
            "valid": np.arange(40) < n,
        }
    return out


@pytest.fixture(scope="module")
def data():
    coco = _coco()
    return coco, _detections(coco), CocoDataset("", coco), JCoco("", coco)


def _stats(evaluator, dets, others=()):
    evaluator.update(dets)
    evaluator.synchronize_between_processes(others=list(others) or None)
    evaluator.accumulate()
    return np.asarray(evaluator.summarize(verbose=False))


@pytest.mark.parametrize("rm_bg", [False, True])
def test_stats_equal_jax(data, rm_bg):
    _, dets, ds, jds = data
    got = _stats(CocoEvaluator(ds, remove_bg=rm_bg), dets)
    want = _stats(JEvaluator(jds, remove_bg=rm_bg), dets)
    print(f"rm_bg={rm_bg}: {got.round(4).tolist()}")
    np.testing.assert_array_equal(got, want)
    assert got[0] > 0.1 and (got >= 0).all()
    n_bg = sum(int((d["labels"][d["valid"]] == 0).sum()) for d in dets.values())
    kept = CocoEvaluator(ds, remove_bg=rm_bg)
    kept.update(dets)
    stored = sum(len(np.concatenate(d["scores"])) for d in kept.eval.dets.values())
    n_valid = sum(int(d["valid"].sum()) for d in dets.values())
    assert n_bg > 0 and stored == n_valid - (n_bg if rm_bg else 0)


def test_others_merge_equals_jax(data):
    """Detections split over three evaluators and merged through ``others=``
    (image 1 evaluated twice, as wrap-around sharding pads) give the stats
    of one evaluator over all of them, as in the JAX package."""
    _, dets, ds, jds = data
    ids = sorted(dets)
    parts = [{i: dets[i] for i in ids[0::3]}, {i: dets[i] for i in ids[1::3] + ids[:1]},
             {i: dets[i] for i in ids[2::3]}]
    want_all = _stats(JEvaluator(jds), dets)

    def merged(cls, source):
        first, *rest = [cls(source) for _ in parts]
        for ev, part in zip(rest, parts[1:]):
            ev.update(part)
        return _stats(first, parts[0], rest)

    got = merged(CocoEvaluator, ds)
    np.testing.assert_array_equal(got, merged(JEvaluator, jds))
    np.testing.assert_array_equal(got, want_all)


def test_tensor_detections_equal_numpy(data):
    _, dets, ds, _ = data
    as_tensors = {i: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
                  for i, d in dets.items()}
    np.testing.assert_array_equal(_stats(CocoEvaluator(ds), as_tensors),
                                  _stats(CocoEvaluator(ds), dets))


def test_native_and_numpy_matchers_equal(data, monkeypatch):
    """The C++ matcher (built with g++ into the port's _build/) and the
    numpy loop give the same stats; ``native_available`` says which ran."""
    _, dets, ds, _ = data
    assert _native.native_available()
    assert _native.get_lib()._name.startswith(str(_native._BUILD))
    native = _stats(CocoEvaluator(ds), dets)
    monkeypatch.setattr(_native, "_TRIED", True)
    monkeypatch.setattr(_native, "_LIB", None)
    assert not _native.native_available()
    np.testing.assert_array_equal(_stats(CocoEvaluator(ds), dets), native)


def test_one_process_gathers_nothing(data):
    """``parallel_world`` reports one process: synchronising without
    ``others`` leaves the detections as they are."""
    _, dets, ds, _ = data
    assert parallel_world() == (0, 1)
    ev = CocoEvaluator(ds)
    ev.update(dets)
    before = {i: [np.concatenate(v["scores"])] for i, v in ev.eval.dets.items()}
    ev.synchronize_between_processes()
    after = {i: [np.concatenate(v["scores"])] for i, v in ev.eval.dets.items()}
    assert before.keys() == after.keys()
    assert all(np.array_equal(before[i][0], after[i][0]) for i in before)
