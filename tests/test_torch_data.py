"""Port vs JAX: the host-side input pipeline (datasets, transforms, the
bucketed loader, configs) and the bilinear resize.

The port's loader resizes with numpy (``data/loader.resize_bilinear``)
where the JAX package calls ``cv2.resize``; it is held to ``cv2.resize``
(INTER_LINEAR, float32) bit for bit, which the installed OpenCV gives, on
the shapes the loader meets: 2x down (128x256 -> 64x128), 6x up (-> 768 x
1536), Cityscapes' 1024x2048, 720p and a 375x500 VOC image into the
flagship bucket. So the two loaders' batches are compared exactly: sizes,
ids, ``pad_mask``, targets and images. The datasets are the mini COCO set
of ``tests/mini_dataset.py`` at the 64x128 bucket (landscape only, and
mixed with portrait images, whole and sharded two ways) and an IDD tree in
the layout of tests/test_idd.py.
"""

import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.data import transforms as JT
from snn_automotive_object_detection_tpu.data.coco import CocoDataset as JCoco
from snn_automotive_object_detection_tpu.data.idd import IDDDataset as JIDD
from snn_automotive_object_detection_tpu.data.loader import DetectionLoader as JLoader
from snn_automotive_object_detection_tpu.data.registry import create_dataset as j_create
from snn_automotive_object_detection_tpu.evaluation.evaluator import (
    ground_truth_from_dataset as j_gt,
)
from snn_automotive_object_detection_tpu.models.transform import resize_shape as j_resize_shape
from snn_automotive_object_detection_tpu.utils import config as jconfig
from snn_automotive_object_detection_tpu_torch.data import transforms as T
from snn_automotive_object_detection_tpu_torch.data.coco import CocoDataset
from snn_automotive_object_detection_tpu_torch.data.idd import IDDDataset
from snn_automotive_object_detection_tpu_torch.data.loader import (
    DetectionLoader,
    fma_f32,
    resize_bilinear,
    to_device_batch,
)
from snn_automotive_object_detection_tpu_torch.data.registry import create_dataset
from snn_automotive_object_detection_tpu_torch.evaluation.evaluator import (
    ground_truth_from_dataset,
)
from snn_automotive_object_detection_tpu_torch.models.transform import resize_shape
from snn_automotive_object_detection_tpu_torch.utils import config
from tests.mini_dataset import make_mini_env

BUCKET = (64, 128)
MIXED = [(128, 256), (256, 128), (128, 256), (200, 160), (96, 256)]


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """{"landscape": dataset cfg, "mixed": dataset cfg} of two mini sets."""
    out = {}
    for name, sizes in (("landscape", None), ("mixed", MIXED)):
        _, ds_yaml, _ = make_mini_env(tmp_path_factory.mktemp(name), seed=3,
                                      n_images=5, sizes=sizes)
        out[name] = config.load_dataset_config(ds_yaml)
    return out


def _datasets(cfg):
    return (CocoDataset(cfg["images_dir"], cfg["ann_file_val"]),
            JCoco(cfg["images_dir"], cfg["ann_file_val"]))


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("which", ["landscape", "mixed"])
def test_loader_matches_jax(mini, which, shard):
    ds, jds = _datasets(mini[which])
    kw = dict(min_size=BUCKET[0], max_size=BUCKET[1], shard=shard, num_workers=2)
    got = list(DetectionLoader(ds, 2, BUCKET, **kw))
    want = list(JLoader(jds, 2, BUCKET, **kw))
    assert len(got) == len(want) > 0
    buckets = set()
    for g, w in zip(got, want):
        assert set(g) == set(w) - {"images_p"}
        for k in ("image_sizes", "original_sizes", "image_ids", "pad_mask"):
            np.testing.assert_array_equal(g[k], w[k])
        for k in ("boxes", "labels", "valid"):
            np.testing.assert_array_equal(g["targets"][k], w["targets"][k])
        assert g["images"].dtype == np.float32
        np.testing.assert_array_equal(g["images"], w["images"])
        buckets.add(g["images"].shape[1:3])
    assert buckets == ({BUCKET, BUCKET[::-1]} if which == "mixed" else {BUCKET})


RESIZE_CASES = [((128, 256), (64, 128)), ((128, 256), (768, 1536)),
                ((1024, 2048), (768, 1536)), ((720, 1280), (768, 1365)),
                ((375, 500), (768, 1024))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_matches_cv2(src, dst):
    import cv2

    img = np.random.default_rng(src[0] + dst[0]).random(src + (3,), dtype=np.float32)
    got = resize_bilinear(img, *dst)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_fma_rounds_once_at_a_float64_midpoint():
    """x y + z where the float64 sum lands on a float32 midpoint and its
    rounding error decides: one rounding gives the lower neighbour, two
    roundings (float64, then float32, ties to even) the upper one."""
    from fractions import Fraction

    x, y, z = (np.array([v], np.float32) for v in
               (2.0 ** -12 * (1 + 2.0 ** -23), 2.0 ** -12 * (1 - 2.0 ** -23), 1 + 2.0 ** -23))
    exact = Fraction(float(x[0])) * Fraction(float(y[0])) + Fraction(float(z[0]))
    got = fma_f32(x, y, z)[0]
    twice = np.float32(float(x[0]) * float(y[0]) + float(z[0]))
    assert got == np.float32(1 + 2.0 ** -23) != twice
    assert abs(Fraction(float(got)) - exact) < abs(Fraction(float(twice)) - exact)


def test_resize_shape_equals_jax():
    for hw in ((1024, 2048), (720, 1280), (500, 500), (375, 500), (2048, 1024), (128, 256),
               (333, 777)):
        for lim in ((768, 1536), (64, 128), (320, 640)):
            assert resize_shape(hw, *lim) == j_resize_shape(hw, *lim)


def _run_both(make_port, make_jax, img, target, seed):
    got = make_port(np.random.default_rng(seed))(img.copy(), {k: v.copy() for k, v in
                                                              target.items()})
    want = make_jax(np.random.default_rng(seed))(img.copy(), {k: v.copy() for k, v in
                                                              target.items()})
    return got, want


TRANSFORMS = {
    "gaussian": lambda m: (lambda r: m.eval_transform("gaussian", 0.02, r)),
    "syp": lambda m: (lambda r: m.eval_transform("syp", 0.1, r)),
    "rain": lambda m: (lambda r: m.eval_transform("rain", 200, r)),
    "light-rain": lambda m: (lambda r: m.eval_transform("light-rain", rng=r)),
    "heavy-rain": lambda m: (lambda r: m.eval_transform("heavy-rain", rng=r)),
    **{f"train-{p}": (lambda p: lambda m: (lambda r: m.train_transform(p, r)))(p)
       for p in ("hflip", "lsj", "multiscale", "ssd", "ssdlite", "none")},
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    """Noise, rain and the training augmentations with one generator seed
    give the JAX package's images and targets."""
    img = np.random.default_rng(9).uniform(0, 255, (120, 160, 3)).astype(np.uint8)
    target = {"boxes": np.array([[10.0, 10.0, 60.0, 50.0], [70.0, 40.0, 140.0, 100.0]],
                                np.float32),
              "labels": np.array([1, 2])}
    (g_img, g_t), (w_img, w_t) = _run_both(TRANSFORMS[name](T), TRANSFORMS[name](JT), img,
                                           target, seed=4)
    np.testing.assert_array_equal(g_img, w_img)
    assert (g_t is None) == (w_t is None)
    for k in (w_t or {}):
        np.testing.assert_array_equal(g_t[k], w_t[k])


XML = """<annotation><filename>{name}.jpg</filename>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>{objects}
</annotation>"""
OBJ = """<object><name>{cls}</name><bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>
  <xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"""


@pytest.fixture(scope="module")
def idd_root(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("idd")
    (root / "JPEGImages").mkdir()
    (root / "Annotations").mkdir()
    rng = np.random.default_rng(5)
    names = []
    for i in range(3):
        name = f"img{i:03d}"
        names.append(name)
        cv2.imwrite(str(root / "JPEGImages" / f"{name}.jpg"),
                    rng.uniform(0, 255, (120, 160, 3)).astype(np.uint8))
        objs = "".join(OBJ.format(cls=c, x1=10 + 20 * j, y1=15, x2=40 + 20 * j, y2=60)
                       for j, c in enumerate(["car", "autorickshaw", "bus"][: i + 1]))
        (root / "Annotations" / f"{name}.xml").write_text(
            XML.format(name=name, w=160, h=120, objects=objs))
    (root / "val.txt").write_text("\n".join(names) + "\n")
    return str(root)


def test_idd_matches_jax(idd_root):
    ds, jds = IDDDataset(idd_root, "val"), JIDD(idd_root, "val")
    assert len(ds) == len(jds) == 3
    for i in range(3):
        (img, t), (j_img, j_t) = ds[i], jds[i]
        np.testing.assert_array_equal(img, j_img)
        assert ds.get_height_and_width(i) == jds.get_height_and_width(i) == (120, 160)
        for k in j_t:
            np.testing.assert_array_equal(t[k], j_t[k])
    gt, cats, ids = ground_truth_from_dataset(ds)
    j_gt_, j_cats, j_ids = j_gt(jds)
    assert (cats, ids) == (j_cats, j_ids)
    for i in ids:
        for k in j_gt_[i]:
            np.testing.assert_array_equal(gt[i][k], j_gt_[i][k])


def test_configs_and_registry_match_jax(mini):
    for name in ("cityscapes", "bdd", "idd", "pascal", "coco"):
        cfg = config.load_dataset_config(name, data_root="/data")
        assert cfg == jconfig.load_dataset_config(name, data_root="/data")
        assert config.class_names(cfg) == jconfig.class_names(cfg)
    assert config.load_model_yaml() == jconfig.load_model_yaml()
    cfg = mini["landscape"]
    for only_known in (False, True):
        ds = create_dataset("mini", "validation", only_known_cls=only_known, cfg=dict(cfg))
        jds = j_create("mini", "validation", only_known_cls=only_known, cfg=dict(cfg))
        assert ds.ids == jds.ids and len(ds) > 0
        (img, t), (j_img, j_t) = ds[0], jds[0]
        np.testing.assert_array_equal(img, j_img)
        for k in j_t:
            np.testing.assert_array_equal(t[k], j_t[k])


def test_load_image_is_the_pixel_seam(mini):
    """A subclass's ``load_image`` replaces the decode; the targets still
    come from the annotations."""
    cfg = mini["landscape"]
    ds, _ = _datasets(cfg)
    fake = {i: np.full((128, 256, 3), i, np.uint8) for i in ds.ids}

    class InMemory(CocoDataset):
        def load_image(self, image_id):
            return fake[image_id]

    mem = InMemory("", cfg["ann_file_val"])
    for i in range(len(ds)):
        (img, t), (_, want_t) = mem[i], ds[i]
        assert img is fake[mem.ids[i]]
        for k in want_t:
            np.testing.assert_array_equal(t[k], want_t[k])


def test_to_device_batch_on_the_cpu(mini):
    ds, _ = _datasets(mini["landscape"])
    batch = next(iter(DetectionLoader(ds, 2, BUCKET, BUCKET[0], BUCKET[1], num_workers=1)))
    out = to_device_batch(batch, "cpu", with_targets=True)
    assert set(out) == {"images", "image_sizes", "original_sizes", "targets"}
    for k in ("images", "image_sizes", "original_sizes"):
        assert out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), batch[k])
    for k, v in batch["targets"].items():
        np.testing.assert_array_equal(out["targets"][k].numpy(), v)
    assert "targets" not in to_device_batch(batch, "cpu")


def test_to_device_batch_refuses_a_missing_card(mini):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    ds, _ = _datasets(mini["landscape"])
    batch = next(iter(DetectionLoader(ds, 1, BUCKET, BUCKET[0], BUCKET[1], num_workers=1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_device_batch(batch, "cuda")


def test_smoke_module_writes_its_panel(mini, tmp_path):
    from snn_automotive_object_detection_tpu_torch.data import smoke

    import yaml

    path = tmp_path / "mini.yaml"
    path.write_text(yaml.safe_dump(mini["mixed"]))
    out = tmp_path / "panel.png"
    args = smoke.get_args_parser().parse_args(
        ["-d", str(path), "--batches", "2", "-b", "2", "--bucket", "64", "128", "-j", "2",
         "--out", str(out)])
    smoke.main(args)
    assert out.exists() and out.stat().st_size > 0
