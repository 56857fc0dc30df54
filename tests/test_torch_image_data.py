"""The port's image datasets and native JPEG loader against the JAX
package's, on the files of ``tests/test_data.py``.

COCO (contiguous category map, images without usable annotations removed,
crowds kept and flagged for evaluation, dropped for training), Pascal VOC
(the ``difficult`` flag, 1-indexed boxes), Cityscapes (instance polygons),
``ConcatDataset`` and ``ListDataset``: every sample equal to JAX's, the
frame as the uint8 array of JAX's PIL image. The native loader built from
the port's copy of ``csrc/loader.cpp``: ``load_frame`` / ``load_batch`` bit
for bit JAX's, and within a mean of 2 levels of the port's PIL-exact
``preprocess_image`` (the JAX test's bound: the same triangle-filter
family, not the same rounding).
"""

import json
import shutil

import numpy as np
import pytest
from PIL import Image

from mega_pytorch_tpu.data import native_loader as jax_loader
from mega_pytorch_tpu.data.datasets import coco_voc as jax_cv
from mega_pytorch_tpu.data.datasets import concat as jax_concat
from mega_pytorch_tpu_torch.data import native_loader
from mega_pytorch_tpu_torch.data.datasets import coco_voc, concat
from mega_pytorch_tpu_torch.data.transforms import preprocess_image


def _assert_same_sample(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["cur"], np.asarray(want["cur"]))
    assert got["cur"].dtype == np.uint8
    assert got["idx"] == want["idx"]
    _assert_same_gt(got["gt"], want["gt"])


def _assert_same_gt(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def _coco_files(tmp_path):
    (tmp_path / "imgs").mkdir()
    rs = np.random.RandomState(0)
    for name in ("a.jpg", "b.jpg", "c.jpg"):
        Image.fromarray((rs.rand(40, 50, 3) * 255).astype(np.uint8)).save(
            tmp_path / "imgs" / name)
    ann = {
        "images": [
            {"id": 7, "file_name": "a.jpg", "height": 40, "width": 50},
            {"id": 9, "file_name": "b.jpg", "height": 40, "width": 50},
            {"id": 4, "file_name": "c.jpg", "height": 40, "width": 50},
        ],
        "annotations": [
            {"id": 1, "image_id": 7, "category_id": 18, "bbox": [10, 10, 20, 15], "iscrowd": 0},
            {"id": 2, "image_id": 7, "category_id": 3, "bbox": [5, 5, 8, 8], "iscrowd": 0},
            {"id": 3, "image_id": 7, "category_id": 3, "bbox": [1, 2, 30, 20], "iscrowd": 1,
             "area": 400.0},
            {"id": 4, "image_id": 7, "category_id": 18, "bbox": [3, 3, 0, 5], "iscrowd": 0},
            {"id": 5, "image_id": 4, "category_id": 18, "bbox": [2, 2, 9, 9], "iscrowd": 1},
        ],
        "categories": [{"id": 3, "name": "car"}, {"id": 18, "name": "dog"}],
    }
    f = tmp_path / "ann.json"
    f.write_text(json.dumps(ann))
    return str(f), str(tmp_path / "imgs")


@pytest.mark.parametrize("kw", [{}, {"remove_images_without_annotations": False},
                                {"is_train": False}])
def test_coco_dataset_matches_jax(tmp_path, kw):
    ann, root = _coco_files(tmp_path)
    got, want = coco_voc.COCODataset(ann, root, **kw), jax_cv.COCODataset(ann, root, **kw)
    assert len(got) == len(want) == (1 if not kw else 3)  # 9 has none, 4 only a crowd
    assert got.ids == want.ids
    assert got.json_category_id_to_contiguous_id == want.json_category_id_to_contiguous_id
    assert got.contiguous_category_id_to_json_id == want.contiguous_category_id_to_json_id
    assert got.categories == want.categories
    for i in range(len(got)):
        _assert_same_sample(got[i], want[i])
        _assert_same_gt(got.get_groundtruth(i), want.get_groundtruth(i))
        assert got.get_img_info(i) == want.get_img_info(i)
    full = got.get_groundtruth(got.ids.index(7))
    assert full["iscrowd"].tolist() == [False, False, True]  # the w = 0 box is dropped
    np.testing.assert_allclose(full["boxes"][0], [10, 10, 29, 24])  # xywh → xyxy (-1)


def _voc_files(tmp_path):
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (tmp_path / sub).mkdir(parents=True)
    rs = np.random.RandomState(1)
    objs = ("<object><name>dog</name><difficult>0</difficult><bndbox><xmin>11</xmin>"
            "<ymin>6</ymin><xmax>21</xmax><ymax>16</ymax></bndbox></object>"
            "<object><name>Car </name><difficult>1</difficult><bndbox><xmin>2</xmin>"
            "<ymin>3</ymin><xmax>9</xmax><ymax>12</ymax></bndbox></object>"
            "<object><name>person</name><bndbox><xmin>1</xmin>"
            "<ymin>1</ymin><xmax>30</xmax><ymax>20</ymax></bndbox></object>")
    for name in ("000001", "000002"):
        Image.fromarray((rs.rand(30, 40, 3) * 255).astype(np.uint8)).save(
            tmp_path / "JPEGImages" / f"{name}.jpg")
        (tmp_path / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><size><height>30</height><width>40</width></size>{objs}"
            "</annotation>")
    (tmp_path / "ImageSets" / "Main" / "train.txt").write_text("000001\n000002\n")
    return str(tmp_path)


@pytest.mark.parametrize("use_difficult", [False, True])
def test_voc_dataset_matches_jax(tmp_path, use_difficult):
    root = _voc_files(tmp_path)
    got = coco_voc.PascalVOCDataset(root, "train", use_difficult=use_difficult)
    want = jax_cv.PascalVOCDataset(root, "train", use_difficult=use_difficult)
    assert len(got) == len(want) == 2
    for i in range(2):
        _assert_same_sample(got[i], want[i])
        assert got.get_img_info(i) == want.get_img_info(i)
    gt = got.get_groundtruth(0)
    assert len(gt["boxes"]) == (3 if use_difficult else 2)
    np.testing.assert_allclose(gt["boxes"][0], [10, 5, 20, 15])  # 1-indexed → 0
    assert got.map_class_id_to_class_name(int(gt["labels"][0])) == "dog"


def test_cityscapes_dataset_matches_jax(tmp_path):
    img_dir, ann_dir = tmp_path / "leftImg8bit", tmp_path / "gtFine"
    rs = np.random.RandomState(2)
    for city, stems in (("aachen", ("aachen_000000_000019",)), ("bonn", ("bonn_000001_000019",
                                                                        "bonn_000000_000019"))):
        (img_dir / "train" / city).mkdir(parents=True)
        (ann_dir / "train" / city).mkdir(parents=True)
        for stem in stems:
            Image.fromarray((rs.rand(24, 32, 3) * 255).astype(np.uint8)).save(
                img_dir / "train" / city / f"{stem}_leftImg8bit.png")
            objs = [{"label": "car", "polygon": [[1, 2], [20, 3], [15, 18]]},
                    {"label": "sky", "polygon": [[0, 0], [31, 0], [31, 5]]},
                    {"label": "person", "polygon": [[4, 4], [9, 21]]}]
            (ann_dir / "train" / city / f"{stem}_gtFine_polygons.json").write_text(
                json.dumps({"imgHeight": 24, "imgWidth": 32, "objects": objs}))
    got = coco_voc.CityScapesDataset(str(img_dir), str(ann_dir))
    want = jax_cv.CityScapesDataset(str(img_dir), str(ann_dir))
    assert got.items == want.items and len(got) == 3
    for i in range(3):
        _assert_same_sample(got[i], want[i])
        assert got.get_img_info(i) == want.get_img_info(i)
    assert got.get_groundtruth(0)["labels"].tolist() == [3, 1]  # sky is not an instance


def test_concat_and_list_datasets_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    path = tmp_path / "x.png"
    Image.fromarray((rs.rand(20, 30, 3) * 255).astype(np.uint8)).save(path)
    arr = (rs.rand(10, 12, 3) * 255).astype(np.uint8)
    items = [
        {"path": str(path), "boxes": np.array([[1, 2, 5, 6]], np.float32),
         "labels": np.array([3]), "height": 20, "width": 30},
        {"image": arr, "boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int64),
         "height": 10, "width": 12},
    ]
    root = _voc_files(tmp_path / "voc")
    got = concat.ConcatDataset([concat.ListDataset(items),
                                coco_voc.PascalVOCDataset(root, "train"),
                                concat.ListDataset(items[1:])])
    want = jax_concat.ConcatDataset([jax_concat.ListDataset(items),
                                     jax_cv.PascalVOCDataset(root, "train"),
                                     jax_concat.ListDataset(items[1:])])
    assert len(got) == len(want) == 5
    assert got.cumulative_sizes == want.cumulative_sizes == [2, 4, 5]
    for i in range(5):
        assert got.get_idxs(i) == want.get_idxs(i)
        _assert_same_sample(got[i], want[i])
        assert got.get_img_info(i) == want.get_img_info(i)
        _assert_same_gt(got.get_groundtruth(i), want.get_groundtruth(i))
    assert got.get_idxs(4) == (2, 0)
    with pytest.raises(ValueError):
        concat.ConcatDataset([])


@pytest.fixture(scope="module")
def native_built():
    """Both libraries, each built once; skipped only without g++ or
    jpeglib.h, which the JAX test's toolchain check also needs."""
    if shutil.which("g++") is None or not native_loader.available():
        pytest.skip("g++ or libjpeg's jpeglib.h is missing")
    assert jax_loader.available()


def _jpeg(tmp_path, seed, hw=(120, 160)):
    rng = np.random.RandomState(seed)
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    p = tmp_path / f"x{seed}.jpg"
    Image.fromarray(img).save(p, quality=95)
    return p


@pytest.mark.parametrize("flip", [False, True])
def test_native_loader_equals_jax_and_tracks_pil_path(tmp_path, native_built, flip):
    p = _jpeg(tmp_path, 0)
    out, (oh, ow) = native_loader.load_frame(str(p), 60, 100, flip, 64, 100)
    want, want_hw = jax_loader.load_frame(str(p), 60, 100, flip, 64, 100)
    np.testing.assert_array_equal(out, want)
    assert (oh, ow) == want_hw
    ref = preprocess_image(np.asarray(Image.open(p).convert("RGB")), 60, 100, flip,
                           canvas_short=64, canvas_long=100)
    assert (oh, ow) == (int(ref.size[0]), int(ref.size[1]))
    diff = np.abs(out[:oh, :ow] - ref.image[:oh, :ow])
    assert diff.mean() < 2.0, diff.mean()
    np.testing.assert_array_equal(out[oh:], 0)  # the canvas padding
    np.testing.assert_array_equal(out[:, ow:], 0)


def test_native_load_batch_equals_jax_and_frames(tmp_path, native_built):
    # landscape frames: the loader's canvas is fixed, not per orientation
    paths = [str(_jpeg(tmp_path, s, hw)) for s, hw in ((1, (120, 160)), (2, (100, 150)),
                                                     (3, (90, 200)))] * 2
    flips = [False, True, False, True, True, False]
    outs, hws = native_loader.load_batch(paths, 60, 100, flips, 64, 100, num_threads=3)
    want, want_hws = jax_loader.load_batch(paths, 60, 100, flips, 64, 100, num_threads=3)
    np.testing.assert_array_equal(outs, want)
    np.testing.assert_array_equal(hws, want_hws)
    for i, (p, f) in enumerate(zip(paths, flips)):
        one, hw = native_loader.load_frame(p, 60, 100, f, 64, 100)
        np.testing.assert_array_equal(outs[i], one)
        assert tuple(hws[i]) == hw
    with pytest.raises(ValueError):
        native_loader.load_batch(paths, 60, 100, flips[:2], 64, 100)
    with pytest.raises(IOError):
        native_loader.load_frame(str(tmp_path / "missing.jpg"), 60, 100, False, 64, 100)
