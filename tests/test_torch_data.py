"""The port's data layer against the JAX package's: the PIL-exact resize,
preprocessing, box transforms, sharding, the catalog and the five test-side
dataset classes, on the same seeded inputs; and the port importing with
``jax``, ``PIL`` and ``yaml`` blocked.

Every comparison here is exact (bit for bit, or ``==``): the port's
preprocessing is integer arithmetic plus the same f32 operations in the same
order as the JAX path."""

import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from mega_pytorch_tpu.data import paths_catalog as jax_catalog
from mega_pytorch_tpu.data import samplers as jax_samplers
from mega_pytorch_tpu.data import transforms as jax_tf
from mega_pytorch_tpu.data.datasets import vid as jax_vid
from mega_pytorch_tpu.data.loader import EvalPreprocessor as JaxEvalPreprocessor
from mega_pytorch_tpu_torch.data import paths_catalog, samplers
from mega_pytorch_tpu_torch.data import transforms as tf
from mega_pytorch_tpu_torch.data.datasets import vid
from mega_pytorch_tpu_torch.data.loader import EvalPreprocessor
from torch_port_harness import dataset_args, ilsvrc_data_dir, port_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pil_resize(img, oh, ow):
    return np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))


@settings(max_examples=80, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90), oh=st.integers(1, 120),
       ow=st.integers(1, 120), seed=st.integers(0, 2**31 - 1))
def test_resize_bilinear_equals_pil(h, w, oh, ow, seed):
    """Up, down, odd sizes and mixed directions, bit for bit."""
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tf.resize_bilinear_u8(img, oh, ow), _pil_resize(img, oh, ow))


@pytest.mark.parametrize("shape", [(720, 1280, 562, 999), (1280, 720, 999, 562),
                                   (1080, 1920, 562, 1000), (375, 500, 600, 800),
                                   (48, 64, 48, 64), (333, 500, 333, 250)])
def test_resize_bilinear_equals_pil_at_frame_sizes(shape):
    """The eval path's sizes (VID's 720p landscape and portrait frames, a
    1080p and a small upscaled frame), the identity and a one-axis resize."""
    h, w, oh, ow = shape
    img = np.random.RandomState(h + w).randint(0, 256, (h, w, 3), dtype=np.uint8)
    got = tf.resize_bilinear_u8(img, oh, ow)
    np.testing.assert_array_equal(got, _pil_resize(img, oh, ow))
    if (oh, ow) == (h, w):
        assert got is not img


def _frames(tiny_root):
    """A tiny_root frame and seeded 720x1280 / 1280x720 frames."""
    rs = np.random.RandomState(3)
    tiny = np.asarray(Image.open(tiny_root / "Data" / "VID" / "val" / "v00" / "000002.JPEG")
                      .convert("RGB"))
    return {"tiny": tiny,
            "landscape": rs.randint(0, 256, (720, 1280, 3), dtype=np.uint8),
            "portrait": rs.randint(0, 256, (1280, 720, 3), dtype=np.uint8)}


@pytest.mark.parametrize("frame", ["tiny", "landscape", "portrait"])
@pytest.mark.parametrize("flip", [False, True])
def test_preprocess_equals_jax(tiny_root, frame, flip):
    """``preprocess_image`` and ``preprocess_image_u8`` on a uint8 frame equal
    JAX's on the same frame as a PIL image, bit for bit (the eval recipe's
    600/1000 sizes and canvas for the big frames, the tests' for tiny_root)."""
    img = _frames(tiny_root)[frame]
    sizes = (48, 64, 48, 64) if frame == "tiny" else (600, 1000, 608, 1024)
    for port_fn, jax_fn in ((tf.preprocess_image, jax_tf.preprocess_image),
                            (tf.preprocess_image_u8, jax_tf.preprocess_image_u8)):
        got = port_fn(img, sizes[0], sizes[1], flip, sizes[2], sizes[3])
        want = jax_fn(Image.fromarray(img), sizes[0], sizes[1], flip, sizes[2], sizes[3])
        assert got.image.dtype == want.image.dtype
        np.testing.assert_array_equal(got.image, want.image)
        np.testing.assert_array_equal(got.size, want.size)
        assert got.scale == want.scale


def test_resize_canvas_boxes_equal_jax():
    rs = np.random.RandomState(0)
    for h, w in [(720, 1280), (1280, 720), (375, 500), (500, 500), (48, 64), (1080, 1920)]:
        for lo, hi in [(600, 1000), (48, 64), (800, 1333)]:
            assert tf.resize_hw(h, w, lo, hi) == jax_tf.resize_hw(h, w, lo, hi)
        assert tf.canvas_for(h, w) == jax_tf.canvas_for(h, w)
        assert tf.canvas_for(h, w, 48, 64) == jax_tf.canvas_for(h, w, 48, 64)
        boxes = rs.rand(5, 4).astype(np.float32) * [w, h, w, h]
        oh, ow = tf.resize_hw(h, w, 600, 1000)
        for flip in (False, True):
            np.testing.assert_array_equal(
                tf.transform_boxes(boxes, h, w, oh, ow, flip),
                jax_tf.transform_boxes(boxes, h, w, oh, ow, flip))
    empty = np.zeros((0, 4), np.float32)
    assert tf.transform_boxes(empty, 9, 9, 5, 5, True).shape == (0, 4)


def test_video_shards_equal_jax():
    rs = np.random.RandomState(1)
    for _ in range(30):
        lengths = rs.randint(1, 12, rs.randint(1, 9))
        starts = list(np.cumsum([0, *lengths[:-1]]))
        total = int(lengths.sum())
        for shards in (1, 2, 3, 5, 8):
            assert samplers.video_shards(starts, total, shards) == \
                jax_samplers.video_shards(starts, total, shards)


_CLASSES = ["VIDDataset", "VIDRDNDataset", "VIDMEGADataset", "VIDFGFADataset",
            "VIDDFFDataset"]
_KW = {"VIDRDNDataset": dict(max_offset=1), "VIDFGFADataset": dict(max_offset=2),
       "VIDMEGADataset": dict(max_offset=1, all_frame_interval=3, global_size=3,
                              global_seed=7),
       "VIDDFFDataset": dict(key_interval=2)}


def _assert_same(got, want, where):
    if isinstance(want, Image.Image):
        want = np.asarray(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want and type(got) is type(want), where


@pytest.mark.parametrize("cls_name", _CLASSES)
def test_dataset_samples_equal_jax(tiny_root, cls_name):
    """Every test-side sample field (frames, refs, annotations, streaming
    metadata, DFF key flags), MEGA's global schedule under the same
    ``global_seed``, and the preprocessed samples, equal JAX's; the
    annotation cache reloads the same annotations."""
    kw = _KW.get(cls_name, {})
    ds = port_dataset(tiny_root, cls_name, **kw)
    ref = getattr(jax_vid, cls_name)(**dataset_args(tiny_root), is_train=False, **kw)
    assert len(ds) == len(ref) == 10
    for attr in ("image_set_index", "pattern", "frame_id", "frame_seg_id", "frame_seg_len"):
        assert getattr(ds, attr) == getattr(ref, attr), attr
    if cls_name == "VIDMEGADataset":
        assert ds.start_index == ref.start_index and ds.start_id == ref.start_id
        assert ds.shuffled_index.keys() == ref.shuffled_index.keys()
        for k in ref.shuffled_index:
            np.testing.assert_array_equal(ds.shuffled_index[k], ref.shuffled_index[k])
    prep = EvalPreprocessor(min_size=48, max_size=64, canvas_short=48, canvas_long=64,
                            max_gt=4)
    jax_prep = JaxEvalPreprocessor(min_size=48, max_size=64, canvas_short=48,
                                   canvas_long=64, max_gt=4)
    for i in range(len(ds)):
        got, want = ds[i], ref[i]
        _assert_same(got, want, f"{cls_name}[{i}]")
        _assert_same(prep(got), jax_prep(want), f"prep {cls_name}[{i}]")
        assert ds.get_img_info(i) == ref.get_img_info(i)
        if cls_name == "VIDMEGADataset":
            assert ds.global_ref_ids(i) == ref.global_ref_ids(i)
    again = port_dataset(tiny_root, cls_name, **kw)  # from the port's cache
    assert os.path.exists(os.path.join(again.data_dir, "cache", "VID_val_anno_arrays.npz"))
    _assert_same(again.annos, ref.annos, "cached annos")


def test_build_dataset_equals_jax(tiny_root, tmp_path):
    data_dir = str(ilsvrc_data_dir(tiny_root, tmp_path))
    assert paths_catalog.dataset_args("VID_val_videos", data_dir) == \
        jax_catalog.dataset_args("VID_val_videos", data_dir)
    for method, cls_name in [("base", "VIDDataset"), ("rdn", "VIDRDNDataset"),
                             ("fgfa", "VIDFGFADataset"), ("dff", "VIDDFFDataset"),
                             ("mega", "VIDMEGADataset")]:
        ds = paths_catalog.build_dataset("VID_val_videos", method, data_dir=data_dir)
        ref = jax_catalog.build_dataset("VID_val_videos", method, is_train=False,
                                        data_dir=data_dir)
        assert type(ds).__name__ == type(ref).__name__ == cls_name
        assert ds.image_set_index == ref.image_set_index
        _assert_same(ds.annos, ref.annos, method)


def test_parse_vid_xml_equals_jax(tmp_path):
    """Clamping, unknown wnids skipped, case and whitespace of names."""
    path = tmp_path / "a.xml"
    path.write_text(
        "<annotation><size><height>40</height><width>60</width></size>"
        "<object><name> N02691156 </name><bndbox><xmin>-3</xmin><ymin>2</ymin>"
        "<xmax>70</xmax><ymax>39.5</ymax></bndbox></object>"
        "<object><name>n99999999</name><bndbox><xmin>1</xmin><ymin>1</ymin>"
        "<xmax>2</xmax><ymax>2</ymax></bndbox></object>"
        "<object><name>n02391049</name><bndbox><xmin>5</xmin><ymin>6</ymin>"
        "<xmax>7</xmax><ymax>8</ymax></bndbox></object></annotation>")
    _assert_same(vid.parse_vid_xml(str(path)), jax_vid.parse_vid_xml(str(path)), "xml")
    assert vid.VID_CLASSES == jax_vid.VID_CLASSES and vid.VID_WNIDS == jax_vid.VID_WNIDS


_BLOCKED = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL", "yaml") \
                or name == "mega_pytorch_tpu" or name.startswith("mega_pytorch_tpu."):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import mega_pytorch_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from mega_pytorch_tpu_torch.data.transforms import preprocess_image_u8
from mega_pytorch_tpu_torch.config import get_preset

img = np.random.RandomState(0).randint(0, 256, (720, 1280, 3), dtype=np.uint8)
p = preprocess_image_u8(img, 600, 1000, False)
assert p.image.shape == (608, 1024, 3) and tuple(p.size) == (562.0, 999.0)
assert get_preset("mega_R_101").MODEL.VID.METHOD == "mega"
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "yaml", "mega_pytorch_tpu")]
assert not bad, bad
print("imported", len(names), "modules")
"""


def test_port_imports_without_jax_pil_yaml():
    """Every module of the port imports with jax, flax, PIL, yaml and the JAX
    package blocked, and the card path's preprocessing and presets run there."""
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout
