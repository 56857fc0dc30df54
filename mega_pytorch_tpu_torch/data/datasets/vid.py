"""ImageNet VID / DET datasets, test side (counterpart of
``mega_pytorch_tpu/data/datasets/vid.py``).

  * txt index: DET lines ``folder frame_id``; VID lines
    ``folder 1 frame_seg_id frame_seg_len``.
  * 30-class wnid → label map; XML annotations, cached per image set in an
    npz of plain arrays under ``data_dir/cache`` (a file name of its own, so
    the JAX package's pickled cache and this one never read each other).
  * per-method streaming metadata for testing: test samples carry reference
    frames, so the engines own all IO.

Frames are ``(H, W, 3)`` uint8 RGB numpy arrays from ``decode_rgb``, the one
place that reads an image file (through PIL, imported there only). The train
side (reference-frame sampling, empty-image filtering) is not ported.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

VID_CLASSES = (
    "__background__",
    "airplane", "antelope", "bear", "bicycle",
    "bird", "bus", "car", "cattle",
    "dog", "domestic_cat", "elephant", "fox",
    "giant_panda", "hamster", "horse", "lion",
    "lizard", "monkey", "motorcycle", "rabbit",
    "red_panda", "sheep", "snake", "squirrel",
    "tiger", "train", "turtle", "watercraft",
    "whale", "zebra",
)
VID_WNIDS = (
    "__background__",
    "n02691156", "n02419796", "n02131653", "n02834778",
    "n01503061", "n02924116", "n02958343", "n02402425",
    "n02084071", "n02121808", "n02503517", "n02118333",
    "n02510455", "n02342885", "n02374451", "n02129165",
    "n01674464", "n02484322", "n03790512", "n02324045",
    "n02509815", "n02411705", "n01726692", "n02355227",
    "n02129604", "n04468005", "n01662784", "n04530566",
    "n02062744", "n02391049",
)
WNID_TO_LABEL = {w: i for i, w in enumerate(VID_WNIDS)}


def parse_vid_xml(path: str) -> dict:
    """One annotation file → {boxes (N,4), labels (N,), im_info (h, w)}:
    boxes clamped into the image, unknown wnids skipped."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    h = int(size.find("height").text)
    w = int(size.find("width").text)
    boxes, labels = [], []
    for obj in root.findall("object"):
        wnid = obj.find("name").text.lower().strip()
        if wnid not in WNID_TO_LABEL:
            continue
        bb = obj.find("bndbox")
        boxes.append([
            max(float(bb.find("xmin").text), 0),
            max(float(bb.find("ymin").text), 0),
            min(float(bb.find("xmax").text), w - 1),
            min(float(bb.find("ymax").text), h - 1),
        ])
        labels.append(WNID_TO_LABEL[wnid])
    return {
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "labels": np.asarray(labels, np.int64),
        "im_info": (h, w),
    }


def decode_rgb(path: str) -> np.ndarray:
    """An image file → (H, W, 3) uint8 RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _save_annos(path: str, annos: list) -> None:
    counts = np.array([len(a["boxes"]) for a in annos], np.int64)
    np.savez_compressed(
        path, counts=counts,
        boxes=np.concatenate([a["boxes"] for a in annos]).reshape(-1, 4),
        labels=np.concatenate([a["labels"] for a in annos]).astype(np.int64),
        im_info=np.array([a["im_info"] for a in annos], np.int64).reshape(-1, 2))


def _load_annos(path: str) -> list:
    with np.load(path, allow_pickle=False) as z:
        ends = np.cumsum(z["counts"])
        boxes = np.split(z["boxes"], ends[:-1])
        labels = np.split(z["labels"], ends[:-1])
        return [{"boxes": b, "labels": lab, "im_info": (int(h), int(w))}
                for b, lab, (h, w) in zip(boxes, labels, z["im_info"])]


class VIDDataset:
    """Core single-frame dataset ('base' method), test side."""

    def __init__(self, image_set: str, data_dir: str, img_dir: str, anno_path: str,
                 img_index: str, is_train: bool = False, use_cache: bool = True):
        if is_train:
            raise NotImplementedError("the datasets' train side is not ported")
        self.image_set = image_set
        self.det_vid = image_set.split("_")[0]
        self.data_dir = data_dir
        self.is_train = is_train
        self._img_path = os.path.join(img_dir, "%s.JPEG")
        self._anno_path = os.path.join(anno_path, "%s.xml")

        with open(img_index) as f:
            lines = [x.strip().split(" ") for x in f if x.strip()]
        self.is_video = len(lines[0]) > 2
        if not self.is_video:
            self.image_set_index = [x[0] for x in lines]
            self.frame_id = [int(x[1]) for x in lines]
        else:
            self.image_set_index = ["%s/%06d" % (x[0], int(x[2])) for x in lines]
            self.pattern = [x[0] + "/%06d" for x in lines]
            self.frame_id = [int(x[1]) for x in lines]
            self.frame_seg_id = [int(x[2]) for x in lines]
            self.frame_seg_len = [int(x[3]) for x in lines]
        self.annos = self._load_annos(use_cache)

    def _cache_file(self) -> str:
        cache_dir = os.path.join(self.data_dir, "cache")
        os.makedirs(cache_dir, exist_ok=True)
        return os.path.join(cache_dir, self.image_set + "_anno_arrays.npz")

    def _load_annos(self, use_cache: bool):
        cache = self._cache_file() if use_cache else None
        if cache and os.path.exists(cache):
            return _load_annos(cache)
        annos = [parse_vid_xml(self._anno_path % name) for name in self.image_set_index]
        if cache:
            try:
                _save_annos(cache, annos)
            except OSError:
                pass
        return annos

    # -- access ----------------------------------------------------------------
    def __len__(self):
        return len(self.image_set_index)

    def image_path(self, idx: int) -> str:
        return self._img_path % self.image_set_index[idx]

    def decode_rgb(self, path: str) -> np.ndarray:
        """Read one frame (H, W, 3) uint8; a dataset without files overrides it."""
        return decode_rgb(path)

    def load_image(self, idx: int) -> np.ndarray:
        return self.decode_rgb(self.image_path(idx))

    def load_frame(self, pattern: str, frame: int) -> np.ndarray:
        return self.decode_rgb(self._img_path % (pattern % frame))

    def get_img_info(self, idx: int) -> dict:
        h, w = self.annos[idx]["im_info"]
        return {"height": h, "width": w}

    def get_groundtruth(self, idx: int) -> dict:
        return self.annos[idx]

    def _frame_id(self, idx: int) -> int:
        return int(self.image_set_index[idx].split("/")[-1])

    def __getitem__(self, idx: int) -> dict:
        """base method: one frame + its ground truth."""
        return {"cur": self.load_image(idx), "gt": self.annos[idx], "idx": idx}

    @staticmethod
    def label_name(class_id: int) -> str:
        return VID_CLASSES[class_id]


class VIDRDNDataset(VIDDataset):
    """Test samples feed the frame at +max_offset (the next window entry)."""

    def __init__(self, *args, min_offset=-18, max_offset=18, ref_num=2, **kw):
        super().__init__(*args, **kw)
        self.min_offset, self.max_offset, self.ref_num = min_offset, max_offset, ref_num

    def __getitem__(self, idx: int) -> dict:
        frame_id = self._frame_id(idx)
        ref_id = min(self.frame_seg_len[idx] - 1, frame_id + self.max_offset)
        return {
            "cur": self.load_image(idx),
            "ref": [self.load_frame(self.pattern[idx], ref_id)],
            "frame_category": 0 if frame_id == 0 else 1,
            "seg_len": self.frame_seg_len[idx],
            "pattern": self.pattern[idx],
            "frame_id": frame_id,
            "gt": self.annos[idx],
            "idx": idx,
        }


class VIDMEGADataset(VIDDataset):
    """Test samples add a per-video shuffled global-frame schedule (10 on
    frame 0, then 1 a frame), seeded by ``global_seed``."""

    def __init__(self, *args, min_offset=-12, max_offset=12, ref_num_local=2,
                 ref_num_mem=3, ref_num_global=2, all_frame_interval=25,
                 global_size=10, global_enable=True, memory_enable=True,
                 global_shuffle=True, global_seed: int | None = None, **kw):
        super().__init__(*args, **kw)
        self.min_offset, self.max_offset = min_offset, max_offset
        self.ref_num_local, self.ref_num_mem = ref_num_local, ref_num_mem
        self.ref_num_global = ref_num_global
        self.all_frame_interval = all_frame_interval
        self.global_size = global_size
        self.global_enable = global_enable
        self.memory_enable = memory_enable

        g_rng = np.random.RandomState(global_seed)
        self.start_index, self.start_id, self.shuffled_index = [], [], {}
        for i in range(len(self.image_set_index)):
            if self._frame_id(i) == 0:
                self.start_index.append(i)
                shuffled = np.arange(self.frame_seg_len[i])
                if global_shuffle:
                    g_rng.shuffle(shuffled)
                self.shuffled_index[i] = shuffled
                self.start_id.append(i)
            else:
                self.start_id.append(self.start_index[-1])

    def global_ref_ids(self, idx: int) -> list[int]:
        """Frame ids of this sample's global updates: global_size ids on
        frame 0, 1 after."""
        if not self.global_enable:
            return []
        size = self.global_size if self._frame_id(idx) == 0 else 1
        start = self.start_id[idx]
        shuffled = self.shuffled_index[start]
        return [
            int(shuffled[(idx - start + self.global_size - j - 1) % self.frame_seg_len[idx]])
            for j in range(size)
        ]

    def __getitem__(self, idx: int) -> dict:
        frame_id = self._frame_id(idx)
        ref_id = min(self.frame_seg_len[idx] - 1, frame_id + self.max_offset)
        return {
            "cur": self.load_image(idx),
            "ref_l": [self.load_frame(self.pattern[idx], ref_id)],
            "ref_g": [self.load_frame(self.pattern[idx], fid)
                      for fid in self.global_ref_ids(idx)],
            "frame_category": 0 if frame_id == 0 else 1,
            "seg_len": self.frame_seg_len[idx],
            "pattern": self.pattern[idx],
            "frame_id": frame_id,
            "gt": self.annos[idx],
            "idx": idx,
        }


class VIDFGFADataset(VIDRDNDataset):
    """RDN-shaped samples with ±9 offsets."""

    def __init__(self, *args, min_offset=-9, max_offset=9, ref_num=2, **kw):
        super().__init__(*args, min_offset=min_offset, max_offset=max_offset,
                         ref_num=ref_num, **kw)


class VIDDFFDataset(VIDDataset):
    """A key every ``key_interval``-th frame."""

    def __init__(self, *args, min_offset=-9, max_offset=0, key_interval=10, **kw):
        super().__init__(*args, **kw)
        self.min_offset, self.max_offset = min_offset, max_offset
        self.key_interval = key_interval

    def __getitem__(self, idx: int) -> dict:
        frame_id = self._frame_id(idx)
        return {
            "cur": self.load_image(idx),
            "is_key_frame": frame_id % self.key_interval == 0,
            "frame_id": frame_id,
            "seg_len": self.frame_seg_len[idx],
            "pattern": self.pattern[idx],
            "gt": self.annos[idx],
            "idx": idx,
        }
