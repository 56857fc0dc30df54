"""COCO / Pascal VOC / Cityscapes datasets, image-only auxiliaries
(counterpart of ``mega_pytorch_tpu/data/datasets/coco_voc.py``).

Samples are those of the port's ``VIDDataset`` for the base method
({cur: (H, W, 3) uint8 RGB array, gt: {boxes, labels, im_info}, idx}), so
the same preprocessor and engines serve. COCO json is parsed directly (no
pycocotools); VOC reads per-image XML; Cityscapes the gtFine instance
polygons. Frames decode through ``vid.decode_rgb`` (PIL, imported there).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET

import numpy as np

from .vid import decode_rgb

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class COCODataset:
    """Minimal COCO-detection dataset (mega_core/data/datasets/coco.py).

    Filters images without usable annotations when training (remove_images_
    without_annotations) and maps category ids to contiguous labels."""

    def __init__(self, ann_file: str, root: str, remove_images_without_annotations: bool = True,
                 is_train: bool | None = None):
        with open(ann_file) as f:
            coco = json.load(f)
        self.root = root
        self.images = {im["id"]: im for im in coco["images"]}
        cats = sorted(c["id"] for c in coco.get("categories", []))
        self.json_category_id_to_contiguous_id = {c: i + 1 for i, c in enumerate(cats)}
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()
        }
        self.categories = {
            c["id"]: c.get("name", str(c["id"])) for c in coco.get("categories", [])
        }

        anns_by_img: dict = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)

        def has_usable(i):
            return any(not a.get("iscrowd", 0) for a in anns_by_img.get(i, []))

        if remove_images_without_annotations if is_train is None else is_train:
            ids = [i for i in self.images if has_usable(i)]
        else:
            ids = list(self.images)
        self.ids = sorted(ids)
        self.anns_by_img = anns_by_img

    def __len__(self):
        return len(self.ids)

    def get_img_info(self, idx: int) -> dict:
        im = self.images[self.ids[idx]]
        return {"height": im["height"], "width": im["width"]}

    def get_groundtruth(self, idx: int, include_crowd: bool = True) -> dict:
        """Full GT (crowds kept + flagged + COCO areas) for the evaluator;
        training targets use include_crowd=False (coco.py drops iscrowd)."""
        img_id = self.ids[idx]
        im = self.images[img_id]
        boxes, labels, iscrowd, areas = [], [], [], []
        for a in self.anns_by_img.get(img_id, []):
            x, y, w, h = a["bbox"]  # COCO xywh
            if w <= 0 or h <= 0:
                continue
            crowd = bool(a.get("iscrowd", 0))
            if crowd and not include_crowd:
                continue
            boxes.append([x, y, x + w - 1, y + h - 1])
            labels.append(self.json_category_id_to_contiguous_id[a["category_id"]])
            iscrowd.append(crowd)
            areas.append(float(a.get("area", w * h)))
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "iscrowd": np.asarray(iscrowd, bool),
            "areas": np.asarray(areas, np.float64),
            "im_info": (im["height"], im["width"]),
        }

    def __getitem__(self, idx: int) -> dict:
        im = self.images[self.ids[idx]]
        img = decode_rgb(os.path.join(self.root, im["file_name"]))
        return {"cur": img, "gt": self.get_groundtruth(idx, include_crowd=False), "idx": idx}


class PascalVOCDataset:
    """VOC detection (mega_core/data/datasets/voc.py)."""

    def __init__(self, data_dir: str, split: str, use_difficult: bool = False,
                 is_train: bool = True):
        self.data_dir = data_dir
        self.use_difficult = use_difficult
        self._img = os.path.join(data_dir, "JPEGImages", "%s.jpg")
        self._anno = os.path.join(data_dir, "Annotations", "%s.xml")
        split_file = os.path.join(data_dir, "ImageSets", "Main", f"{split}.txt")
        with open(split_file) as f:
            self.ids = [x.strip() for x in f if x.strip()]
        self.class_to_ind = {c: i for i, c in enumerate(VOC_CLASSES)}

    def __len__(self):
        return len(self.ids)

    def get_groundtruth(self, idx: int) -> dict:
        root = ET.parse(self._anno % self.ids[idx]).getroot()
        size = root.find("size")
        h, w = int(size.find("height").text), int(size.find("width").text)
        boxes, labels = [], []
        for obj in root.findall("object"):
            flag = obj.find("difficult")
            difficult = int(flag.text or "0") if flag is not None else 0
            if difficult and not self.use_difficult:
                continue
            name = obj.find("name").text.lower().strip()
            bb = obj.find("bndbox")
            # VOC is 1-indexed (voc.py subtracts 1)
            boxes.append(
                [
                    float(bb.find("xmin").text) - 1,
                    float(bb.find("ymin").text) - 1,
                    float(bb.find("xmax").text) - 1,
                    float(bb.find("ymax").text) - 1,
                ]
            )
            labels.append(self.class_to_ind[name])
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "im_info": (h, w),
        }

    def get_img_info(self, idx: int) -> dict:
        gt = self.get_groundtruth(idx)
        return {"height": gt["im_info"][0], "width": gt["im_info"][1]}

    def __getitem__(self, idx: int) -> dict:
        img = decode_rgb(self._img % self.ids[idx])
        return {"cur": img, "gt": self.get_groundtruth(idx), "idx": idx}

    @staticmethod
    def map_class_id_to_class_name(class_id: int) -> str:
        return VOC_CLASSES[class_id]


class CityScapesDataset:
    """Cityscapes instance boxes from gtFine polygon json
    (mega_core/data/datasets/cityscapes.py, boxes-only subset)."""

    INSTANCE_CLASSES = (
        "__background__",
        "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
    )

    def __init__(self, img_dir: str, ann_dir: str, split: str = "train", is_train: bool = True):
        self.img_dir = os.path.join(img_dir, split)
        self.ann_dir = os.path.join(ann_dir, split)
        self.class_to_ind = {c: i for i, c in enumerate(self.INSTANCE_CLASSES)}
        self.items = []
        for city in sorted(os.listdir(self.ann_dir)) if os.path.isdir(self.ann_dir) else []:
            for f in sorted(os.listdir(os.path.join(self.ann_dir, city))):
                if f.endswith("_gtFine_polygons.json"):
                    stem = f.replace("_gtFine_polygons.json", "")
                    self.items.append((city, stem))

    def __len__(self):
        return len(self.items)

    def get_groundtruth(self, idx: int) -> dict:
        city, stem = self.items[idx]
        with open(os.path.join(self.ann_dir, city, stem + "_gtFine_polygons.json")) as f:
            data = json.load(f)
        h, w = data["imgHeight"], data["imgWidth"]
        boxes, labels = [], []
        for obj in data.get("objects", []):
            label = obj["label"]
            if label not in self.class_to_ind:
                continue
            poly = np.asarray(obj["polygon"], np.float32)
            boxes.append(
                [poly[:, 0].min(), poly[:, 1].min(), poly[:, 0].max(), poly[:, 1].max()]
            )
            labels.append(self.class_to_ind[label])
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "im_info": (h, w),
        }

    def get_img_info(self, idx: int) -> dict:
        gt = self.get_groundtruth(idx)
        return {"height": gt["im_info"][0], "width": gt["im_info"][1]}

    def __getitem__(self, idx: int) -> dict:
        city, stem = self.items[idx]
        img = decode_rgb(os.path.join(self.img_dir, city, stem + "_leftImg8bit.png"))
        return {"cur": img, "gt": self.get_groundtruth(idx), "idx": idx}
