"""Dataset catalog (counterpart of ``mega_pytorch_tpu/data/paths_catalog.py``):
dataset names + method → dataset classes and constructor paths."""

from __future__ import annotations

import os

from .datasets.vid import (
    VIDDataset,
    VIDDFFDataset,
    VIDFGFADataset,
    VIDMEGADataset,
    VIDRDNDataset,
)

DATA_DIR = "datasets"

DATASETS = {
    "DET_train_30classes": {
        "img_dir": "ILSVRC2015/Data/DET",
        "anno_path": "ILSVRC2015/Annotations/DET",
        "img_index": "ILSVRC2015/ImageSets/DET_train_30classes.txt",
    },
    "VID_train_15frames": {
        "img_dir": "ILSVRC2015/Data/VID",
        "anno_path": "ILSVRC2015/Annotations/VID",
        "img_index": "ILSVRC2015/ImageSets/VID_train_15frames.txt",
    },
    "VID_train_every10frames": {
        "img_dir": "ILSVRC2015/Data/VID",
        "anno_path": "ILSVRC2015/Annotations/VID",
        "img_index": "ILSVRC2015/ImageSets/VID_train_every10frames.txt",
    },
    "VID_val_frames": {
        "img_dir": "ILSVRC2015/Data/VID",
        "anno_path": "ILSVRC2015/Annotations/VID",
        "img_index": "ILSVRC2015/ImageSets/VID_val_frames.txt",
    },
    "VID_val_videos": {
        "img_dir": "ILSVRC2015/Data/VID",
        "anno_path": "ILSVRC2015/Annotations/VID",
        "img_index": "ILSVRC2015/ImageSets/VID_val_videos.txt",
    },
}

_METHOD_FACTORY = {
    "base": VIDDataset,
    "dff": VIDDFFDataset,
    "fgfa": VIDFGFADataset,
    "rdn": VIDRDNDataset,
    "mega": VIDMEGADataset,
}


def dataset_args(name: str, data_dir: str | None = None) -> dict:
    data_dir = data_dir or DATA_DIR
    attrs = DATASETS[name]
    return dict(
        image_set=name,
        data_dir=data_dir,
        img_dir=os.path.join(data_dir, attrs["img_dir"]),
        anno_path=os.path.join(data_dir, attrs["anno_path"]),
        img_index=os.path.join(data_dir, attrs["img_index"]),
    )


def build_dataset(name: str, method: str = "base", is_train: bool = False,
                  data_dir: str | None = None, **extra):
    factory = _METHOD_FACTORY[method]
    return factory(**dataset_args(name, data_dir), is_train=is_train, **extra)
