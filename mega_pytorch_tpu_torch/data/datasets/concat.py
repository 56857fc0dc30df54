"""Dataset composition (counterpart of
``mega_pytorch_tpu/data/datasets/concat.py``): ``ConcatDataset`` maps a
global index to (dataset, local index), ``ListDataset`` serves images and
annotations given as a list; samples are the port's plain arrays."""

from __future__ import annotations

import bisect

from .vid import decode_rgb


class ConcatDataset:
    """Concatenation of datasets sharing the sample protocol (build.py uses
    this for ("DET_train_30classes", "VID_train_15frames"))."""

    def __init__(self, datasets: list):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self) -> int:
        return self.cumulative_sizes[-1]

    def _locate(self, idx: int) -> tuple[int, int]:
        k = bisect.bisect_right(self.cumulative_sizes, idx)
        base = self.cumulative_sizes[k - 1] if k else 0
        return k, idx - base

    def __getitem__(self, idx: int):
        k, local = self._locate(idx)
        return self.datasets[k][local]

    def get_img_info(self, idx: int):
        k, local = self._locate(idx)
        return self.datasets[k].get_img_info(local)

    def get_groundtruth(self, idx: int):
        k, local = self._locate(idx)
        return self.datasets[k].get_groundtruth(local)

    def get_idxs(self, idx: int) -> tuple[int, int]:
        return self._locate(idx)


class ListDataset:
    """Images + annotation dicts given directly as a list (list_dataset.py)."""

    def __init__(self, items: list[dict]):
        """items: [{"path" or "image" (uint8 RGB array), "boxes", "labels",
        "height", "width"}]."""
        self.items = items

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        it = self.items[idx]
        img = it.get("image")
        if img is None:
            img = decode_rgb(it["path"])
        return {
            "cur": img,
            "gt": {
                "boxes": it["boxes"],
                "labels": it["labels"],
                "im_info": (it["height"], it["width"]),
            },
            "idx": idx,
        }

    def get_img_info(self, idx: int) -> dict:
        it = self.items[idx]
        return {"height": it["height"], "width": it["width"]}

    def get_groundtruth(self, idx: int) -> dict:
        it = self.items[idx]
        return {"boxes": it["boxes"], "labels": it["labels"]}
