"""Polygon and keypoint containers, host-side numpy (the port's copy of
``mega_pytorch_tpu/structures/segmentation.py``; maskrcnn-benchmark's
``segmentation_mask.py`` and ``keypoint.py``): polygon instances that crop,
resize, flip and rasterise to binary masks, and the mask head's target
projection. Rasterisation fills polygons with PIL (imported when a mask is
drawn, not with the module), as the JAX package does.
"""

from __future__ import annotations

import numpy as np

FLIP_LEFT_RIGHT = 0
FLIP_TOP_BOTTOM = 1


class PolygonInstance:
    """One object: a list of polygons ([x0, y0, x1, y1, ...] each)."""

    def __init__(self, polygons: list, size: tuple[int, int]):
        self.polygons = [np.asarray(p, np.float64).reshape(-1) for p in polygons]
        self.size = tuple(size)  # (w, h)

    def transpose(self, method: int) -> "PolygonInstance":
        w, h = self.size
        flipped = []
        for p in self.polygons:
            q = p.copy()
            if method == FLIP_LEFT_RIGHT:
                q[0::2] = w - p[0::2] - 1
            else:
                q[1::2] = h - p[1::2] - 1
            flipped.append(q)
        return PolygonInstance(flipped, self.size)

    def crop(self, box) -> "PolygonInstance":
        x1, y1, x2, y2 = map(float, box)
        w, h = x2 - x1, y2 - y1
        out = []
        for p in self.polygons:
            q = p.copy()
            q[0::2] = np.clip(p[0::2] - x1, 0, w)
            q[1::2] = np.clip(p[1::2] - y1, 0, h)
            out.append(q)
        return PolygonInstance(out, (int(w), int(h)))

    def resize(self, size) -> "PolygonInstance":
        w, h = size
        rx, ry = w / self.size[0], h / self.size[1]
        out = []
        for p in self.polygons:
            q = p.copy()
            q[0::2] = p[0::2] * rx
            q[1::2] = p[1::2] * ry
            out.append(q)
        return PolygonInstance(out, (int(w), int(h)))

    def rasterize(self, out_size: tuple[int, int] | None = None) -> np.ndarray:
        """→ (h, w) uint8 binary mask."""
        from PIL import Image, ImageDraw

        w, h = out_size or self.size
        img = Image.new("L", (int(w), int(h)), 0)
        draw = ImageDraw.Draw(img)
        for p in self.polygons:
            if len(p) >= 6:
                draw.polygon([tuple(xy) for xy in p.reshape(-1, 2)], fill=1)
        return np.asarray(img, np.uint8)


class SegmentationMask:
    """Per-image list of PolygonInstances (mode='poly')."""

    def __init__(self, instances: list, size: tuple[int, int]):
        self.instances = [
            i if isinstance(i, PolygonInstance) else PolygonInstance(i, size)
            for i in instances
        ]
        self.size = tuple(size)

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, idx):
        if isinstance(idx, (list, np.ndarray)):
            return SegmentationMask([self.instances[i] for i in idx], self.size)
        return self.instances[idx]

    def transpose(self, method: int) -> "SegmentationMask":
        return SegmentationMask(
            [i.transpose(method) for i in self.instances], self.size
        )

    def crop(self, box) -> "SegmentationMask":
        out = [i.crop(box) for i in self.instances]
        size = out[0].size if out else self.size
        return SegmentationMask(out, size)

    def resize(self, size) -> "SegmentationMask":
        return SegmentationMask([i.resize(size) for i in self.instances], size)

    def to_mask_targets(self, boxes: np.ndarray, mask_size: int = 28) -> np.ndarray:
        """Project each instance into its box and rasterize at mask_size
        (the mask head's training-target projection, mask_head/loss.py)."""
        out = np.zeros((len(self.instances), mask_size, mask_size), np.float32)
        for i, (inst, box) in enumerate(zip(self.instances, boxes)):
            cropped = inst.crop(box)
            scaled = cropped.resize((mask_size, mask_size))
            out[i] = scaled.rasterize((mask_size, mask_size))
        return out


class Keypoints:
    """(N, K, 3) keypoints (x, y, visibility) — structures/keypoint.py."""

    def __init__(self, keypoints: np.ndarray, size: tuple[int, int]):
        per = (keypoints.shape[-2] if hasattr(keypoints, "shape") and keypoints.ndim == 3
               else -1)
        self.keypoints = np.asarray(keypoints, np.float32).reshape(-1, per, 3)
        self.size = tuple(size)

    def __len__(self):
        return len(self.keypoints)

    def resize(self, size) -> "Keypoints":
        w, h = size
        rx, ry = w / self.size[0], h / self.size[1]
        kp = self.keypoints.copy()
        kp[..., 0] *= rx
        kp[..., 1] *= ry
        return Keypoints(kp, size)

    def transpose(self, method: int) -> "Keypoints":
        assert method == FLIP_LEFT_RIGHT
        w = self.size[0]
        kp = self.keypoints.copy()
        kp[..., 0] = w - kp[..., 0] - 1
        return Keypoints(kp, self.size)
