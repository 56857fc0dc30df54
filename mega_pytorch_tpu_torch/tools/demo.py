"""Visualisation demo over a frame folder or a video file (counterpart of the
repo's ``tools/demo.py``): frames stream through a method's serial engine
(``StreamingInferencer``), boxes above the confidence threshold are drawn,
and the annotated frames are written, optionally also as a video.

    python -m mega_pytorch_tpu_torch.tools.demo --preset mega_R_101 \\
        --input-folder frames/ --output-folder visualized/ [--suffix .JPEG] \\
        [--checkpoint model.pth] [--device cuda] [opts ...]
    python -m mega_pytorch_tpu_torch.tools.demo ... --video clip.mp4 \\
        --output-folder out/ [--output-video out/vis.avi]

A folder is a video whose frames are its image files in name order; each
frame's sample feeds the method's streaming protocol as the JAX demo's
``FolderVideo.sample`` does (the frame ``max_offset`` ahead as the
reference, MEGA's global frames drawn with a fixed seed). The serial engine
packs the canvases as the method takes them (``batched_inference.pack_factor``).
Drawing uses PIL; ``--video`` and ``--output-video`` need OpenCV, which is
imported only there. ``--checkpoint`` (or ``MODEL.WEIGHT``) is a
mega.pytorch ``.pth``; without one the weights are drawn from seed 0. The
run takes the CUDA card unless ``--device cpu`` is given, and fails where
there is none.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.datasets.vid import VID_CLASSES, decode_rgb

PALETTE = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
]


def draw(img: np.ndarray, pred: dict, class_names, thresh: float):
    """uint8 RGB frame → PIL image with each detection of score >= thresh
    boxed and labelled in its class's palette colour (degenerate boxes
    skipped)."""
    from PIL import Image, ImageDraw

    out = Image.fromarray(img)
    d = ImageDraw.Draw(out)
    for box, score, label in zip(pred["boxes"], pred["scores"], pred["labels"]):
        if score < thresh:
            continue
        x1, y1, x2, y2 = map(float, box)
        if x2 <= x1 or y2 <= y1:
            continue
        color = PALETTE[int(label) % len(PALETTE)]
        d.rectangle([x1, y1, x2, y2], outline=color, width=3)
        d.text((x1 + 2, y1 + 2), f"{class_names[int(label)]} {score:.2f}", fill=color)
    return out


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("--video and --output-video need OpenCV (cv2), which is not "
                           "installed here; pass the frames as --input-folder instead") from e
    return cv2


class FolderVideo:
    """An image folder as a streaming pseudo-dataset."""

    def __init__(self, folder: str, suffix: str = ".JPEG"):
        self.files = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                            if f.endswith(suffix))
        if not self.files:
            raise FileNotFoundError(f"no {suffix} files in {folder}")
        self.h0, self.w0 = self.load_image(0).shape[:2]
        self.fps = 25.0

    def __len__(self):
        return len(self.files)

    def load_image(self, idx: int) -> np.ndarray:
        return decode_rgb(self.files[idx])

    def load_frame(self, pattern, frame) -> np.ndarray:
        return self.load_image(min(int(frame), len(self) - 1))

    def get_img_info(self, idx: int) -> dict:
        return {"height": self.h0, "width": self.w0}

    def sample(self, idx: int, max_offset: int, global_size: int, method: str) -> dict:
        """Frame ``idx`` as the method's streaming sample: its reference the
        frame ``max_offset`` ahead (clamped), MEGA's global frames drawn by
        RandomState(0) (``global_size`` at frame 0, one after), DFF's key
        every 10 frames."""
        s = {"cur": self.load_image(idx), "idx": idx}
        stream = dict(frame_category=0 if idx == 0 else 1, seg_len=len(self),
                      pattern="%06d", frame_id=idx)
        nxt = min(idx + max_offset, len(self) - 1)
        if method in ("rdn", "fgfa"):
            s.update(stream, ref=[self.load_image(nxt)])
        elif method == "mega":
            n_g = global_size if idx == 0 else 1
            g_ids = np.random.RandomState(0).choice(len(self), size=min(n_g, len(self)))
            s.update(stream, ref_l=[self.load_image(nxt)],
                     ref_g=[self.load_image(int(i)) for i in g_ids])
        elif method == "dff":
            s.update(is_key_frame=idx % 10 == 0, frame_id=idx, seg_len=len(self),
                     pattern="%06d")
        return s


class FileVideo(FolderVideo):
    """A video file (OpenCV) as a streaming pseudo-dataset: frames decode
    lazily, with a positional seek where the read is not the next frame
    (MEGA's global frames)."""

    def __init__(self, path: str):
        cv2 = _cv2()
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open video {path}")
        self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.w0 = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.h0 = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 25.0
        self._next = 0

    def __len__(self):
        return self._n

    def load_image(self, idx: int) -> np.ndarray:
        idx = min(max(int(idx), 0), self._n - 1)
        if idx != self._next:
            self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = self._cap.read()
        if not ok:
            raise IOError(f"failed to decode frame {idx}")
        self._next = idx + 1
        return np.ascontiguousarray(frame[:, :, ::-1])  # BGR → RGB


class VideoDataset:
    """A video as the dataset ``StreamingInferencer`` reads: samples with an
    empty ground truth, frames, image sizes."""

    def __init__(self, video: FolderVideo, method: str, cfg):
        self.video, self.method = video, method
        v = cfg.MODEL.VID
        self.max_offset = {"rdn": v.RDN.MAX_OFFSET, "mega": v.MEGA.MAX_OFFSET,
                           "fgfa": v.FGFA.MAX_OFFSET}.get(method, 0)
        self.global_size = v.MEGA.GLOBAL.SIZE

    def __len__(self):
        return len(self.video)

    def __getitem__(self, idx: int) -> dict:
        s = self.video.sample(idx, self.max_offset, self.global_size, self.method)
        s["gt"] = {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int64)}
        return s

    def load_frame(self, pattern, frame) -> np.ndarray:
        return self.video.load_frame(pattern, frame)

    def get_img_info(self, idx: int) -> dict:
        return self.video.get_img_info(idx)


def run_demo(model, method: str, prep, video: FolderVideo, dataset: VideoDataset,
             output_folder: str, thresh: float, writer=None, logger=None) -> dict:
    """Every frame of ``video`` through ``StreamingInferencer``, drawn and
    written as ``{idx:06d}.jpg`` (and to ``writer``, an OpenCV writer);
    returns {idx: prediction dict in the frame's coordinates}."""
    from ..engine.batched_inference import _to_host
    from ..engine.inference import StreamingInferencer, _extract

    runner = StreamingInferencer(model, method, prep, dataset)
    preds = {}
    for idx in range(len(video)):
        raw = dataset[idx]
        sample = prep(raw)
        dets = _to_host(runner.step(sample))
        preds[idx] = _extract(dets, sample["cur_size"][0], (video.h0, video.w0))
        img = draw(raw["cur"], preds[idx], VID_CLASSES, thresh)
        img.save(os.path.join(output_folder, f"{idx:06d}.jpg"))
        if writer is not None:
            writer.write(np.asarray(img)[:, :, ::-1])  # RGB → BGR
        if logger and (idx + 1) % 20 == 0:
            logger.info(f"visualized {idx + 1}/{len(video)}")
    return preds


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="detection demo over a frame folder or video")
    parser.add_argument("--preset", default="mega_R_101")
    parser.add_argument("--checkpoint", default=None,
                        help="a mega.pytorch .pth to load in place of MODEL.WEIGHT")
    parser.add_argument("--input-folder", default=None)
    parser.add_argument("--video", default=None, help="an input video file instead of a folder")
    parser.add_argument("--output-folder", required=True)
    parser.add_argument("--output-video", default=None,
                        help="also encode the annotated frames into this video file")
    parser.add_argument("--suffix", default=".JPEG")
    parser.add_argument("--confidence-threshold", type=float, default=0.7)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; nothing falls back to the CPU")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    if (args.input_folder is None) == (args.video is None):
        parser.error("pass exactly one of --input-folder / --video")
    return args


def main(argv=None) -> dict:
    """Runs the demo; returns {"predictions": {idx: dict}, "output_folder": path}."""
    from ..config import get_preset
    from ..data.loader import eval_preprocessor
    from ..models.detectors import build_detection_model
    from ..utils.logger import setup_logger
    from ..utils.model_ingest import load_reference_weights

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("demo: no CUDA card here; --device cpu runs on the CPU")
    cfg = get_preset(args.preset)
    opts = args.opts[1:] if args.opts and args.opts[0] == "opts" else args.opts
    if opts:
        cfg.merge_from_list(opts)
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    logger = setup_logger("mega_pytorch_tpu_torch.demo", None)
    model = build_detection_model(cfg, device, torch.Generator(device).manual_seed(0))
    weight = args.checkpoint or cfg.MODEL.WEIGHT
    if weight and os.path.exists(weight):
        load_reference_weights(weight, model, logger)
        logger.info(f"loaded {weight}")
    else:
        logger.info(f"no checkpoint at {weight!r}: weights drawn from seed 0")

    video = FileVideo(args.video) if args.video else FolderVideo(args.input_folder,
                                                                 args.suffix)
    os.makedirs(args.output_folder, exist_ok=True)
    writer = None
    if args.output_video:
        cv2 = _cv2()
        fourcc = cv2.VideoWriter_fourcc(*("mp4v" if args.output_video.endswith(".mp4")
                                          else "MJPG"))
        writer = cv2.VideoWriter(args.output_video, fourcc, video.fps, (video.w0, video.h0))
        if not writer.isOpened():
            raise IOError(f"cannot open video writer {args.output_video}")
    try:
        preds = run_demo(model, method, eval_preprocessor(cfg), video,
                         VideoDataset(video, method, cfg), args.output_folder,
                         args.confidence_threshold, writer, logger)
    finally:
        if writer is not None:
            writer.release()
    logger.info(f"wrote {len(preds)} frames to {args.output_folder}"
                + (f" and {args.output_video}" if writer is not None else ""))
    return {"predictions": preds, "output_folder": args.output_folder}


if __name__ == "__main__":
    main()
