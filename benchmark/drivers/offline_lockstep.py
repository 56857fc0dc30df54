"""Offline lockstep inference: L lanes of back-to-back synthetic videos
through the port's lockstep step, every emitting step's detections copied
to the host, as ``engine/batched_inference.compute_on_dataset_lockstep``
does; frames come from a pool of seeded canvases on the card, so the host
producer is out of the loop.

MEGA runs ``make_lockstep_step`` (window, memory, global cache), RDN and
FGFA ``make_lockstep_step_windowed``. After the window, the program's state
is freed and a sample of the videos (drawn from the seed, those that
started inside the window first) is recomputed by the plain reference
from each video's start and compared."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..harness import compare, flops, trace
from ..harness.result import percentile
from ..harness.spec import Cell, metric_reader
from ..harness.traffic import make_lane, video_steps
from ..harness.weights import calibrated_weights, draw_frames
from ..reference import vid
from ..reference.ops import Precision, float32_matmul, normalize_frames

# the port's configuration keys that the configuration file states
PORT_KEYS = {
    "num_classes": "MODEL.ROI_BOX_HEAD.NUM_CLASSES",
    "anchor_sizes": "MODEL.RPN.ANCHOR_SIZES",
    "aspect_ratios": "MODEL.RPN.ASPECT_RATIOS",
    "pre_nms_top_n_test": "MODEL.RPN.PRE_NMS_TOP_N_TEST",
    "post_nms_top_n_test": "MODEL.RPN.POST_NMS_TOP_N_TEST",
    "ref_pre_nms_top_n": "MODEL.VID.RPN.REF_PRE_NMS_TOP_N",
    "ref_post_nms_top_n": "MODEL.VID.RPN.REF_POST_NMS_TOP_N",
    "rpn_nms_thresh": "MODEL.RPN.NMS_THRESH",
    "pooler_resolution": "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION",
    "mlp_dim": "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM",
    "res5_dilation": "MODEL.RESNETS.RES5_DILATION",
    "reduce_channel": "MODEL.VID.ROI_BOX_HEAD.REDUCE_CHANNEL",
    "score_thresh": "MODEL.ROI_HEADS.SCORE_THRESH",
    "nms_thresh": "MODEL.ROI_HEADS.NMS",
    "detections_per_img": "MODEL.ROI_HEADS.DETECTIONS_PER_IMG",
    "bbox_reg_weights": "MODEL.ROI_HEADS.BBOX_REG_WEIGHTS",
    "compute_dtype": "TPU.COMPUTE_DTYPE",
}
METHOD_KEYS = {
    "all_frame_interval": "ALL_FRAME_INTERVAL", "key_frame_location": "KEY_FRAME_LOCATION",
}
TRAIN_KEYS = {
    "pre_nms_top_n_train": "MODEL.RPN.PRE_NMS_TOP_N_TRAIN",
    "post_nms_top_n_train": "MODEL.RPN.POST_NMS_TOP_N_TRAIN",
    "roi_batch_size": "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE",
    "roi_positive_fraction": "MODEL.ROI_HEADS.POSITIVE_FRACTION",
    "rpn_batch_size": "MODEL.RPN.BATCH_SIZE_PER_IMAGE",
    "rpn_positive_fraction": "MODEL.RPN.POSITIVE_FRACTION",
    "max_gt_boxes": "TPU.MAX_GT_BOXES", "freeze_at": "MODEL.BACKBONE.FREEZE_CONV_BODY_AT",
    "solver.ims_per_batch": "SOLVER.IMS_PER_BATCH", "solver.base_lr": "SOLVER.BASE_LR",
    "solver.momentum": "SOLVER.MOMENTUM", "solver.weight_decay": "SOLVER.WEIGHT_DECAY",
    "solver.weight_decay_bias": "SOLVER.WEIGHT_DECAY_BIAS",
    "solver.bias_lr_factor": "SOLVER.BIAS_LR_FACTOR",
    "solver.warmup_factor": "SOLVER.WARMUP_FACTOR", "solver.warmup_iters": "SOLVER.WARMUP_ITERS",
    "solver.warmup_method": "SOLVER.WARMUP_METHOD",
}
MEGA_KEYS = {"ratio": "MODEL.VID.MEGA.RATIO", "memory_size": "MODEL.VID.MEGA.MEMORY.SIZE",
             "global_size": "MODEL.VID.MEGA.GLOBAL.SIZE",
             "global_res_stage": "MODEL.VID.MEGA.GLOBAL.RES_STAGE",
             "attention.stages": "MODEL.VID.ROI_BOX_HEAD.ATTENTION.STAGE",
             "attention.embed_dim": "MODEL.VID.ROI_BOX_HEAD.ATTENTION.EMBED_DIM",
             "attention.groups": "MODEL.VID.ROI_BOX_HEAD.ATTENTION.GROUP"}


def _get(node, path: str):
    for p in path.split("."):
        node = node[p]
    return node


def _set(node, path: str, value) -> None:
    parts = path.split(".")
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = type(node[parts[-1]])(value) if isinstance(node[parts[-1]], tuple) \
        else value


def port_config(c: dict):
    """The port's preset with the file's canvas and ``port_opts``, checked
    key by key against the file."""
    from mega_pytorch_tpu_torch.config import get_preset

    cfg = get_preset(c["preset"])
    cfg.TPU.CANVAS_HEIGHT, cfg.TPU.CANVAS_WIDTH = c["canvas"]
    for path, value in c.get("port_opts", {}).items():
        _set(cfg, path, value)
    keys = dict(PORT_KEYS)
    keys.update({k: f"MODEL.VID.{c['method'].upper()}.{v}" for k, v in METHOD_KEYS.items()})
    if c["method"] == "mega":
        keys.update(MEGA_KEYS)
    if "solver" in c:
        keys.update(TRAIN_KEYS)
    bad = []
    for key, path in keys.items():
        want = c
        for p in key.split("."):
            want = want[p]
        have = _get(cfg, path)
        if (list(have) if isinstance(have, (tuple, list)) else have) != want:
            bad.append(f"{key}: file {want!r}, port {path} {have!r}")
    if "-".join(cfg.MODEL.BACKBONE.CONV_BODY.split("-")[:2]) != c["depth"]:
        bad.append(f"depth: file {c['depth']}, port {cfg.MODEL.BACKBONE.CONV_BODY}")
    if bad:
        raise ValueError("configuration file and port preset differ: " + "; ".join(bad))
    return cfg


def build_model(c: dict, P: dict, lanes: int, device):
    """The port's detector of the configuration, holding the weights ``P``."""
    from mega_pytorch_tpu_torch.models.detectors import detection_model

    model = detection_model(port_config(c), device)
    model.load_state_dict(P, strict=True)
    model.cast_weights_()
    model.lanes = lanes
    return model.eval().requires_grad_(False)


def model_input(method: str, frames: torch.Tensor) -> torch.Tensor:
    """The (N, H, W, 3) u8 canvases in the form the port's engine feeds its
    model (``engine/batched_inference.pack_frames``), on the same device."""
    from mega_pytorch_tpu_torch.engine.batched_inference import pack_frames

    return torch.as_tensor(pack_frames(method, frames.cpu().numpy())).to(frames.device)


def host_copy(dets) -> np.ndarray:
    """One device→host copy of a step's detections: (L, D, 7) boxes, score,
    label, valid."""
    return torch.cat([dets.boxes, dets.scores[..., None], dets.labels[..., None].float(),
                      dets.valid[..., None].float()], -1).cpu().numpy()


class Run:
    """One run of an offline lockstep cell."""

    def __init__(self, cell: Cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.c, self.t, self.s = cell.config, cell.traffic, cell.settings
        self.mega = self.c["method"] == "mega"
        self.lanes = self.t["lanes"]
        self.size = tuple(self.t["image_size"])

    # -- set-up ----------------------------------------------------------------
    def setup(self, max_steps: int) -> None:
        c, dev = self.c, self.device
        self.P = calibrated_weights(c, c["weights_seed"], dev, self.size)
        gen = torch.Generator(dev).manual_seed((self.seed + 1) % 2 ** 63)
        self.pool = draw_frames(self.t["pool_frames"], c["canvas"], gen, dev)
        self.pool_in = model_input(c["method"], self.pool)
        self.model = build_model(c, self.P, self.lanes, dev)
        self.warmup = c["all_frame_interval"] - c["key_frame_location"] - 1
        gsize = c["global_size"] if self.mega else 0
        self.lane_plans = [make_lane(self.t, self.seed, i, max_steps, self.warmup, gsize)
                           for i in range(self.lanes)]

        def col(name):
            return np.stack([getattr(p, name) for p in self.lane_plans], 1)

        local, gpool = col("local"), col("gpool")
        self.emit_np = col("emit")
        self.local = torch.as_tensor(local, device=dev)
        self.gsel = torch.as_tensor(np.where(gpool >= 0, gpool, local), device=dev)
        self.resets = torch.as_tensor(col("reset"), device=dev)
        self.gmasks = torch.as_tensor(gpool >= 0, device=dev)
        self.emits = torch.as_tensor(self.emit_np >= 0, device=dev)
        self.sizes = torch.tensor([self.size] * self.lanes, dtype=torch.float32, device=dev)
        self.step = self.make_step(self.model)
        self.carries = self.model.zero_carry(self.lanes, dev) if self.mega else None
        self.outputs: dict = {}  # engine step -> (L, D, 7) host detections
        self.next_step = 0

    def make_step(self, model):
        from mega_pytorch_tpu_torch.engine.batched_inference import (
            make_lockstep_step, make_lockstep_step_windowed)

        return (make_lockstep_step if self.mega else make_lockstep_step_windowed)(model)

    def one_step(self) -> float:
        """Run the next engine step; its seconds from start to detections on
        the host (0.0 where no lane emits: nothing is copied)."""
        s = self.next_step
        t0 = time.perf_counter()
        frames = self.pool_in.index_select(0, self.local[s])
        if self.mega:
            gframes = self.pool_in.index_select(0, self.gsel[s])
            self.carries, dets = self.step(self.carries, frames, self.sizes, gframes,
                                           self.sizes, self.resets[s], self.gmasks[s],
                                           self.emits[s])
        else:
            self.carries, dets = self.step(self.carries, frames, self.sizes, self.resets[s])
        self.next_step += 1
        if (self.emit_np[s] >= 0).any():
            self.outputs[s] = host_copy(dets)
            return time.perf_counter() - t0
        return 0.0

    def warm(self) -> None:
        """The first steps up to the first emission: every shape and path."""
        for _ in range(self.warmup + 1):
            self.one_step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        first = self.next_step
        times = []
        end = len(self.emit_np) - self.s["trace_steps"]
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds and self.next_step < end:
            times.append(self.one_step())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t_start
        frames = int((self.emit_np[first:self.next_step] >= 0).sum())
        emitting = [t for t in times if t > 0]
        return {"first": first, "steps": len(times), "wall_s": wall, "frames": frames,
                "frames_per_s": frames / wall, "step_ms_p95": percentile(emitting, 95) * 1e3,
                "step_ms_mean": wall / len(times) * 1e3}

    # -- trace ----------------------------------------------------------------------
    def traced(self, steps: int) -> dict:
        """Trace ``steps`` steps inside the workload's declared ranges."""
        expected = self.s["ranges"]

        def run():
            for _ in range(steps):
                self.one_step()
            torch.cuda.synchronize(self.device)

        # the step looks the wrapped names up per call
        with trace.layer_ranges(*trace.declared_ranges(self.model, expected)):
            events, wall = trace.profile(run, steps)
        summary = trace.summarize(events, wall, steps, expected)
        trace.check_ranges(summary, expected)
        return summary

    # -- correctness ----------------------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.step = self.carries = self.model = self.pool_in = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, window_first: int) -> list:
        """[(lane, video)] to compare: videos that reset inside the window and
        emitted ``compare_frames`` frames, drawn from the seed, alternating
        the two halves of the lanes; then the lanes' first videos."""
        need = self.s["compare_frames"]
        last = self.next_step - 1
        rng = np.random.default_rng([self.seed % 2 ** 63, 7919])
        started, first = [], []
        for lane, plan in enumerate(self.lane_plans):
            for vi, v in enumerate(plan.videos):
                done = v.start + self.warmup + need - 1 <= last
                if done and v.start >= window_first:
                    started.append((lane, vi))
                elif done and vi == 0:
                    first.append((lane, vi))
        picks = []
        for pool in (started, first):
            order = [pool[i] for i in rng.permutation(len(pool))]
            halves = ([p for p in order if p[0] < self.lanes // 2],
                      [p for p in order if p[0] >= self.lanes // 2])
            while len(picks) < self.s["compare_videos"] and (halves[0] or halves[1]):
                for h in halves:
                    if h and len(picks) < self.s["compare_videos"]:
                        picks.append(h.pop(0))
        return picks

    def program_dets(self, lane: int, vi: int) -> dict:
        v = self.lane_plans[lane].videos[vi]
        out = {}
        for f in range(self.s["compare_frames"]):
            row = self.outputs[v.start + self.warmup + f][lane]
            ok = row[:, 6] > 0.5
            out[f] = {"boxes": row[ok, :4], "scores": row[ok, 4], "labels": row[ok, 5]}
        return out

    def reference_dets(self, lane: int, vi: int, mode: str, probes=None) -> dict:
        """{frame: (dets, class probabilities at ``probes[frame]`` or None)} of
        the reference at precision ``mode`` over the first frames of a video."""
        v = self.lane_plans[lane].videos[vi]
        pool, size, c = self.t["pool_frames"], self.size, self.c
        prec = Precision(mode)

        def frame_fn(i):
            return normalize_frames(self.pool[v.pool_index(i, pool)][None], [size]), size

        n = self.s["compare_frames"]
        with torch.no_grad(), float32_matmul():
            if self.mega:
                steps = video_steps(v, self.warmup, c["global_size"])
                return vid.mega_video(frame_fn, steps, n - 1, self.P, c, prec, probes)
            return vid.fgfa_video(frame_fn, v.frames, list(range(n)), self.P, c, prec, probes)

    def compare(self, picks: list, control: bool = False) -> dict:
        """The comparison numbers of the picked videos: the program's
        detections against the float32 reference ("program") and, with
        ``control``, the float8 control's ("control"); one float32 pass
        scores both sides' boxes."""
        sides = {"program": {}, "control": {}}
        pairs = {"program": [], "control": []}
        for lane, vi in picks:
            sides["program"] = self.program_dets(lane, vi)
            if control:
                sides["control"] = {f: d for f, (d, _) in
                                    self.reference_dets(lane, vi, "float8").items()}
            names = [k for k in sides if sides[k]]
            probes = {}
            for f in sides["program"]:
                boxes = [torch.as_tensor(sides[k][f]["boxes"], dtype=torch.float32,
                                         device=self.device) for k in names]
                probes[f] = torch.cat(boxes) if sum(map(len, boxes)) else None
            ref = self.reference_dets(lane, vi, "float32", probes)
            for f in sorted(ref):
                (dets, probs), start = ref[f], 0
                for k in names:
                    n = len(sides[k][f]["boxes"])
                    pairs[k].append((sides[k][f], None if probs is None
                                     else probs[start:start + n], dets))
                    start += n
        out = {"program": compare.run_stats(pairs["program"], self.c["nms_thresh"])}
        if control:
            out["control"] = compare.run_stats(pairs["control"], self.c["nms_thresh"])
        return out


def max_steps(seconds: float, settings: dict) -> int:
    return int(math.ceil(seconds / settings["min_step_s"])) + 64 + settings["trace_steps"]


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, t_process: float,
        device="cuda", make_step=None) -> tuple[dict, list]:
    """One run → (result without ``checks``, checks). ``make_step(run, model)``,
    where given, makes the step in place of the port's (the fault tests)."""
    r = Run(cell, seed, device)
    if make_step is not None:
        r.make_step = lambda model: make_step(r, model)
    with torch.no_grad():
        r.setup(max_steps(seconds, cell.settings))
        r.warm()
    setup_s = time.time() - t_process
    w = r.window(seconds)
    w["setup_s"] = setup_s
    summary = r.traced(cell.settings["trace_steps"]) if trace_on else None
    with torch.no_grad():  # answers due later than the window: wait for them
        while not r.sample(w["first"]) and r.next_step < len(r.emit_np):
            r.one_step()
    peak = (max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips))
            if r.device.type == "cuda" else 0)
    r.release()
    picks = r.sample(w["first"])
    numbers = r.compare(picks)["program"]
    ok, checks = compare.judge(numbers, cell.settings["limits"])
    metrics = {}
    values = {"frames_per_s": w["frames_per_s"], "step_ms_p95": w["step_ms_p95"],
              "setup_s": setup_s}
    if not trace_on:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"trace": summary, "window": w, "lanes": r.lanes, "config": r.c,
               "image_size": r.size, "peak_bytes": peak,
               "frames_per_step": r.lanes * (2 if r.mega else 1),
               "step_flops": flops.step_flops(r.c, r.P, r.size, r.lanes, r.device)}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok, "attempted": w["frames"], "failed": 0, "metrics": metrics,
              "seed": seed, "window": w, "compared": {"videos": picks, **numbers},
              "memory_peak_bytes": peak}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        result["trace"] = {k: v for k, v in summary.items() if k != "kernel_s"}
    return result, checks
