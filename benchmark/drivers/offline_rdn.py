"""Offline lockstep inference of RDN: ``offline_lockstep``'s lanes, traffic,
window, trace and comparison, with RDN's own weights (``reference/rdn.py``'s
parameter list, drawn and calibrated as ``harness/weights.py`` does), the
port's RDN preset checked against the configuration file's RDN keys, the
plain reference ``rdn_video`` and the FLOPs of one lane-step of it.

The port runs ``make_lockstep_step_windowed``: each step pushes every
lane's frame into its 37-frame window and detects at the key slot."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..harness import compare, flops
from ..harness.spec import Cell, metric_reader
from ..harness.traffic import make_lane
from ..harness.weights import SERVED, TRUNC_STD, draw_frames
from ..reference import rdn, vid
from ..reference.ops import Precision, float32_matmul, normalize_frames
from ..reference.params import CONST, LECUN
from . import offline_lockstep as ol

# the configuration file's RDN keys and the port's
RDN_KEYS = {"ratio": "MODEL.VID.RDN.RATIO",
            "attention.base_stages": "MODEL.VID.ROI_BOX_HEAD.ATTENTION.STAGE",
            "attention.advanced_stages": "MODEL.VID.ROI_BOX_HEAD.ATTENTION.ADVANCED_STAGE",
            "attention.embed_dim": "MODEL.VID.ROI_BOX_HEAD.ATTENTION.EMBED_DIM",
            "attention.groups": "MODEL.VID.ROI_BOX_HEAD.ATTENTION.GROUP"}


def check_rdn_keys(c: dict) -> None:
    """``offline_lockstep.port_config``'s checks, and RDN's keys."""
    cfg = ol.port_config(c)
    bad = [f"{key}: file {ol._get(c, key)!r}, port {path} {ol._get(cfg, path)!r}"
           for key, path in RDN_KEYS.items() if ol._get(c, key) != ol._get(cfg, path)]
    if bad:
        raise ValueError("configuration file and port preset differ: " + "; ".join(bad))


def draw_weights(c: dict, gen: torch.Generator, device) -> dict:
    """``harness/weights.draw_weights`` over RDN's parameter list."""
    spec = rdn.param_spec(c)
    served = SERVED[c["compute_dtype"]]
    out = {}
    for kind in (LECUN, "normal"):
        items = [s for s in spec if s[2][0] == kind]
        buf = torch.empty(sum(math.prod(shape) for _, shape, _ in items), device=device)
        if kind == LECUN:
            torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=gen)
        else:
            buf.normal_(0.0, 1.0, generator=gen)
        pos = 0
        for name, shape, (_, arg) in items:
            n = math.prod(shape)
            std = math.sqrt(1.0 / arg) / TRUNC_STD if kind == LECUN else arg
            out[name] = (buf[pos:pos + n] * std).to(served).float().reshape(shape)
            pos += n
    for name, shape, (kind, value) in spec:
        if kind == CONST:
            out[name] = torch.full(shape, value, device=device)
    return out


def calibrated_weights(c: dict, seed: int, device, image_size) -> dict:
    """RDN's weights from ``seed`` with FrozenBN statistics calibrated on
    two seeded frames (``harness/weights.calibrated_weights``)."""
    gen = torch.Generator(device).manual_seed(seed % 2 ** 63)
    P = draw_weights(c, gen, device)
    frames = draw_frames(2, c["canvas"], gen, device)
    with torch.no_grad(), float32_matmul():
        P.update(vid.calibrate(normalize_frames(frames, [image_size] * 2), P, c))
    return P


def step_flops(c: dict, P: dict, image_size, lanes: int, device) -> int:
    """FLOPs of one lockstep step: the reference's new frame (backbone,
    res5, RPN, fc0) and the key's detection over a full window of random
    entries, times the lanes (``harness/flops.py``)."""
    gen = torch.Generator(device).manual_seed(0)
    h, w = c["canvas"]
    n, d = c["post_nms_top_n_test"], c["mlp_dim"]
    prec = Precision()
    img = torch.randn((1, 3, h, w), generator=gen, device=device) * 50

    def rand_entry():
        xy = torch.rand((n, 2), generator=gen, device=device) * (w / 2)
        boxes = torch.cat([xy, xy + 32 + torch.rand((n, 2), generator=gen, device=device)
                           * (w / 2)], 1)
        return vid.Entry(boxes, torch.ones(n, dtype=torch.bool, device=device),
                         torch.rand((n, d), generator=gen, device=device))

    window = [rand_entry() for _ in range(c["all_frame_interval"])]

    def run():
        rdn.rdn_frame(img, image_size, P, c, prec)
        rdn.rdn_detect(window[c["key_frame_location"]], window, image_size, P, c, prec)

    with torch.no_grad():
        return lanes * flops.count(run)


class Run(ol.Run):
    """One run of the RDN cell."""

    def setup(self, max_steps: int) -> None:
        c, dev = self.c, self.device
        check_rdn_keys(c)
        self.P = calibrated_weights(c, c["weights_seed"], dev, self.size)
        gen = torch.Generator(dev).manual_seed((self.seed + 1) % 2 ** 63)
        self.pool = draw_frames(self.t["pool_frames"], c["canvas"], gen, dev)
        self.pool_in = ol.model_input(c["method"], self.pool)
        self.model = ol.build_model(c, self.P, self.lanes, dev)
        self.warmup = c["all_frame_interval"] - c["key_frame_location"] - 1
        self.lane_plans = [make_lane(self.t, self.seed, i, max_steps, self.warmup, 0)
                           for i in range(self.lanes)]

        def col(name):
            return np.stack([getattr(p, name) for p in self.lane_plans], 1)

        self.emit_np = col("emit")
        self.local = torch.as_tensor(col("local"), device=dev)
        self.resets = torch.as_tensor(col("reset"), device=dev)
        self.sizes = torch.tensor([self.size] * self.lanes, dtype=torch.float32, device=dev)
        self.step = self.make_step(self.model)
        self.carries = None
        self.outputs = {}
        self.next_step = 0

    def reference_dets(self, lane: int, vi: int, mode: str, probes=None) -> dict:
        v = self.lane_plans[lane].videos[vi]
        pool, size = self.t["pool_frames"], self.size

        def frame_fn(i):
            return normalize_frames(self.pool[v.pool_index(i, pool)][None], [size]), size

        with torch.no_grad(), float32_matmul():
            return rdn.rdn_video(frame_fn, v.frames, list(range(self.s["compare_frames"])),
                                 self.P, self.c, Precision(mode), probes)


max_steps = ol.max_steps


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, t_process: float,
        device="cuda", make_step=None) -> tuple[dict, list]:
    """``offline_lockstep.run`` for RDN: one run → (result without
    ``checks``, checks)."""
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
    peak = torch.cuda.max_memory_allocated(r.device) if r.device.type == "cuda" else 0
    r.release()
    picks = r.sample(w["first"])
    numbers = r.compare(picks)["program"]
    ok, checks = compare.judge(numbers, cell.settings["limits"])
    metrics = {}
    if not trace_on:
        values = {"frames_per_s": w["frames_per_s"], "step_ms_p95": w["step_ms_p95"],
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"trace": summary, "window": w, "lanes": r.lanes, "config": r.c,
               "image_size": r.size, "peak_bytes": peak, "frames_per_step": r.lanes,
               "step_flops": step_flops(r.c, r.P, r.size, r.lanes, r.device)}
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
