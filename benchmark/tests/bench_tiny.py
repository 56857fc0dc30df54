"""Tiny cells for the harness's CPU tests: the benchmark's configurations and
settings with the sizes cut (canvas, proposals, window, pooler) and the
port's preset cut alike through ``port_opts``, in float32."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.spec import Cell, load_json  # noqa: E402

CELLS = {"mega": "mega_r101.offline_l12", "fgfa": "fgfa_r101.offline_l4"}


def tiny_cell(method: str = "mega", **settings) -> Cell:
    c = load_json(ROOT / "benchmark" / "configs" / f"{method}_r101.json")
    sizes = dict(canvas=[64, 96], pooler_resolution=2, post_nms_top_n_test=20,
                 ref_post_nms_top_n=5, pre_nms_top_n_test=200, ref_pre_nms_top_n=200,
                 detections_per_img=50, compute_dtype="float32")
    opts = {"MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION": 2, "MODEL.RPN.POST_NMS_TOP_N_TEST": 20,
            "MODEL.VID.RPN.REF_POST_NMS_TOP_N": 5, "MODEL.RPN.PRE_NMS_TOP_N_TEST": 200,
            "MODEL.VID.RPN.REF_PRE_NMS_TOP_N": 200, "MODEL.ROI_HEADS.DETECTIONS_PER_IMG": 50,
            "TPU.COMPUTE_DTYPE": "float32"}
    key = "MEGA" if method == "mega" else "FGFA"
    window = dict(all_frame_interval=7, key_frame_location=3) if method == "mega" else \
        dict(all_frame_interval=5, key_frame_location=2)
    sizes.update(window)
    opts.update({f"MODEL.VID.{key}.ALL_FRAME_INTERVAL": window["all_frame_interval"],
                 f"MODEL.VID.{key}.KEY_FRAME_LOCATION": window["key_frame_location"]})
    if method == "mega":
        sizes.update(memory_size=4, global_size=3)
        opts.update({"MODEL.VID.MEGA.MEMORY.SIZE": 4, "MODEL.VID.MEGA.GLOBAL.SIZE": 3})
    c.update(sizes)
    c["port_opts"] = {**c.get("port_opts", {}), **opts}
    traffic = {"generator": "lockstep_videos", "lanes": 2, "video_frames": [4, 9],
               "pool_frames": 6, "image_size": [60, 90]}
    real = load_json(ROOT / "benchmark" / "workloads" / f"{CELLS[method]}.json")
    real.update(min_step_s=0.05, trace_steps=2, compare_frames=3)
    real.update(settings)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return Cell(name="tiny", chips=1, config=c, traffic=traffic, settings=real,
                end_to_end=[m for m in bench["end_to_end"]
                            if CELLS[method] in m.get("workloads", [CELLS[method]])])


def tiny_train_cell(**settings) -> Cell:
    """The training cell at a tiny size: 4 ranks on the CPU (gloo)."""
    cell = tiny_cell("mega")
    c = cell.config
    c.update(pre_nms_top_n_train=200, post_nms_top_n_train=20, roi_batch_size=16,
             rpn_batch_size=32)
    c["port_opts"].update({"MODEL.RPN.PRE_NMS_TOP_N_TRAIN": 200,
                           "MODEL.RPN.POST_NMS_TOP_N_TRAIN": 20,
                           "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 16,
                           "MODEL.RPN.BATCH_SIZE_PER_IMAGE": 32})
    traffic = load_json(ROOT / "benchmark" / "traffic" / "train_vid4.json")
    traffic.update(image_size=[60, 90], pool_per_rank=4)
    real = {"driver": "train_ddp", "trace_steps": 1,
            "ranges": {"backbone": "method backbone.forward",
                       "rpn_postprocess": "function rpn_postprocess", "nms": "function nms"}}
    real.update(settings)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return Cell(name="tiny_train", chips=4, config=c, traffic=traffic, settings=real,
                end_to_end=[m for m in bench["end_to_end"]
                            if "mega_r101.train_ddp4" in m.get("workloads", ["mega_r101.train_ddp4"])])
