"""The RDN cell at a tiny size for the CPU tests: ``rdn_r101``'s configuration
and ``rdn_r101.offline_l12``'s settings with the sizes cut as ``bench_tiny``
cuts the other cells' (canvas, proposals, pooler, window of 5 with the key
at slot 2), the port's preset cut alike through ``port_opts``, in float32.
Every RDN stage stays: 2 base stages, the advanced stage, one distilled ref
a frame (5 refs at ratio 0.2)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.spec import Cell, load_json  # noqa: E402

CELL = "rdn_r101.offline_l12"
SIZES = dict(canvas=[64, 96], pooler_resolution=2, post_nms_top_n_test=20,
             ref_post_nms_top_n=5, pre_nms_top_n_test=200, ref_pre_nms_top_n=200,
             detections_per_img=50, compute_dtype="float32", all_frame_interval=5,
             key_frame_location=2)
OPTS = {"MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION": 2, "MODEL.RPN.POST_NMS_TOP_N_TEST": 20,
        "MODEL.VID.RPN.REF_POST_NMS_TOP_N": 5, "MODEL.RPN.PRE_NMS_TOP_N_TEST": 200,
        "MODEL.VID.RPN.REF_PRE_NMS_TOP_N": 200, "MODEL.ROI_HEADS.DETECTIONS_PER_IMG": 50,
        "TPU.COMPUTE_DTYPE": "float32", "MODEL.VID.RDN.ALL_FRAME_INTERVAL": 5,
        "MODEL.VID.RDN.KEY_FRAME_LOCATION": 2}
IMAGE_SIZE = (60, 90)


def tiny_rdn_config() -> dict:
    c = load_json(ROOT / "benchmark" / "configs" / "rdn_r101.json")
    c.update(SIZES)
    c["port_opts"] = dict(OPTS)
    return c


def tiny_rdn_cell(**settings) -> Cell:
    traffic = {"generator": "lockstep_videos", "lanes": 2, "video_frames": [4, 9],
               "pool_frames": 6, "image_size": list(IMAGE_SIZE)}
    real = load_json(ROOT / "benchmark" / "workloads" / f"{CELL}.json")
    real.update(min_step_s=0.05, trace_steps=2, compare_frames=3)
    real.update(settings)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return Cell(name="tiny_rdn", chips=1, config=tiny_rdn_config(), traffic=traffic,
                settings=real,
                end_to_end=[m for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])],
                per_layer=[m for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])])
