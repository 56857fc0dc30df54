"""The run's result line, the checks printed beside their limits, the device
record, the JAX guard and the set-up clock."""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "mega_pytorch_tpu")


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``mega_pytorch_tpu_torch`` is the port, not the JAX package)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def process_start_time() -> float:
    """Wall-clock time at which this process started (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def device_record(count: int, peak_bytes: int, trace: dict | None = None) -> dict:
    """``peak_bytes``: the peak allocated on the fullest card, as the driver read it."""
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        rec["busy_s"] = trace["busy_s"]
        rec["window_s"] = trace["wall_s"]
    return rec


def emit(result: dict, checks: list) -> None:
    """Print the compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output, the
    checks under the key that comes last."""
    for name, value, limit in checks:
        print(f"check {name} = {value:.6g} (limit {limit:.6g})", file=sys.stderr)
    result["checks"] = {name: {"value": _num(value), "limit": limit}
                        for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def _num(x):
    x = float(x)
    return x if math.isfinite(x) else None


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))
