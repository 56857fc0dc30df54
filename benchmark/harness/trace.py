"""Ranges around the program's layers and the arithmetic of a
``torch.profiler`` trace (from the port's ``tools/profile_stream.py``
``_union_us`` / ``_trace_summary`` and ``tools/profile_mfu.py``
``_nms_ranges`` / ``device_time_by_family``, copied so the yardstick stays
put).

Ranges are ``record_function`` spans opened by wrappers that the benchmark
puts around the program's functions and methods (no synchronisation
added); device time is attributed to a range through the correlation ids
of the launches made inside it. A cell lists the ranges it expects in its
workload file (``ranges``: {range: "method model.attribute" or "function
name"}); a range that finds nothing to wrap, or that records no device
time in the traced stretch, fails the traced run, so a renamed or inlined
function cannot take a layer's metric out of sight."""

from __future__ import annotations

import json
import sys
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
PACKAGE = "mega_pytorch_tpu_torch"


def _ranged(name, fn):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    wrapper.__wrapped__ = fn
    return wrapper


class RangeError(RuntimeError):
    """A declared range found nothing to wrap or recorded no device time."""


def declared_ranges(model, spec: dict) -> tuple[dict, dict]:
    """A workload's ``ranges`` → (objects, functions) for ``layer_ranges``:
    "method a.b.c" wraps attribute c of ``model.a.b``, "function f" the
    program's function f wherever a module of the program holds it."""
    objects, functions = {}, {}
    for rng, where in spec.items():
        kind, path = where.split()
        if kind == "function":
            functions[rng] = path
            continue
        *owner, attr = path.split(".")
        obj = model
        for part in owner:
            if not hasattr(obj, part):
                raise RangeError(f"range {rng!r}: {type(obj).__name__} has no {part!r}")
            obj = getattr(obj, part)
        objects[rng] = (obj, attr)
    return objects, functions


def check_ranges(summary: dict, expected) -> None:
    """Raise ``RangeError`` unless each expected range recorded device time."""
    silent = [r for r in expected if not summary["range_ms_per_step"].get(r, 0.0) > 0.0]
    if silent:
        raise RangeError(f"ranges with no device time in the traced stretch: {silent}; "
                         f"expected {list(expected)}")


@contextmanager
def layer_ranges(objects: dict, functions: dict):
    """Within the context: ``objects`` {range: (object, attribute)} have that
    attribute wrapped on the instance (a module's ``forward``, a model's
    method); ``functions`` {range: function name} are wrapped in every
    module of the program that holds the program's function of that name."""
    undo = []
    for rng, (obj, attr) in objects.items():
        if not callable(getattr(obj, attr, None)):
            raise RangeError(f"range {rng!r}: {type(obj).__name__} has no method {attr!r}")
        had = attr in vars(obj)
        old = getattr(obj, attr)
        setattr(obj, attr, _ranged(rng, old))
        undo.append(lambda o=obj, a=attr, h=had, f=old: setattr(o, a, f) if h else delattr(o, a))
    for rng, fname in functions.items():
        holders = [m for n, m in list(sys.modules.items())
                   if n.split(".")[0] == PACKAGE and callable(getattr(m, fname, None))
                   and getattr(getattr(m, fname), "__module__", "").split(".")[0] == PACKAGE]
        if not holders:
            raise RangeError(f"range {rng!r}: no module of {PACKAGE} holds {fname!r}")
        for m in holders:
            old = getattr(m, fname)
            setattr(m, fname, _ranged(rng, old))
            undo.append(lambda m=m, f=fname, o=old: setattr(m, f, o))
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


def union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def profile(run, steps: int) -> tuple[list, float]:
    """Trace ``run()`` (which runs ``steps`` steps and synchronises) → (events, wall s)."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return events, wall


def summarize(events: list, wall_s: float, steps: int, ranges=()) -> dict:
    """Per step: device busy s, kernel launches, host sync calls, device ms by
    kernel name and by range; the longest idle gaps by the innermost range
    the host was in."""
    spans = [e for e in events if e.get("ph") == "X"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in device if e["cat"] == "kernel"]
    intervals = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_us = union_us(intervals)
    runtime = [e for e in spans if e.get("cat") == "cuda_runtime"]
    annotations = [e for e in spans if e.get("cat") == "user_annotation"]
    by_range = defaultdict(list)  # range -> thread -> [(start, end)]
    for e in annotations:
        by_range[e["name"]].append((e["tid"], e["ts"], e["ts"] + e["dur"]))
    range_ms = {}
    for rng in ranges:
        inside = set()
        spans_r = by_range.get(rng, [])
        for e in runtime:
            corr = e.get("args", {}).get("correlation")
            if corr is not None and any(t == e["tid"] and a <= e["ts"] <= b
                                        for t, a, b in spans_r):
                inside.add(corr)
        range_ms[rng] = sum(e["dur"] for e in device
                            if e.get("args", {}).get("correlation") in inside) / 1e3 / steps
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e["name"][:120]] += e["dur"] / 1e6
    # idle gaps between device intervals, labelled by the innermost range open
    gaps = defaultdict(float)
    end = None
    for start, stop in intervals:
        if end is not None and start > end:
            gaps[_innermost(annotations, end)] += (start - end) / 1e6
        end = stop if end is None else max(end, stop)
    return {
        "steps": steps,
        "wall_s": wall_s,
        "busy_s": busy_us / 1e6,
        "launches_per_step": len(kernels) / steps,
        "syncs_per_step": sum(1 for e in runtime if e["name"] in SYNC_CALLS) / steps,
        "kernel_s": dict(by_name),
        "range_ms_per_step": range_ms,
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10],
    }


def _innermost(annotations, ts) -> str:
    best = None
    for e in annotations:
        if e["ts"] <= ts <= e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
            best = e
    return best["name"] if best else "outside the benchmark's ranges"


def kernel_s(summary: dict, pattern: str, exclude: str | None = None) -> float:
    """Device seconds of the kernels whose names hold ``pattern``."""
    return sum(s for n, s in summary["kernel_s"].items()
               if pattern in n and (exclude is None or exclude not in n))
