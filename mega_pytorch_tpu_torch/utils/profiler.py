"""Profiling hooks (counterpart of ``mega_pytorch_tpu/utils/profiler.py``):
a ``torch.profiler`` trace of a block, written as a Chrome trace; a named
range that shows in such a trace; and the card's live and peak memory
(the reference logs ``torch.cuda.max_memory_allocated``)."""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block, CPU and (where there is a card) CUDA
    activity, into ``log_dir/trace.json``; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """{"bytes_in_use", "peak_bytes_in_use"} of the current card's caching
    allocator (tensors allocated now, and at most since the last reset of
    the peak); zeros where there is no card."""
    if not torch.cuda.is_available():
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0}
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
