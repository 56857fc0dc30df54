"""Profiling hooks (counterpart of ``mega_pytorch_tpu/utils/profiler.py``):
a ``torch.profiler`` trace of a block, written as a Chrome trace; the
port's spans and counters; and the card's live and peak memory (the
reference logs ``torch.cuda.max_memory_allocated``).

Spans and counters are the port's one measuring API. They are off unless
a ``torch.profiler`` is recording or the code runs inside ``recording()``;
off, ``annotate(name)`` hands back a shared no-op context and ``count``
returns at once, so neither enters ``record_function`` nor allocates. On,
a span opens ``torch.profiler.record_function(name)`` where a profiler
records (the span shows in its trace, on the device trace's clock) and
keeps its name, parent, step index (the ``lockstep_step`` spans number the
steps), host start and end and, once CUDA is initialised, a pair of CUDA
events on the current stream; a counter adds to a total kept under the
enclosing span. Each thread keeps its own stack of open spans.

One stretch of recording is kept: ``recording()`` and ``trace()`` start a
new one, and so does the first span or count that finds a
``torch.profiler`` recording after a span that found recording off.
``recorded()`` sums the stretch up.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity

STEP_SPAN = "lockstep_step"  # the span that numbers the steps

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans


class _Stretch:
    """What one stretch of recording holds."""

    def __init__(self):
        self.spans: list = []  # in opening order
        self.counters = defaultdict(int)  # (enclosing span's path, name) -> total
        self.steps = 0


_stretch = _Stretch()
_forced = 0  # open recording() contexts
_live = False  # the current stretch is being recorded into


def enabled() -> bool:
    """Spans and counters record: a ``torch.profiler`` is recording, or the
    code runs inside ``recording()``."""
    return bool(_forced or _autograd_profiler._is_profiler_enabled)


def _new_stretch() -> None:
    global _stretch, _live
    with _lock:
        _stretch, _live = _Stretch(), True


def _current() -> _Stretch:
    global _stretch, _live
    if not _live:
        with _lock:
            if not _live:
                _stretch, _live = _Stretch(), True
    return _stretch


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "parent", "path", "step", "thread", "t0", "t1",
                 "events", "_range")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.t1 = self.events = self._range = None

    def __enter__(self):
        stretch = _current()
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        self.path = f"{parent.path}/{self.name}" if parent is not None else self.name
        self.thread = threading.get_ident()
        with _lock:
            if self.name == STEP_SPAN:
                stretch.steps += 1
            self.step = stretch.steps - 1 if stretch.steps else None
            stretch.spans.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        _stack().remove(self)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def annotate(name: str, device: bool = True):
    """A span named ``name``: ``with annotate("nms"): ...``. ``device``
    False for host-only work (no CUDA events)."""
    global _live
    if _forced or _autograd_profiler._is_profiler_enabled:
        return _Span(name, device)
    _live = False
    return _OFF


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` under the enclosing span."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    stretch = _current()
    stack = _stack()
    where = stack[-1].path if stack else ""
    with _lock:
        stretch.counters[(where, name)] += n


@contextlib.contextmanager
def recording():
    """Record the enclosed block's spans and counters (a new stretch)
    without a ``torch.profiler``; ``recorded()`` reads them after."""
    global _forced, _live
    _new_stretch()
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1
            _live = bool(_forced)


def recorded() -> dict:
    """The current stretch: ``steps`` (``lockstep_step`` spans opened);
    ``spans`` {name: {"calls", "host_ms", "device_ms"}} over its closed
    spans, device ms from start to end event, children included (None
    where no span of the name had events); ``counters`` {name: total};
    ``counters_by_span`` {enclosing span path: {name: total}}; ``records``,
    one per closed span in opening order: name, parent (index in
    ``records`` or None), step, thread, host_ms, device_ms. Waits for the
    card where spans hold events."""
    with _lock:
        spans = [s for s in _stretch.spans if s.t1 is not None]
        counters = dict(_stretch.counters)
        steps = _stretch.steps
    if any(s.events is not None for s in spans):
        torch.cuda.synchronize()
    index = {id(s): i for i, s in enumerate(spans)}
    by_name: dict = {}
    records = []
    for s in spans:
        host = (s.t1 - s.t0) * 1e3
        dev = s.events[0].elapsed_time(s.events[1]) if s.events is not None else None
        e = by_name.setdefault(s.name, {"calls": 0, "host_ms": 0.0, "device_ms": None})
        e["calls"] += 1
        e["host_ms"] += host
        if dev is not None:
            e["device_ms"] = (e["device_ms"] or 0.0) + dev
        records.append({"name": s.name, "parent": index.get(id(s.parent)), "step": s.step,
                        "thread": s.thread, "host_ms": host, "device_ms": dev})
    totals: dict = defaultdict(int)
    by_span: dict = defaultdict(dict)
    for (where, name), n in counters.items():
        totals[name] += n
        by_span[where][name] = n
    return {"steps": steps, "spans": by_name, "counters": dict(totals),
            "counters_by_span": dict(by_span), "records": records}


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block, CPU and (where there is a card) CUDA
    activity, into ``log_dir/trace.json``; yields the profiler. The block's
    spans and counters are a new stretch for ``recorded()``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    _new_stretch()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> dict:
    """{"bytes_in_use", "peak_bytes_in_use"} of the current card's caching
    allocator (tensors allocated now, and at most since the last reset of
    the peak); zeros where there is no card."""
    if not torch.cuda.is_available():
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0}
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
