"""The layer ranges that a cell declares: each finds the program's function
or method it wraps and opens in the cell's step; a declared range that
finds nothing to wrap, or records no device time, fails the traced run."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_tiny import tiny_cell  # noqa: E402
from benchmark.drivers import offline_lockstep as ol  # noqa: E402
from benchmark.harness import trace  # noqa: E402


def _warm_run(method):
    cell = tiny_cell(method)
    r = ol.Run(cell, 2 ** 31 + 5, "cpu")
    with torch.no_grad():
        r.setup(ol.max_steps(1.0, cell.settings))
        r.warm()
    return r


@pytest.mark.parametrize("method", ["mega", "fgfa"])
def test_declared_ranges_open_in_the_step(method):
    r = _warm_run(method)
    expected = r.s["ranges"]
    with trace.layer_ranges(*trace.declared_ranges(r.model, expected)):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                for _ in range(2):
                    r.one_step()
    opened = {e.name for e in prof.events()}
    assert set(expected) <= opened, sorted(set(expected) - opened)
    # the wrappers are gone again
    assert not hasattr(r.model.backbone.forward, "__wrapped__")


@pytest.mark.parametrize("where", ["function no_such_function", "method no_such_method",
                                   "method backbone.no_such_method",
                                   "method no_such_module.forward"])
def test_a_range_with_nothing_to_wrap_fails(where):
    r = _warm_run("mega")
    with pytest.raises(trace.RangeError):
        with trace.layer_ranges(*trace.declared_ranges(r.model, {"gone": where})):
            pass


def test_a_silent_range_fails():
    summary = {"range_ms_per_step": {"nms": 1.5, "backbone": 0.0}}
    trace.check_ranges(summary, ["nms"])
    with pytest.raises(trace.RangeError):
        trace.check_ranges(summary, ["nms", "backbone"])
    with pytest.raises(trace.RangeError):
        trace.check_ranges(summary, ["warp_by_flow"])
