"""A run with the timed path broken underneath comes out not correct: the
harness is driven on the CPU at a tiny size (its look for a card skipped)
with each fault a lockstep cell can have planted in the port's step."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_tiny import tiny_cell  # noqa: E402
from benchmark.drivers import offline_lockstep as ol  # noqa: E402


def _port_step(run):
    from mega_pytorch_tpu_torch.engine.batched_inference import (
        make_lockstep_step, make_lockstep_step_windowed)
    return (make_lockstep_step if run.mega else make_lockstep_step_windowed)(run.model)


def state_unchanged(run, model):
    """The step hands back the carries it was given."""
    step = _port_step(run)

    def broken(carries, *args):
        return carries, step(carries, *args)[1]
    return broken


def half_the_lanes(run, model):
    """The second half of the lanes is left out: it gets the first half's detections."""
    step = _port_step(run)

    def broken(*args):
        carries, dets = step(*args)
        half = dets.boxes.shape[0] // 2
        return carries, type(dets)(*(torch.cat([x[:half], x[:dets.boxes.shape[0] - half]])
                                      for x in dets))
    return broken


def half_the_lanes_invalid(run, model):
    """The second half of the lanes returns no valid detection."""
    step = _port_step(run)

    def broken(*args):
        carries, dets = step(*args)
        valid = dets.valid.clone()
        valid[dets.valid.shape[0] // 2:] = False
        return carries, dets._replace(valid=valid)
    return broken


def cut_to_top_10(run, model):
    """Each frame keeps only its ten best detections."""
    step = _port_step(run)

    def broken(*args):
        carries, dets = step(*args)
        valid = dets.valid.clone()
        valid[:, 10:] = False  # detections come sorted by score
        return carries, dets._replace(valid=valid)
    return broken


def answer_altered(run, model):
    """Every detection's label is moved to the next class where it is produced."""
    step = _port_step(run)

    def broken(*args):
        carries, dets = step(*args)
        classes = run.c["num_classes"] - 1
        return carries, dets._replace(labels=dets.labels % classes + 1)
    return broken


FAULTS = {"state_unchanged": state_unchanged, "half_the_lanes": half_the_lanes,
          "half_the_lanes_invalid": half_the_lanes_invalid, "cut_to_top_10": cut_to_top_10,
          "answer_altered": answer_altered}


def _run(method, fault=None):
    make = FAULTS[fault] if fault else (lambda run, model: _port_step(run))
    return ol.run(tiny_cell(method), 2 ** 31 + 3, 1.0, False, time.time(), device="cpu",
                  make_step=make)


@pytest.mark.parametrize("method", ["mega", "fgfa"])
def test_sound_run_is_correct(method):
    result, checks = _run(method)
    assert result["correct"], checks


@pytest.mark.parametrize("method", ["mega", "fgfa"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(method, fault):
    result, checks = _run(method, fault)
    assert not result["correct"], checks
