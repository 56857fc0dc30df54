"""The RDN cell's driver (``drivers/offline_rdn.py``) on the CPU at a tiny
size: a whole run is correct, the float8 control is not, and each fault
that RDN's relation stages can have, planted in the port's step, comes out
not correct."""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_tiny_rdn import tiny_rdn_cell  # noqa: E402
from benchmark.drivers import offline_rdn as od  # noqa: E402

SEED = 2 ** 31 + 3


def _port_step(model):
    from mega_pytorch_tpu_torch.engine.batched_inference import make_lockstep_step_windowed

    return make_lockstep_step_windowed(model)


def advanced_stage_skipped(run, model):
    """No distillation and no advanced stage: the last attention runs over
    all the window's refs."""
    ext = model.extractor

    def stages(x, x_refs, cur_rois, ref_rois, ref_valid, skip_first_fc=False, precise=False):
        for i in range(ext.base_stage):
            if not (skip_first_fc and i == 0):
                x = ext._fc(i, x)
            x = x + ext.attn(i)(x, x_refs, ref_valid, pos_rois=(cur_rois, ref_rois))
        last = ext.attn(ext.base_stage + ext.advanced_stage)
        return x + last(x, x_refs, ref_valid, pos_rois=(cur_rois, ref_rois))

    ext._stages = stages
    return _port_step(model)


def distilled_from_the_last(run, model):
    """The distillation takes each frame's last refs, not its first."""
    from mega_pytorch_tpu_torch.models.roi_heads import vid_extractors

    def last(arr, frames, base_num, advanced_num):
        blocks = arr.reshape(arr.shape[0], frames, base_num, *arr.shape[2:])
        return blocks[:, :, -advanced_num:].reshape(arr.shape[0], frames * advanced_num,
                                                     *arr.shape[2:])

    step = _port_step(model)

    def broken(*args):
        with mock.patch.object(vid_extractors, "distill", last):
            return step(*args)
    return broken


def key_slot_off_by_one(run, model):
    """Detection at the slot after the key's: the frame one newer."""
    model.v = dataclasses.replace(model.v, key_frame_location=model.v.key_frame_location + 1)
    return _port_step(model)


FAULTS = {f.__name__: f for f in (advanced_stage_skipped, distilled_from_the_last,
                                  key_slot_off_by_one)}


def _run(fault=None):
    make = FAULTS[fault] if fault else (lambda run, model: _port_step(model))
    return od.run(tiny_rdn_cell(), SEED, 1.0, False, time.time(), device="cpu", make_step=make)


def test_sound_run_is_correct():
    result, checks = _run()
    assert result["correct"], checks
    assert set(result["metrics"]) == {"frames_per_s", "step_ms_p95", "setup_s"}


def test_control_is_not_correct():
    cell = tiny_rdn_cell()
    r = od.Run(cell, SEED, "cpu")
    with torch.no_grad():
        r.setup(od.max_steps(2.0, cell.settings))
        r.warm()
    w = r.window(1.0)
    with torch.no_grad():
        while not r.sample(w["first"]):
            r.one_step()
    r.release()
    numbers = r.compare(r.sample(w["first"]), control=True)
    assert od.compare.judge(numbers["program"], cell.settings["limits"])[0], numbers
    assert not od.compare.judge(numbers["control"], cell.settings["limits"])[0], numbers


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    result, checks = _run(fault)
    assert not result["correct"], checks
