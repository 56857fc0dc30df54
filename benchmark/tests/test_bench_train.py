"""The training cell's driver on the CPU at a tiny size: four gloo ranks
through the port's DDP wrapper and ``train_step`` against the plain
reference's iterations over all four samples; each fault a data-parallel
training step can have, planted in the program, comes out not correct."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_tiny import tiny_train_cell  # noqa: E402
from benchmark.drivers import train_ddp  # noqa: E402


def state_unchanged(w):
    """The optimizer's step leaves the parameters as they were."""
    w.optimizer.step = lambda *args, **kwargs: None


def half_the_batch(w):
    """The last half of the ranks' samples is left out, the mean taken over the rest."""
    forward = w.wrapped.forward
    scale = 2.0 if w.rank < w.world // 2 else 0.0
    w.wrapped.forward = lambda *a, **k: {n: v * scale for n, v in forward(*a, **k).items()}


def no_exchange(w):
    """The gradients are not exchanged between the ranks."""
    w.wrapped = w.model


def answer_altered(w):
    """Rank 0's ground-truth labels are moved to the next class where they are fed."""
    if w.rank == 0:
        for sample in w.pool:
            gt = sample["gt"]
            gt["labels"] = gt["labels"] % 30 + gt["valid"]


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_batch, no_exchange,
                                  answer_altered)}
# the tiny run's program reads about 1e-5 (losses) and 1e-4 (median leaves)
# from the reference in float32; the faults read 2e-3 and more
LIMITS = {"loss_gap": 5e-4, "grad_gap_median": 1e-2, "change_gap_median": 1e-2}


def _run(fault=None):
    cell = tiny_train_cell(limits=LIMITS)
    return train_ddp.run(cell, 2 ** 31 + 21, 0.5, False, time.time(), device="cpu",
                         fault=FAULTS[fault] if fault else None)


def test_sound_run_is_correct():
    result, checks = _run()
    assert result["correct"], checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    result, checks = _run(fault)
    assert not result["correct"], checks
