"""``correct`` has to come out false for the control and for every fault
a training cell can have on one card, with the cell's own limits, at a
size the CPU runs (the readings the limits were set from are the
card's, at the cells' own sizes: ``control.py``, PERF.md)."""

from __future__ import annotations

import time

import pytest
from conftest import tiny_cell

from potbench import bench, faults

SEED = 2 ** 31 + 23


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(cell_name, fault, monkeypatch):
    from repro_torch import train
    make = train.make_train_step
    monkeypatch.setattr(train, "make_train_step", lambda *a, **k:
                        faults.FAULTS[fault](make(*a, **k)))
    result = bench.run(tiny_cell(cell_name), seed=SEED, seconds=0.2,
                       trace_on=False, device="cpu", t0=time.time())
    assert result["correct"] is False


def test_the_control_is_not_correct(cell_name):
    """The reference with float8 e4m3 products in the program's place
    (the nearest precision below the configuration's bf16)."""
    cell = tiny_cell(cell_name)
    ref = bench.reference(cell, SEED, "cpu")
    control = bench.gaps(bench.reference(cell, SEED, "cpu",
                                         "float8_e4m3fn"), ref)
    _, within = bench.verdict(control, cell.limits)
    assert not within
    # the numbers the control fails read lower for the program itself
    prog = bench.build(cell, SEED, "cpu")
    sound = bench.gaps(bench.first_steps(prog, cell.traffic), ref)
    failed = [k for k, limit in cell.limits.items() if control[k] > limit]
    assert all(sound[k] < control[k] for k in failed)
