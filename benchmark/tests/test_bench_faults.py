"""Each cell's run with the timed path broken underneath comes out not
correct; the same run unbroken comes out correct.  On the CPU, at the
rehearsal's cut sizes, skipping the look for a card."""

import pytest

from bench_runs import readings, run_cell

SEED = 2 ** 31 + 101
FAULTS = [("nnyu.pretrain-b32", "augment"),
          ("nnyu.pretrain-b32", "unchanged"),
          ("nnyu.pretrain-b32", "half_batch"),
          ("nicvl.label-b256", "answer"),
          ("nnyu.label-raw-b256", "answer")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    out = run_cell(cell, SEED, 1.0, variant=fault)
    assert not out.correct, readings(out)


@pytest.mark.parametrize("cell", sorted({c for c, _ in FAULTS}))
def test_the_unbroken_run_is_correct(cell):
    out = run_cell(cell, SEED, 1.0)
    assert out.correct, readings(out)
    assert out.attempted > 0 and out.failed == 0
