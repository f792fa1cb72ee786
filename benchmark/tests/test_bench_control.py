"""On the card, at each cell's own size: the readings that its limits
are set from.

* the program on a dozen seeds (its lower readings; each run correct);
* the control, the system's own bfloat16 path (``compute_dtype:
  bfloat16`` for training, a bfloat16 trunk for serving), on three seeds:
  each run not correct;
* for training, the faults of a step that sees half its batch and of an
  augmented image altered where it is made, on three seeds: each run not
  correct.

    python -m pytest benchmark/tests/test_bench_control.py -m chip -s

prints one JSON line of readings per run.
"""

import json

import pytest

from bench_runs import readings, run_cell

CELLS = {"nnyu.pretrain-b32": 2.0, "nicvl.label-b256": 3.0,
         "nnyu.label-raw-b256": 3.0}
PROGRAM_SEEDS = [2 ** 31 + 1000 + 7 * i for i in range(12)]
CONTROL_SEEDS = [2 ** 31 + 5000 + 7 * i for i in range(3)]


def report(cell, variant, seed, out):
    print(json.dumps({"cell": cell, "variant": variant or "program",
                      "seed": seed, "correct": out.correct,
                      "readings": readings(out)}), flush=True)


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_readings(card, cell):
    results = []
    for seed in PROGRAM_SEEDS:
        out = run_cell(cell, seed, CELLS[cell], device="cuda")
        report(cell, None, seed, out)
        results.append(out.correct)
    assert all(results)


@pytest.mark.chip
@pytest.mark.parametrize("cell,variant", [
    *((c, "control") for c in sorted(CELLS)),
    ("nnyu.pretrain-b32", "half_batch"), ("nnyu.pretrain-b32", "augment")])
def test_control_and_faults_are_not_correct(card, cell, variant):
    results = []
    for seed in CONTROL_SEEDS:
        out = run_cell(cell, seed, CELLS[cell], device="cuda",
                       variant=variant)
        report(cell, variant, seed, out)
        results.append(out.correct)
    assert not any(results)
