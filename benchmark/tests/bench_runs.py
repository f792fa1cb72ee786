"""Run a cell in this process, as ``benchmark/run.py`` does, with a
variant planted under the timed path: ``control`` (the system's bfloat16
path) or a fault."""

import argparse
import time
from pathlib import Path

from harness.manifest import load_module

BENCH_DIR = Path(__file__).resolve().parents[1]
RUN = load_module(BENCH_DIR / "run.py", "bench_run_script")


def run_cell(cell, seed, seconds, device="cpu", variant=None, trace=False):
    """The cell's Outcome."""
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=int(trace), device=device)
    RUN.cache_env(RUN.ROOT)
    ctx = RUN.build_context(args, variant=variant,
                            t_start=time.perf_counter())
    return RUN.run_cell(ctx)


def readings(out):
    return {name: value for name, value, _ in out.checks}
