"""Run one cell of the LSPS benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The cell is an entry of ``workloads`` in BENCHMARK.json;
its traffic, entry and correctness limits are
``benchmark/workloads/<cell>.json``, its configuration the file the
manifest names.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from a bounded profiled part of
the window.  The last lines on standard error are the numbers the
correctness check compared, each beside its limit; the last line on
standard output is the result, one JSON object.

``--device cpu`` rehearses the cell's control flow on the CPU at cut
widths and sizes and reports no metric.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
# the bytecode of every module this run imports, cached inside the
# checkout: where the installed packages hold none (or the environment
# forbids writing it beside them), every run would compile them again,
# seconds of set-up
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    no library of the run loads JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal at cut sizes, no metric")
    return ap.parse_args(argv)


def build_context(args, variant=None, t_start=None):
    import torch

    from harness.context import Context
    from harness.manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    workload = manifest.workload(args.workload)
    config = manifest.config(cell["config"])
    if args.device == "cuda":
        need = cell.get("chips", 1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise SystemExit(f"error: the cell {args.workload} needs {need} "
                             f"CUDA card(s); "
                             f"{torch.cuda.device_count()} available")
    return Context(torch=torch, manifest=manifest, cell=cell,
                   workload=workload, config=config, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   device=torch.device(args.device),
                   t_start=T_START if t_start is None else t_start,
                   rehearsal=args.device == "cpu", variant=variant,
                   trace_dir=ROOT / "build" / "bench_trace")


def run_cell(ctx):
    """The cell's entry on ``ctx``: its Outcome."""
    return ctx.manifest.entry(ctx.workload["entry"]).run(ctx)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    ctx = build_context(args)
    out = run_cell(ctx)

    from harness.context import forbidden_modules, power_limit, result_line
    from harness.trace import LEAD_IN

    bad = forbidden_modules()
    if bad:
        print(f"error: modules {bad} were loaded in this process",
              file=sys.stderr)
        return 3
    line = result_line(ctx, out)
    if ctx.rehearsal:
        line["metrics"] = {}
        line["rehearsal"] = True
    else:
        print(f"card: {power_limit()}", file=sys.stderr)
    if out.trace is not None:
        print(f"trace: {out.trace.launches} launches in the profiled "
              f"window, {out.trace.unrecorded} without a device record "
              f"(its lead-in of {LEAD_IN} kernels left out)", file=sys.stderr)
    for note in ctx.host_notes + out.notes:
        print(note, file=sys.stderr)
    for name, value, limit in out.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
