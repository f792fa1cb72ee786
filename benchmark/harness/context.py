"""One run of one cell: its inputs, what the entry measured, and the
result line.

An entry (``benchmark/entries/<entry>.py``) gets a ``Context`` and
returns an ``Outcome``: the end-to-end metrics, the set-up seconds, the
requests or steps attempted and failed, the peak device memory, the
numbers its correctness check compared with their limits, and for a
traced run the host spans, facts and trace the per-layer readers take.
An entry calls ``open_window`` once set-up has ended and ``close_window``
once its window has closed, outside both: they read the host and the card
for the run's notes.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from harness import host, weights
from harness.manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "lsps_tpu")


@dataclass
class Context:
    torch: object
    manifest: Manifest
    cell: dict                  # the manifest's workload entry
    workload: dict              # benchmark/workloads/<cell>.json
    config: dict                # benchmark/configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float              # perf_counter at process start
    rehearsal: bool = False     # on the CPU at cut sizes, no device metric
    variant: Optional[str] = None   # tests: "control" or a planted fault
    trace_dir: Path = Path("build/bench_trace")
    marks: List[Tuple[str, float]] = field(default_factory=list)
    host_notes: List[str] = field(default_factory=list)
    _opened: dict = field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """The end of a phase of set-up, in seconds since process start."""
        self.marks.append((phase, time.perf_counter() - self.t_start))

    def setup_note(self) -> str:
        return "setup phases (s since start): " + ", ".join(
            f"{p} {t:.2f}" for p, t in self.marks)

    def seed_for(self, tag: str) -> int:
        return weights.seed_for(self.seed, tag)

    @property
    def traffic(self) -> dict:
        t = dict(self.workload["traffic"])
        if self.rehearsal:
            t.update({k: v for k, v in self.workload.get("rehearsal", {})
                      .items() if k != "limits"})
        return t

    @property
    def limits(self) -> dict:
        """The correctness limits; a rehearsal's cut nets may have their
        own (its ``rehearsal.limits``)."""
        lim = dict(self.workload["limits"])
        if self.rehearsal:
            lim.update(self.workload.get("rehearsal", {}).get("limits", {}))
        return lim

    @property
    def hyp(self) -> dict:
        """The trainer's hyperparameters; in a rehearsal the conv widths
        are cut to 4 channels."""
        hyp = json.loads(json.dumps(self.config["hyperparameters"]))
        if self.rehearsal:
            hyp["gen"]["ch"] = hyp["dis"]["ch"] = 4
            hyp["map"]["output_ch"] = 4 * 2 ** (
                hyp["gen"]["n_enc_front_blk"] - 1)
        return hyp

    def span(self, name: str):
        """A ``bench.<name>`` range in a traced run's trace (what the host
        was doing, for the idle gaps); nothing in an untraced run."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(f"bench.{name}")

    def synchronize(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def open_window(self) -> None:
        """Read the card's NUMA node and state and the main thread's CPU
        and switches, just before the window opens."""
        if self.device.type == "cuda":
            self.host_notes.append(host.card_numa(
                host.pci_bus_id(self.torch, self.device)))
        self.host_notes.append(f"card before the window: {self._card()}")
        self._opened = host.thread_state()

    def close_window(self) -> None:
        """The same readings just after the window has closed."""
        self.host_notes.append(f"card after the window: {self._card()}")
        self.host_notes.append(host.window_note(self._opened,
                                                host.thread_state()))

    def _card(self) -> str:
        if self.device.type != "cuda":
            return "none (a CPU rehearsal)"
        return host.card_state(self.device.index or 0)


@dataclass
class Outcome:
    e2e: Dict[str, float]
    setup_s: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Tuple[str, float, float]]
    spans: Dict[str, List[float]] = field(default_factory=dict)
    facts: Dict[str, float] = field(default_factory=dict)
    trace: object = None
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


@contextlib.contextmanager
def tf32_off(torch):
    """The reference's precision: float32 convs and matmuls without TF32;
    the run's own settings come back after it."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that this process must not hold,
    compared whole (``lsps_tpu_torch`` is not ``lsps_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def result_line(ctx: Context, out: Outcome) -> dict:
    torch = ctx.torch
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": ctx.cell.get("chips", 1),
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    metrics, extra = {}, {}
    if ctx.trace:
        if out.trace is not None:
            dev["busy_s"] = out.trace.busy_s
            dev["window_s"] = out.trace.window_s
            extra["breakdown"] = {"device_ops": out.trace.top_ops(),
                                  "idle_gaps": out.trace.idle_gaps()}
        for m in ctx.manifest.per_layer(ctx.cell["name"]):
            value = ctx.manifest.reader(m["name"]).read(out)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        for m in ctx.manifest.end_to_end(ctx.cell["name"]):
            metrics[m["name"]] = {"value": float(quantity(values, m["name"])),
                                  "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev, **extra}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in out.checks}
    return line


def quantity(values: Dict[str, float], metric: str) -> float:
    """The entry's value for an end-to-end metric: ``<quantity>.<group>``
    reads ``<quantity>``, so that cells whose runs spread differently
    report one quantity under metrics with bounds of their own."""
    return values[metric] if metric in values else \
        values[metric.split(".")[0]]


def now() -> float:
    return time.perf_counter()
