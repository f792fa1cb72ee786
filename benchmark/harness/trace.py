"""A bounded profiled window and what its trace holds.

``profile_window`` runs a few units of the cell's work under
``torch.profiler`` (CPU and CUDA activities) inside a ``bench.window``
range that ends in a synchronize, writes the Chrome trace into the
checkout's ``build/bench_trace/`` and reads it back.  A trace with no
device activity, or one that ``complete`` refuses (the profiler on the
card's machine has returned empty traces and traces missing launches),
is taken again on the next units, up to ``tries`` times; after that the
run fails rather than read its per-layer metrics from a partial trace.

The profiler on the card's machine drops the first device records of a
trace, more of them as the process ages (none at 12 s, up to 8 launches
after two minutes).  So each trace opens with ``LEAD_IN`` spin kernels,
synchronized before the window's range opens; ``Trace`` leaves them out
of every interval, count and reader, and counts the window's launches
that still lack a device record (``unrecorded``).

``Trace`` holds the window's device intervals (kernels, copies, sets),
the host ranges the harness opened (``bench.*``), the main thread's
top-level operators and each kernel's launch time on the host, which
attributes kernels to the ranges that launched them.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
LEAD_IN = 64
LEAD_IN_KERNEL = "spin_kernel"       # torch.cuda._sleep's kernel
# host calls that put work on the device, each owed a device record
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")


class Trace:
    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace holds no bench.window range")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.window_s = (self.t1 - self.t0) * 1e-6
        main_tid = win[0].get("tid")
        self.device: List[Tuple[str, str, float, float, dict]] = []
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.ops: List[Tuple[str, float, float]] = []
        self.launch_ts: Dict[int, float] = {}
        launched, recorded = [], set()
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat"), float(e.get("ts", 0.0))
            end = ts + float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                if LEAD_IN_KERNEL in e["name"]:
                    continue
                recorded.add(e.get("args", {}).get("correlation"))
                if end > self.t0 and ts < self.t1:
                    self.device.append((cat, e["name"], max(ts, self.t0),
                                        min(end, self.t1),
                                        e.get("args", {})))
            elif cat == "user_annotation" and e["name"] != WINDOW:
                self.ranges[e["name"]].append((ts, end))
            elif cat == "cpu_op" and e.get("tid") == main_tid:
                self.ops.append((e["name"], ts, end))
            elif cat == "cuda_runtime":
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch_ts[corr] = ts
                    if self.t0 <= ts <= self.t1 and any(
                            w in e["name"] for w in LAUNCH_WORDS):
                        launched.append(corr)
        self.device.sort(key=lambda d: d[2])
        self.launches = len(launched)
        self.unrecorded = sum(c not in recorded for c in launched)

    @classmethod
    def load(cls, path: Path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # -- device ----------------------------------------------------------
    def kernels(self, symbol: Optional[str] = None):
        """(name, start, end, args) of the kernels whose names hold
        ``symbol`` (all with None); times in microseconds."""
        return [(n, s, e, a) for c, n, s, e, a in self.device
                if c == "kernel" and (symbol is None or symbol in n)]

    def copies(self, kind: str):
        """Memcpy intervals whose names hold ``kind`` (``HtoD``...)."""
        return [(n, s, e) for c, n, s, e, _ in self.device
                if c == "gpu_memcpy" and kind in n]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, _, s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def launched_in(self, range_name: str):
        """The kernels launched on the host inside a ``range_name``
        range."""
        spans = sorted(self.ranges.get(range_name, []))
        out = []
        for _, n, s, e, a in self.device:
            ts = self.launch_ts.get(a.get("correlation"))
            if ts is not None and any(lo <= ts <= hi for lo, hi in spans):
                out.append((n, s, e, a))
        return out

    # -- breakdown -------------------------------------------------------
    def top_ops(self, k: int = 10):
        by: Dict[str, float] = defaultdict(float)
        for _, n, s, e, _ in self.device:
            by[short(n)] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda x: -x[1])[:k]

    def host_at(self, ts: float) -> str:
        """What the host was doing at ``ts``: the innermost harness range
        and the outermost operator of the main thread."""
        rng = [(hi - lo, n) for n, spans in self.ranges.items()
               for lo, hi in spans if lo <= ts < hi]
        ops = [(lo, n) for n, lo, hi in self.ops if lo <= ts < hi]
        label = min(rng)[1] if rng else "outside harness ranges"
        return f"{label} / {min(ops)[1]}" if ops else label

    def idle_gaps(self, k: int = 10):
        gaps, at = [], self.t0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            gaps.append((at, self.t1))
        by: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            by[self.host_at(s)] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda x: -x[1])[:k]


def short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def profile_window(torch, run_units: Callable[[int], None], units: int,
                   path: Path, tries: int = 3,
                   complete: Callable[[Trace], bool] = lambda t: True
                   ) -> Trace:
    """The trace of ``run_units(units)``.  Raises where none of ``tries`` windows
    gave a trace with device activity that ``complete`` accepts."""
    from torch.profiler import ProfilerActivity, profile, record_function

    path.parent.mkdir(parents=True, exist_ok=True)
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            with record_function(WINDOW):
                run_units(units)
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        trace = Trace.load(path)
        if trace.device and complete(trace):
            return trace
        print(f"profiler: a short trace (attempt {attempt + 1} of {tries})",
              file=sys.stderr, flush=True)
    raise RuntimeError(f"no complete trace in {tries} profiled windows")
