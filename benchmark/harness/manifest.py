"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration is ``benchmark/configs/<config>.json`` (through
the manifest's ``file``); the cell's traffic parameters, its entry and
the limits of its correctness check are ``benchmark/workloads/<cell>.json``;
each per-layer metric is read by ``benchmark/metrics/<metric>.py``; each
entry is ``benchmark/entries/<entry>.py``.  Adding a cell, configuration,
entry or metric adds files and manifest entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_module(path: Path, name: str):
    """A module from a file, under ``name`` (file names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    # -- lookups ---------------------------------------------------------
    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.root / self.config_entry(name)["file"])
                          .read_text())

    def workload(self, name: str) -> dict:
        return json.loads((self.bench_dir / "workloads" / f"{name}.json")
                          .read_text())

    def entry(self, name: str):
        return load_module(self.bench_dir / "entries" / f"{name}.py",
                           f"bench_entry_{name}")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_"))

    # -- checks ----------------------------------------------------------
    def problems(self) -> List[str]:
        """What in the manifest and its files breaks the contract's
        names, units, links and files (empty when sound)."""
        out: List[str] = []
        d = self.data
        names = ([c["name"] for c in d["configs"]]
                 + [w["name"] for w in d["workloads"]]
                 + [m["name"] for m in d["end_to_end"] + d["per_layer"]])
        for n in names + [w["config"] for w in d["workloads"]] \
                + [w["traffic"] for w in d["workloads"]]:
            if not NAME.match(n):
                out.append(f"bad name {n!r}")
        for m in d["end_to_end"] + d["per_layer"]:
            if not UNIT.match(m["unit"]):
                out.append(f"bad unit {m['unit']!r} of {m['name']}")
        for kind in ("configs", "workloads"):
            seen = [x["name"] for x in d[kind]]
            if len(seen) != len(set(seen)):
                out.append(f"duplicate {kind} names")
        cells = {w["name"]: w for w in d["workloads"]}
        e2e = {m["name"]: m for m in d["end_to_end"]}
        for w in d["workloads"]:
            if not (self.bench_dir / "workloads" / f"{w['name']}.json") \
                    .exists():
                out.append(f"no workload file for {w['name']}")
                continue
            entry = self.workload(w["name"])["entry"]
            if not (self.bench_dir / "entries" / f"{entry}.py").exists():
                out.append(f"no entry {entry} for {w['name']}")
            self.config_entry(w["config"])
        for c in d["configs"]:
            if not (self.root / c["file"]).exists():
                out.append(f"no config file {c['file']}")
        for m in d["per_layer"]:
            if not (self.bench_dir / "metrics" / f"{m['name']}.py").exists():
                out.append(f"no reader for {m['name']}")
            moves = e2e.get(m["moves"])
            if moves is None:
                out.append(f"{m['name']} moves unknown {m['moves']}")
                continue
            for cell in m.get("workloads", list(cells)):
                if cell not in cells:
                    out.append(f"{m['name']}: unknown cell {cell}")
                elif cell not in moves.get("workloads", list(cells)):
                    out.append(f"{m['name']}: {cell} does not report "
                               f"{m['moves']}")
        return out
