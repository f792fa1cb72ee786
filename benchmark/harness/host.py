"""What the host and the card were doing around a run's window.

Readings only: they go into the run's notes on standard error, to explain
a spread, and are never judged.  Nothing here writes under ``/sys`` or
``/proc`` or changes how the process is scheduled.

* ``card_numa``: the card's NUMA node and that node's CPUs, from sysfs.
* ``card_state``: the card's SM and memory clocks, power draw,
  temperature and active clock-event (throttle) reasons, from
  ``nvidia-smi``; read before the window opens and after it closes.
* ``thread_state``: the CPUs the process may run on and last ran on, and
  the main thread's context switches, from ``/proc``.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

SYSFS = Path("/sys")
PROC = Path("/proc")
CARD_QUERY = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
              "clocks_throttle_reasons.active")


def cpulist(cpus) -> str:
    """``{0, 1, 2, 5}`` as ``0-2,5``."""
    out, run = [], []
    for c in sorted(cpus):
        if run and c == run[-1] + 1:
            run.append(c)
            continue
        if run:
            out.append(_span(run))
        run = [c]
    if run:
        out.append(_span(run))
    return ",".join(out)


def _span(run) -> str:
    return str(run[0]) if len(run) == 1 else f"{run[0]}-{run[-1]}"


def card_numa(bus_id: str, sysfs: Path = SYSFS) -> str:
    """The NUMA node of the PCI device ``bus_id`` (``0000:bb:00.0``) and
    the node's CPUs, or why they cannot be read."""
    dev = sysfs / "bus" / "pci" / "devices" / bus_id
    try:
        node = int((dev / "numa_node").read_text())
    except (OSError, ValueError) as e:
        return f"card {bus_id}: NUMA node unknown ({type(e).__name__}: " \
               f"{dev / 'numa_node'})"
    nodes = sorted((sysfs / "devices" / "system" / "node").glob(
        "node[0-9]*"))
    if node < 0:
        return f"card {bus_id}: no NUMA node (numa_node {node}); " \
               f"{len(nodes)} node(s) on the host"
    try:
        cpus = (sysfs / "devices" / "system" / "node" / f"node{node}" /
                "cpulist").read_text().strip()
    except OSError:
        cpus = "unknown"
    return f"card {bus_id}: NUMA node {node} of {len(nodes)}, its CPUs {cpus}"


def pci_bus_id(torch, device) -> str:
    p = torch.cuda.get_device_properties(device)
    return f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"


def card_state(index: int = 0, run=subprocess.run) -> str:
    """One reading of the card's clocks, power, temperature and active
    clock-event reasons, ``name value`` pairs, or why there is none."""
    try:
        out = run(["nvidia-smi", f"--query-gpu={','.join(CARD_QUERY)}",
                   "--format=csv,noheader", "-i", str(index)],
                  capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({type(e).__name__})"
    values = out.stdout.strip().split(", ")
    if out.returncode != 0 or len(values) != len(CARD_QUERY):
        return f"unread (nvidia-smi rc {out.returncode}: " \
               f"{(out.stdout or out.stderr).strip()[:120]})"
    return ", ".join(f"{k} {v}" for k, v in zip(CARD_QUERY, values))


def thread_state(proc: Path = PROC) -> Dict[str, object]:
    """The main thread's last CPU and context switches, the last CPU of
    every thread of the process, and the CPUs it may run on."""
    st: Dict[str, object] = {"allowed": cpulist(os.sched_getaffinity(0))}
    me = proc / "thread-self"
    st["cpu"] = _last_cpu(me / "stat")
    try:
        for line in (me / "status").read_text().splitlines():
            key, _, value = line.partition(":")
            if key in ("voluntary_ctxt_switches",
                       "nonvoluntary_ctxt_switches"):
                st[key.split("_")[0]] = int(value)
    except (OSError, ValueError):
        pass
    cpus = {_last_cpu(t / "stat") for t in (proc / "self" / "task").glob("*")}
    st["threads_on"] = cpulist(c for c in cpus if c is not None)
    return st


def _last_cpu(stat: Path) -> Optional[int]:
    """Field 39 of ``/proc/.../stat``: the CPU the thread last ran on."""
    try:
        return int(stat.read_text().rpartition(")")[2].split()[36])
    except (OSError, ValueError, IndexError):
        return None


def window_note(before: Dict[str, object], after: Dict[str, object]) -> str:
    """The host over the window, from ``thread_state`` before and after."""
    switches = ", ".join(
        f"{after[k] - before[k]} {k}" for k in ("voluntary",
                                                "nonvoluntary")
        if k in before and k in after) or "switches unread"
    return (f"host over the window: CPUs allowed {after['allowed']}; main "
            f"thread on CPU {before['cpu']} at the open, {after['cpu']} at "
            f"the close; {switches} context switches of the main thread; "
            f"threads last on CPUs {after['threads_on'] or 'unread'}")
