"""What the readers of the system's own spans and counters share.

The system opens ``lsps.<name>`` ranges (``lsps_tpu_torch/utils/
logging.py``) while a profiler records, so a traced run's trace holds them
on the clock of its kernels and copies.  The readers here take a span's
host duration, or the device time and kernel count of the work launched
inside it (``Trace.launched_in``: by the launch's time on the host, from
any thread), per call or per profiled unit; and the ``DataLoader``'s
process totals (``batches``, ``stalls``, ``busy_s``), read from the
loaded module.

Each returns None where the run holds nothing to read: no trace, no such
span (a system without it), no loader counters.
"""

from __future__ import annotations

import statistics
import sys

PREFIX = "lsps."
LOADER_MODULE = "lsps_tpu_torch.data.loader"


def _spans(out, name):
    t = out.trace
    if t is None:
        return None
    return t.ranges.get(PREFIX + name) or None


def _units(out):
    n = out.facts.get("profiled_units")
    return n if n else None


def device_ms_per_unit(out, name):
    """Device ms a profiled unit of the kernels, copies and sets launched
    inside ``lsps.<name>``."""
    spans, n = _spans(out, name), _units(out)
    if spans is None or n is None:
        return None
    work = out.trace.launched_in(PREFIX + name)
    return sum(e - s for _, s, e, _ in work) * 1e-3 / n


def kernels_per_unit(out, name):
    """Kernels a profiled unit launched inside ``lsps.<name>``."""
    spans, n = _spans(out, name), _units(out)
    if spans is None or n is None:
        return None
    kernels = {id(a) for _, _, _, a in out.trace.kernels()}
    work = out.trace.launched_in(PREFIX + name)
    return sum(id(a) in kernels for _, _, _, a in work) / n


def host_ms_per_unit(out, name):
    """The summed durations of ``lsps.<name>`` a profiled unit, in ms."""
    spans, n = _spans(out, name), _units(out)
    if spans is None or n is None:
        return None
    return sum(hi - lo for lo, hi in spans) * 1e-3 / n


def host_ms_mean(out, name):
    """The mean duration of a ``lsps.<name>`` span, in ms."""
    spans = _spans(out, name)
    if spans is None:
        return None
    return statistics.fmean(hi - lo for lo, hi in spans) * 1e-3


def loader_counts(out):
    """(batches, stalls, busy seconds) of every ``DataLoader`` of the
    process over the run, or None."""
    mod = sys.modules.get(LOADER_MODULE)
    cls = getattr(mod, "DataLoader", None)
    if out.trace is None or cls is None:
        return None
    counts = tuple(getattr(cls, k, None) for k in
                   ("batches", "stalls", "busy_s"))
    if None in counts or not counts[0]:
        return None
    return counts
