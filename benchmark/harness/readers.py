"""What the per-layer readers (``benchmark/metrics/<metric>.py``) share.

Each reader takes the run's ``Outcome`` and returns a number, or None
where the run holds nothing to read (no trace, no such kernel).  A share
of a roofline or of a peak is never reported as 0 for lack of data.
"""

from __future__ import annotations

import math
import statistics

from harness import yardstick


def _ok(x):
    return x if x is not None and math.isfinite(x) else None


def device_idle_pct(out):
    t = out.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(out):
    """The matmul and conv FLOPs of one unit (step or call) over its time
    on the host clock (``unit_s``) and the TF32 dense peak."""
    f, s = out.facts.get("flops_per_unit"), out.facts.get("unit_s")
    if not f or not s or out.trace is None:
        return None
    return _ok(100.0 * f / s / yardstick.TF32_FLOPS_PER_S)


def launched_ms_per_unit(out, range_name):
    t = out.trace
    if t is None or not t.ranges.get(range_name):
        return None
    ks = t.launched_in(range_name)
    if not ks:
        return None
    return sum(e - s for _, s, e, _ in ks) * 1e-3 / len(t.ranges[range_name])


def crop_roofline_pct(out):
    t, b = out.trace, out.facts.get("crop_bound_s")
    if t is None or not b:
        return None
    ks = t.kernels(yardstick.CROP_SYMBOL)
    if not ks:
        return None
    mean_s = sum(e - s for _, s, e, _ in ks) * 1e-6 / len(ks)
    return _ok(100.0 * b / mean_s)


def h2d_ms_per_unit(out):
    t, n = out.trace, out.facts.get("profiled_units")
    if t is None or not n:
        return None
    cs = t.copies("HtoD")
    if not cs:
        return None
    return sum(e - s for _, s, e in cs) * 1e-3 / n


def norm_roofline_pct(out):
    """The norm kernels' bound over their device time, summed over every
    launch in the trace; each launch's planes from its grid, its plane
    size the generator's latent map."""
    t, hw = out.trace, out.facts.get("latent_hw")
    if t is None or not hw:
        return None
    bound, spent = 0.0, 0.0
    for name, s, e, args in t.kernels():
        fn = next((f for sym, f in yardstick.NORM_SYMBOLS.items()
                   if sym in name), None)
        if fn is None:
            continue
        planes = args.get("grid", [0])[0]
        esize = 2 if "bfloat16" in name else 4
        bound += yardstick.bound_s(
            yardstick.norm_bytes(fn, planes, hw, esize),
            yardstick.NORM_FLOPS_PER_VALUE[fn] * planes * hw)
        spent += (e - s) * 1e-6
    return _ok(100.0 * bound / spent) if spent else None


def mean_ms(out, span):
    v = out.spans.get(span)
    return statistics.fmean(v) * 1e3 if v else None


def median_ms(out, span):
    v = out.spans.get(span)
    return statistics.median(v) * 1e3 if v else None
