"""The share of the profiled window in which no kernel, copy or set ran
on the card, in %."""

from harness import readers


def read(out):
    return readers.device_idle_pct(out)
