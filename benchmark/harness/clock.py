"""The open-loop stream's clock: wake at a frame's due time, not after it.

Every frame's latency runs from its due time, so whatever the caller's
own wait overruns lands in the metric.  On the H100 machines the
benchmark runs on, a ``time.sleep`` of ~29 ms overran by 0.35 ms at the
median and by up to ~5 ms; a sleep that stopped 1 ms or 5 ms short of
the due time and spun for the rest still woke up to 12 ms late in some
track runs, the thread waiting to be scheduled again after its sleep.  A
caller that spins through the whole wait woke within 0.2 ms of every due
time in most runs and within 0.9 ms in all.  So ``wait_until`` never
gives up the CPU: the wait of a 30 fps stream is at most one period, on
a core that the run does not otherwise need.
"""

from __future__ import annotations

from typing import Callable


def wait_until(due: float, now: Callable[[], float]) -> float:
    """Return at ``due`` or later, the clock's reading then, spinning on
    ``now`` without sleeping."""
    t = now()
    while t < due:
        t = now()
    return t
