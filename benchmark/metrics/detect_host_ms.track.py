"""Host ms a call inside ``lsps.detect``: ``RawProgram``'s CoM detection,
launched from the host."""

from harness import spans


def read(out):
    return spans.host_ms_mean(out, "detect")
