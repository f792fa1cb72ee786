"""Host ms a call inside ``lsps.h2d``: the estimator's frames to its
device, as long as the copy holds the host."""

from harness import spans


def read(out):
    return spans.host_ms_mean(out, "h2d")
