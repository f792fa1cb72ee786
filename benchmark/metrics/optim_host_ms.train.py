"""Host ms a step inside ``lsps.optim`` (both updates' gradient casts and
Adam steps): the time the host takes to launch the optimizer."""

from harness import spans


def read(out):
    return spans.host_ms_per_unit(out, "optim")
